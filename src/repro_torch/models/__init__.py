from repro_torch.models.model_zoo import Model, build_model  # noqa: F401
