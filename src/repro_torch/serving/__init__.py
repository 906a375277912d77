from repro_torch.serving.api import Deployment  # noqa: F401
