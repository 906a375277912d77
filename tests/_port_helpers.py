"""Shared fixtures for the port's parity tests: the JAX package's weights
and delta models as numpy dicts keyed by flat dot-path, which is what
``repro_torch.bridge`` takes.  Inputs are made from a seed with numpy."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config
from repro.core import calibration as JC
from repro.models import build_model
from repro.models.param import split

import repro_torch.configs as TC


def configs(num_layers: int = 2, compute_dtype: str = "float32",
            arch: str = "qwen3-8b", **fields):
    """(JAX config, port config) of reduced ``arch``, identical fields;
    ``fields`` override more of them."""
    kw = dict(num_layers=num_layers, compute_dtype=compute_dtype,
              remat=False, **fields)
    jcfg = dataclasses.replace(get_config(arch).reduced(), **kw)
    tcfg = dataclasses.replace(TC.get_config(arch).reduced(), **kw)
    return jcfg, tcfg


def jax_base(jcfg):
    """(JAX model, JAX params, {path: np.ndarray}) from PRNGKey(0)."""
    model = build_model(jcfg)
    params, _ = split(model.init(jax.random.PRNGKey(0)))
    return model, params, numpy_flat(params)


def numpy_flat(params) -> dict:
    """{path: np.ndarray}; a quantized leaf (JAX QuantWeight) crosses as
    ``{"q", "scale"}``, the bridge's exchange form."""
    def leaf(v):
        if getattr(v, "__quant_leaf__", False):
            return {"q": np.asarray(v.q), "scale": np.asarray(v.scale)}
        return np.asarray(v)
    return {k: leaf(v) for k, v in JC.flatten_params(params).items()}


def fine_tune_flat(flat: dict, seed: int, scale: float = 0.005) -> dict:
    """numpy-seeded synthetic fine-tune: noise on every matrix."""
    rng = np.random.default_rng(seed)
    return {k: (v + scale * rng.standard_normal(v.shape).astype(v.dtype)
                if v.ndim >= 2 else v) for k, v in flat.items()}


def jax_tree(params_like, flat: dict):
    return JC.unflatten_like(params_like, {k: jnp.asarray(v)
                                           for k, v in flat.items()})


def delta_model_numpy(dm) -> dict:
    """A JAX DeltaModel in the bridge's exchange format."""
    return {"deltas": {p: {"packed": np.asarray(e.packed),
                           "v_row": np.asarray(e.v_row),
                           "v_col": np.asarray(e.v_col),
                           "use_row": np.asarray(e.use_row),
                           "scalar": e.scalar}
                       for p, e in dm.deltas.items()},
            "extras": {p: np.asarray(v) for p, v in dm.extras.items()}}


# ---------------------------------------------------------------------------
# training under a mesh: the JAX single-device reference and its bar
# ---------------------------------------------------------------------------

from _mesh_ranks import (TRAIN_BATCH, TRAIN_LR, TRAIN_SEQ,  # noqa
                         TRAIN_STEPS, with_frontend)


def train_data(arch: str, **fields) -> dict:
    """Reduced ``arch``, fp32, at 2 layers unless ``fields`` say: the JAX
    model, and what the port's ranks read (JAX's initial params as numpy,
    the batches, with the family's frontend inputs drawn with numpy from
    seed 0)."""
    from repro.data.pipeline import SyntheticLM
    jcfg, _ = configs(arch=arch, **{"num_layers": 2, **fields})
    jmodel, _, flat = jax_base(jcfg)
    src = SyntheticLM(jcfg.vocab_size, seed=0)
    batches = with_frontend([{k: np.asarray(v) for k, v in src.lm_batch(
        i, TRAIN_BATCH, TRAIN_SEQ).items()} for i in range(TRAIN_STEPS)],
        jcfg)
    return {"jmodel": jmodel, "ship": {"flat": flat, "batches": batches}}


def jax_train_reference(jmodel, batches) -> dict:
    """JAX's single-device ``make_train_step`` from its initial params over
    ``batches``: each step's metrics, the step-1 gradients and the final
    params (numpy)."""
    from repro.train import step as JS
    state = JS.init_train_state(jmodel, jax.random.PRNGKey(0))
    # jitted: eager JAX takes the recurrent families' backward op by op
    (_, _), grads = jax.jit(jax.value_and_grad(
        JS.make_loss_fn(jmodel), has_aux=True))(state.params, batches[0])
    step = jax.jit(JS.make_train_step(jmodel, **TRAIN_LR))
    metrics = []
    for batch in batches:
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "grads": numpy_flat(grads),
            "params": numpy_flat(state.params)}

