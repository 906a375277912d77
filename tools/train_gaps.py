"""Dev tool: how far the port's fp32 train step parts from JAX's
single-device step on the CPU, per case of the mesh-training tests.

    JAX_PLATFORMS=cpu python tools/train_gaps.py \
        [--cases xlstm-350m,zamba2-7b] [--meshes 1x2,2x2,1x4] [--fp64]

For each case (``tests/_mesh_family_ranks.TRAIN_FIELDS``) it trains 3
steps in one process and on every mesh of ``--meshes`` (spawned gloo
ranks; (1, 4) only for ``TRAIN_QUAD``'s cases) and prints, against JAX's
step: the step-1 gradients' worst max |diff| over the tensor's max |g|
(and its leaf), each step's worst metric gap (rel) and the params' max
|diff| after step 1 and after step 3 -- the readings that
``TRAIN_LIMITS`` is set from.  ``--fp64`` then computes the step-1
gradients of one process in float64 too, the port's and JAX's, each from
a copy of ``src/`` made under a temporary directory with every float32
rewritten to float64, and prints per leaf how far each fp32 gradient
lies from the float64 ones: a witness of whether a gap is rounding.
"""
import argparse
import os
import pickle
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 3


def _paths(src: str) -> None:
    sys.path[:0] = [src, os.path.join(ROOT, "tests")]


def rank_run(mesh, path: str, cases: tuple) -> dict:
    """One rank: ``steps`` 1 and 3 of each case (numpy results)."""
    import torch
    import _mesh_family_ranks as F
    import _mesh_ranks as R
    torch.set_num_threads(1)
    data = R.load(path)
    return {(c, n): R.mesh_train(mesh, data[c], F.arch_of(c),
                                 fields=F.TRAIN_FIELDS[c],
                                 device=str(mesh.device), steps=n)
            for c in cases for n in (1, STEPS)}


def _gaps(got: dict, want: dict) -> dict:
    """Worst gaps of one run (``{steps: mesh_train result}``) against
    JAX's (``{steps: jax_train_reference}``)."""
    w = want[STEPS]
    leaf = max(w["grads"], key=lambda k: np.abs(got[STEPS]["grads"][k]
                                                - w["grads"][k]).max()
               / np.abs(w["grads"][k]).max())
    grad = (np.abs(got[STEPS]["grads"][leaf] - w["grads"][leaf]).max()
            / np.abs(w["grads"][leaf]).max())
    metrics = [max(abs(g[k] - m[k]) / max(abs(m[k]), 1e-30)
                   for k in ("loss", "grad_norm", "total_loss"))
               for g, m in zip(got[STEPS]["metrics"], w["metrics"])]

    def params(n):
        return max(np.abs(got[n]["params"][k] - v).max()
                   for k, v in want[n]["params"].items())
    return {"grad": grad, "leaf": leaf, "metrics": metrics,
            "params 1": params(1), f"params {STEPS}": params(STEPS)}


def _show(tag: str, case: str, g: dict) -> None:
    print(f"{tag:8s} {case:15s} step-1 grads {g['grad']:.2e} of max "
          f"({g['leaf']}); metrics rel by step "
          + ", ".join(f"{m:.2e}" for m in g["metrics"])
          + f"; params after step 1 {g['params 1']:.2e}, after step "
          f"{STEPS} {g[f'params {STEPS}']:.2e}", flush=True)


def mesh_gaps(cases: list, meshes: list, tmp: str) -> dict:
    import _mesh_family_ranks as F
    import _mesh_ranks as R
    import _port_helpers as P
    from repro_torch.launch import mesh as LM
    data = {c: P.train_data(F.arch_of(c), **F.TRAIN_FIELDS[c])
            for c in cases}
    path = os.path.join(tmp, "data.pkl")
    with open(path, "wb") as f:
        pickle.dump({c: d["ship"] for c, d in data.items()}, f)
    groups = {}
    for shape in meshes:
        mine = tuple(c for c in cases
                     if shape != (1, 4) or c in F.TRAIN_QUAD)
        if mine:
            groups[shape] = LM.start(rank_run, shape, device="cpu",
                                     timeout_s=1800, args=(path, mine),
                                     threads=1)
    want = {}
    for c in cases:
        b = data[c]["ship"]["batches"]
        want[c] = {n: P.jax_train_reference(data[c]["jmodel"], b[:n])
                   for n in (1, STEPS)}
        one = {n: R.mesh_train(None, data[c]["ship"], F.arch_of(c),
                               F.TRAIN_FIELDS[c], steps=n)
               for n in (1, STEPS)}
        _show("one", c, _gaps(one, want[c]))
    for shape, group in groups.items():
        ranks = group.join()
        for c in cases:
            if (c, STEPS) not in ranks[0]:
                continue
            per = [_gaps({n: r[c, n] for n in (1, STEPS)}, want[c])
                   for r in ranks]
            worst = max(per, key=lambda g: g["grad"])
            worst.update({k: max(g[k] for g in per)
                          for k in ("params 1", f"params {STEPS}")})
            worst["metrics"] = list(np.max([g["metrics"] for g in per],
                                           axis=0))
            _show("x".join(map(str, shape)), c, worst)
    return data


def step1_grads(case: str, flat: dict, batch: dict, f64: bool) -> dict:
    """{"jax": ..., "port": ...} step-1 gradients of one process."""
    import jax
    import _mesh_family_ranks as F
    import _mesh_ranks as R
    import _port_helpers as P
    from repro.train import step as JS
    fields = dict(F.TRAIN_FIELDS[case])
    if f64:
        fields["compute_dtype"] = "float64"
    jcfg, _ = P.configs(arch=F.arch_of(case),
                        **{"num_layers": 2, **fields})
    jmodel, jparams, _ = P.jax_base(jcfg)
    (_, _), g = jax.jit(jax.value_and_grad(JS.make_loss_fn(jmodel),
                                           has_aux=True))(
        P.jax_tree(jparams, flat), batch)
    port = R.mesh_train(None, {"flat": flat, "batches": [batch]},
                        F.arch_of(case), F.TRAIN_FIELDS[case], steps=1)
    return {"jax": P.numpy_flat(g), "port": port["grads"]}


def f64_copy(dest: str) -> str:
    """``src/`` copied under ``dest`` with every float32 made float64
    (the port's "float32" compute dtype resolves to float64 there)."""
    src = os.path.join(ROOT, "src")
    for d, _, files in os.walk(src):
        out = os.path.join(dest, os.path.relpath(d, ROOT))
        os.makedirs(out, exist_ok=True)
        for name in files:
            if not name.endswith(".py"):
                continue
            with open(os.path.join(d, name)) as f:
                text = f.read()
            for mod in ("jnp", "torch", "np"):
                text = text.replace(f"{mod}.float32", f"{mod}.float64")
            text = text.replace('"float32": torch.float64,',
                                '"float32": torch.float64, '
                                '"float64": torch.float64,')
            with open(os.path.join(out, name), "w") as f:
                f.write(text)
    return os.path.join(dest, "src")


def fp64_witness(case: str, data: dict, tmp: str) -> None:
    ship = data[case]["ship"]
    flat, batch = ship["flat"], ship["batches"][0]
    g32 = step1_grads(case, flat, batch, f64=False)
    io = os.path.join(tmp, "fp64.pkl")
    with open(io, "wb") as f:
        pickle.dump((case, flat, batch), f)
    env = dict(os.environ, JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu")
    subprocess.run([sys.executable, os.path.abspath(__file__),
                    "--fp64-child", f64_copy(tmp), io], env=env,
                   check=True)
    with open(io, "rb") as f:
        g64 = pickle.load(f)

    def rel(a, b, k):
        return np.abs(a[k] - b[k]).max() / np.abs(b[k]).max()
    rows = sorted(((rel(g32["port"], g32["jax"], k), k)
                   for k in g32["jax"]), reverse=True)
    print(f"{case} step-1 gradients, max |diff| over the float64 JAX "
          "gradient's max |g|, the leaves worst between port and JAX in "
          "fp32 first:")
    print(f"  {'leaf':22s} {'port64-jax64':>13s} {'jax32-jax64':>12s} "
          f"{'port32-jax64':>13s} {'port32-jax32':>13s}")
    for _, k in rows[:10]:
        print(f"  {k:22s} {rel(g64['port'], g64['jax'], k):13.2e} "
              f"{rel(g32['jax'], g64['jax'], k):12.2e} "
              f"{rel(g32['port'], g64['jax'], k):13.2e} "
              f"{rel(g32['port'], g32['jax'], k):13.2e}")
    print(f"  every leaf: port64-jax64 <= "
          f"{max(rel(g64['port'], g64['jax'], k) for k in g64['jax']):.2e},"
          f" jax32-jax64 <= "
          f"{max(rel(g32['jax'], g64['jax'], k) for k in g64['jax']):.2e}")


def fp64_child(src: str, io: str) -> None:
    _paths(src)
    with open(io, "rb") as f:
        case, flat, batch = pickle.load(f)
    flat = {k: v.astype(np.float64) if v.dtype.kind == "f" else v
            for k, v in flat.items()}
    g = step1_grads(case, flat, batch, f64=True)
    assert all(v.dtype == np.float64 for v in g["port"].values())
    assert all(v.dtype == np.float64 for v in g["jax"].values())
    with open(io, "wb") as f:
        pickle.dump(g, f)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cases", default="xlstm-350m,xlstm-350m-2h,"
                    "zamba2-7b")
    ap.add_argument("--meshes", default="1x2,2x2,1x4")
    ap.add_argument("--fp64", action="store_true")
    ap.add_argument("--fp64-child", nargs=2, metavar=("SRC", "IO"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.fp64_child:
        fp64_child(*args.fp64_child)
        return
    _paths(os.path.join(ROOT, "src"))
    cases = args.cases.split(",")
    meshes = [tuple(map(int, m.split("x"))) for m in
              args.meshes.split(",") if m]
    with tempfile.TemporaryDirectory() as tmp:
        data = mesh_gaps(cases, meshes, tmp)
        if args.fp64:
            for c in cases:
                fp64_witness(c, data, tmp)


if __name__ == "__main__":
    main()
