"""The serving launcher's frequent-update run, against the JAX launcher.

``--updates N`` runs N update + hot-swap cycles on v0 after the requests,
then a rollback, and prints each pointer move; the version lines must be
the JAX launcher's (``src/repro/launch/serve.py:198-215``) and the tokens
those of the same cycles driven through ``Deployment.update`` and
``rollback`` by hand.  ``--max-resident`` bounds the registry, and the run
ends with the TTFT line the JAX launcher prints.  Reduced archs, one
process, on the CPU."""
import ast
import re
import sys

import numpy as np
import pytest

from repro.launch import serve as JSV
from repro_torch.core import calibration as C
from repro_torch.launch import serve as SV

ARGV = ["--arch", "deepseek-7b", "--reduced", "--variants", "1",
        "--requests", "1", "--new-tokens", "1", "--batch", "1", "--mode",
        "dense", "--updates", "1"]


def _version_lines(text: str) -> list:
    return [ln for ln in text.splitlines()
            if ln.startswith(("update ", "rollback:"))]


def _ttft(text: str) -> tuple:
    m = re.search(r"^ttft: p50=(\d+\.\d{4})s p99=(\d+\.\d{4})s \(n=(\d+)\)$",
                  text, re.M)
    assert m, text[-2000:]
    return float(m.group(1)), float(m.group(2)), int(m.group(3))


@pytest.fixture(scope="module")
def jax_run():
    """The JAX launcher's output for ``ARGV`` (run once, in this
    process)."""
    import contextlib
    import io
    out = io.StringIO()
    argv = sys.argv
    sys.argv = ["serve"] + ARGV
    try:
        with contextlib.redirect_stdout(out):
            JSV.main()
    finally:
        sys.argv = argv
    return out.getvalue()


def test_launcher_updates_print_jax_version_lines(jax_run, capsys):
    SV.main(ARGV + ["--device", "cpu"])
    out = capsys.readouterr().out
    want = _version_lines(jax_run)
    assert want == ["update 0: v0 -> version 2", "rollback: v0 -> version 1"]
    assert _version_lines(out) == want
    # both print the TTFT line over every request: one, one update wave
    # of --batch, one after the rollback
    assert _ttft(out)[2] == _ttft(jax_run)[2] == 3


def test_launcher_updates_tokens_equal_a_direct_run(capsys):
    """Two cycles under the continuous scheduler: versions 2, 3, then
    rollback to 2; the tokens are those of the same calls made by hand on
    the same seeds, and every request gets its budget."""
    argv = ["--arch", "qwen3-8b", "--reduced", "--num-layers", "2",
            "--variants", "2", "--requests", "3", "--new-tokens", "3",
            "--batch", "2", "--mode", "fused", "--scheduler", "continuous",
            "--updates", "2", "--max-resident", "2", "--device", "cpu"]
    got = SV._serve(SV._parser().parse_args(argv), None, 0.0)
    out = capsys.readouterr().out
    assert _version_lines(out) == ["update 0: v0 -> version 2",
                                   "update 1: v0 -> version 3",
                                   "rollback: v0 -> version 2"]
    p50, p99, n = _ttft(out)
    assert n == 3 + 2 * 2 + 1 and 0 < p50 <= p99
    # the same cycles by hand
    cfg = SV.make_config("qwen3-8b", reduced=True, num_layers=2)
    model, base, dms = SV.build_variants(cfg, 2, "cpu")
    dep = SV.deploy(model, base, dms, mode="fused", scheduler="continuous",
                    batch=2, device="cpu", max_resident=2)
    rng = np.random.default_rng(0)
    rids = SV.submit_requests(dep, cfg, 3, 3, rng=rng)
    dep.drain()
    flat_base = C.flatten_params(base)
    tune = SV.fine_tune(base, 100)
    versions = []
    for _ in range(2):
        tune = C.unflatten_like(tune, {
            p: t + 0.2 * (t - flat_base[p]) if t.dim() >= 2 else t
            for p, t in C.flatten_params(tune).items()})
        versions.append(dep.update("v0", C.compress(base, tune)))
        rids += [dep.submit(rng.integers(1, cfg.vocab_size, size=8),
                            variant="v0", max_new_tokens=3)
                 for _ in range(2)]
        dep.drain()
    versions.append(dep.rollback("v0"))
    rids.append(dep.submit(rng.integers(1, cfg.vocab_size, size=8),
                           variant="v0", max_new_tokens=3))
    dep.drain()
    want = [dep.result(r).out_tokens for r in rids]
    assert versions == [2, 3, 2]
    assert got == want
    assert all(len(t) == 3 for t in got)


def test_launcher_max_resident_bounds_the_registry(capsys):
    """Dense residency over two variants with ``--max-resident 1``: every
    swap past the first evicts, as the JAX registry's LRU does."""
    argv = ["--arch", "qwen3-8b", "--reduced", "--num-layers", "1",
            "--variants", "2", "--requests", "6", "--new-tokens", "1",
            "--batch", "1", "--mode", "dense", "--device", "cpu"]
    stats = {}
    for cap in (0, 1):
        SV.main(argv + ["--max-resident", str(cap)])
        out = capsys.readouterr().out
        line = next(ln for ln in out.splitlines()
                    if ln.startswith("registry:"))
        stats[cap] = ast.literal_eval(line.partition(":")[2].strip())
    # default (2 for dense): both variants stay; capacity 1: they trade
    assert stats[0]["evictions"] == 0 and stats[0]["swaps"] == 2
    assert stats[1]["evictions"] == stats[1]["swaps"] - 1 >= 2
