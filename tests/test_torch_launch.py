"""The serving launcher's frequent-update run, against the JAX launcher.

``--updates N`` runs N update + hot-swap cycles on v0 after the requests,
then a rollback, and prints each pointer move; the version lines must be
the JAX launcher's (``src/repro/launch/serve.py:198-215``) and the tokens
those of the same cycles driven through ``Deployment.update`` and
``rollback`` by hand.  ``--max-resident`` bounds the registry, and the run
ends with the TTFT line the JAX launcher prints.  Reduced archs, one
process, on the CPU.

Under a mesh (``--mesh``: the port's ranks spawned over gloo; JAX's
launcher in a subprocess over forced host devices, started by the module
fixture while the port serves) the speculative scheduler, ``--warmup``
and MoE with ``--pod-banks`` print JAX's version lines and budgets, and
both launchers refuse ``--pod-banks`` beside ``--speculative`` or a
2-value ``--mesh``."""
import ast
import json
import os
import pathlib
import re
import subprocess
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


# ---------------------------------------------------------------------------
# under a mesh, against the JAX launcher on forced host devices
# ---------------------------------------------------------------------------

_COMMON = ["--reduced", "--variants", "2", "--new-tokens", "3", "--mode",
           "fused", "--updates", "1"]
MESH_ARGV = {
    "speculative": ["--arch", "deepseek-7b", "--requests", "4", "--batch",
                    "2", "--speculative", "--mesh", "1,2"] + _COMMON,
    "warmup": ["--arch", "deepseek-7b", "--requests", "4", "--batch", "2",
               "--scheduler", "continuous", "--warmup", "--mesh", "1,2"]
    + _COMMON,
    "moe pods": ["--arch", "deepseek-moe-16b", "--requests", "6", "--batch",
                 "4", "--scheduler", "continuous", "--pod-banks", "--mesh",
                 "2,1,2"] + _COMMON,
}
REFUSED_ARGV = {
    "pod banks speculative": ["--arch", "deepseek-7b", "--reduced",
                              "--mode", "fused", "--speculative",
                              "--pod-banks", "--mesh", "2,1,2"],
    "pod banks two-value mesh": ["--arch", "deepseek-7b", "--reduced",
                                 "--mode", "fused", "--scheduler",
                                 "continuous", "--pod-banks", "--mesh",
                                 "1,2"],
}
_JAX_DRIVER = """
import contextlib, io, json, sys, traceback
from repro.launch import serve as JSV
out = {}
for label, argv in json.loads(sys.argv[1]).items():
    buf, code = io.StringIO(), 0
    sys.argv = ["serve"] + argv
    try:
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(buf):
            JSV.main()
    except SystemExit as e:
        code = e.code
    except Exception:
        code, buf = "raised", io.StringIO(traceback.format_exc())
    out[label] = [code, buf.getvalue()]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_mesh_runs():
    """The JAX launcher over every case, in one subprocess with 4 forced
    host devices (this process's JAX has one), started here and read on
    first use."""
    src = pathlib.Path(__file__).resolve().parents[1] / "src"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(src))
    proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_DRIVER,
         json.dumps({**MESH_ARGV, **REFUSED_ARGV})],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    got = {}

    def read():
        if not got:
            out, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-3000:]
            got.update(json.loads(out.strip().splitlines()[-1]))
        return got
    yield read
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def _tokens_generated(text: str) -> int:
    m = re.search(r"^metrics: .*'tokens_generated': (\d+)", text, re.M)
    assert m, text[-2000:]
    return int(m.group(1))


@pytest.mark.parametrize("case", sorted(MESH_ARGV))
def test_mesh_launcher_prints_jax_version_lines_and_budgets(
        case, jax_mesh_runs, capfd):
    """The port's launcher under a mesh (its ranks spawned, rank 0
    reporting) prints the JAX launcher's version lines, generates the same
    number of tokens (every budget met) and reports the same number of
    first tokens; the ranks served the same tokens.  Under
    ``--speculative`` every rank prints the same ladder snapshot; under
    ``--warmup`` every outcome is "eager"; with ``--pod-banks`` the
    router's line is JAX's."""
    SV.main(MESH_ARGV[case] + ["--device", "cpu"])
    out = capfd.readouterr().out
    code, jout = jax_mesh_runs()[case]
    assert code == 0, jout[-3000:]
    assert _version_lines(out) == _version_lines(jout) == [
        "update 0: v0 -> version 2", "rollback: v0 -> version 1"]
    assert _tokens_generated(out) == _tokens_generated(jout)
    assert _ttft(out)[2] == _ttft(jout)[2]
    assert "ranks served the same tokens" in out
    if case == "speculative":
        snaps = [ast.literal_eval(ln.partition(":")[2].strip())
                 for ln in out.splitlines()
                 if ln.startswith("speculative rank ")]
        assert len(snaps) == 2 and snaps[0] == snaps[1]
    if case == "warmup":
        line = next(ln for ln in out.splitlines()
                    if ln.startswith("warmup:"))
        assert set(json.loads(line.partition(":")[2]).values()) == {"eager"}
    if case == "moe pods":
        def affinity(text):
            return [ln for ln in text.splitlines()
                    if ln.startswith(("affinity:", "bank residents"))]
        assert affinity(out) == affinity(jout) and affinity(out)


@pytest.mark.parametrize("case", sorted(REFUSED_ARGV))
def test_mesh_launcher_refuses_what_jax_refuses(case, jax_mesh_runs,
                                                capsys):
    """``--pod-banks`` beside ``--speculative`` (JAX's Deployment raises;
    the port refuses its arguments) or a 2-value ``--mesh`` (an argument
    error in both)."""
    code, jout = jax_mesh_runs()[case]
    assert code != 0
    with pytest.raises(SystemExit) as e:
        SV.main(REFUSED_ARGV[case] + ["--device", "cpu"])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "--pod-banks" in err
    assert ("speculative" in jout) if "speculative" in case else (
        "3-value --mesh" in jout and "3-value --mesh" in err)
