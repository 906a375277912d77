"""The port imports neither JAX nor anything of the JAX package: every
module of ``repro_torch`` imports in a fresh interpreter whose import
system refuses ``jax`` and ``repro``."""
import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"

SCRIPT = r"""
import importlib, importlib.abc, pkgutil, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"repro_torch must not import {name}")
        return None

sys.meta_path.insert(0, Refuse())
import repro_torch
names = ["repro_torch"]
for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(info.name)
    names.append(info.name)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not leaked, leaked
print(len(names))
"""


def test_every_port_module_imports_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", SCRIPT], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20
