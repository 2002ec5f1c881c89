"""The port imports torch and never JAX, and nothing of the JAX package:
every ``pasco_torch`` module, ``chip_smoke.py`` and
``scripts_torch/profile_forward.py`` import in a fresh interpreter with
no ``jax``, ``jaxlib``, ``flax`` or ``pasco_tpu`` module in
``sys.modules`` afterwards."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = """
import importlib, importlib.util, pkgutil, sys
import pasco_torch
names = [m.name for m in pkgutil.walk_packages(pasco_torch.__path__, "pasco_torch.")]
for name in names + ["chip_smoke"]:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("profile_forward",
                                              "scripts_torch/profile_forward.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "pasco_tpu"))
print(len(names), bad)
assert not bad, bad
assert len(names) >= 30, names
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
