"""The port imports torch and never JAX: every ``pasco_torch`` module (and
``chip_smoke.py``) imports in a fresh interpreter with neither ``jax`` nor
``flax`` in ``sys.modules`` afterwards."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = """
import importlib, pkgutil, sys
import pasco_torch
names = [m.name for m in pkgutil.walk_packages(pasco_torch.__path__, "pasco_torch.")]
for name in names + ["chip_smoke"]:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax"))
print(len(names), bad)
assert not bad, bad
assert len(names) >= 15, names
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
