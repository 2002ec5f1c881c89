"""The port imports torch and never JAX, and nothing of the JAX package:
every ``pasco_torch`` module (the dispatch, evaluation, checkpoint,
converter, tables, timing, visualization, Robo3D, trainer, scene-loader,
data-parallel, KITTI-360, label-generation and output-converter modules
and the sparse substrate's modules named), ``chip_smoke.py`` and the scripts in ``scripts_torch/`` (the
bench, the four evaluation CLIs, the four training CLIs, the label
generator and the visualizer named)
import in a fresh interpreter with
no ``jax``, ``jaxlib``, ``flax`` or ``pasco_tpu`` module in
``sys.modules`` afterwards."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = """
import glob, importlib, importlib.util, os, pkgutil, sys
import pasco_torch
names = [m.name for m in pkgutil.walk_packages(pasco_torch.__path__, "pasco_torch.")]
for name in names + ["chip_smoke"]:
    importlib.import_module(name)
scripts = sorted(glob.glob("scripts_torch/*.py"))
for path in scripts:
    spec = importlib.util.spec_from_file_location(os.path.basename(path)[:-3], path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "pasco_tpu"))
print(len(names), bad)
assert not bad, bad
assert len(names) >= 30, names
assert "scripts_torch/profile_forward.py" in scripts, scripts
for name in ("pasco_torch.inference.dispatch", "pasco_torch.inference.evaluate",
             "pasco_torch.utils.timing", "pasco_torch.utils.visualization",
             "pasco_torch.metrics.tables", "pasco_torch.training.convert_torch",
             "pasco_torch.training.checkpoint", "pasco_torch.data.semantic_kitti.robo3d",
             "pasco_torch.training.loop", "pasco_torch.training.step",
             "pasco_torch.data.loader", "pasco_torch.parallel.mesh",
             "pasco_torch.data.kitti360.dataset", "pasco_torch.data.kitti360.params",
             "pasco_torch.data.label_gen", "pasco_torch.utils.converter",
             "pasco_torch.core.sparse", "pasco_torch.ops.sparse_conv", "pasco_torch.ops.knn",
             "pasco_torch.models.blocks", "pasco_torch.models.cylinder_feat",
             "pasco_torch.models.encoder", "pasco_torch.models.bottleneck",
             "pasco_torch.models.decoder", "pasco_torch.models.maskpls",
             "pasco_torch.models.unet"):
    assert name in names, name
for name in ("bench", "eval", "eval_robo3d", "save_outputs_panoptic", "train",
             "bench_train_step", "make_bench_ckpt", "train_kitti360", "eval_kitti360",
             "gen_instance_labels", "visualize"):
    assert f"scripts_torch/{name}.py" in scripts, name
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
