"""What the benchmark loads: the reference nothing of the program or of
JAX, the harness nothing of JAX or the JAX package (top-level module names
compared whole: ``pasco_torch`` begins with ``pasco_t`` and is not
``pasco_tpu``)."""

import ast
import os
import subprocess
import sys

from conftest import ROOT

BENCH = os.path.join(ROOT, "benchmark")
JAX = {"jax", "jaxlib", "flax", "pasco_tpu"}


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def loaded_after(code):
    """Top-level names of ``sys.modules`` after running ``code`` in a
    fresh interpreter from the repository root."""
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(' '.join(sorted({k.split('.')[0] for k in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(out.stdout.split())


def test_reference_sources_import_no_program_and_no_jax():
    ref = os.path.join(BENCH, "reference")
    for name in os.listdir(ref):
        if name.endswith(".py"):
            found = top_level_imports(os.path.join(ref, name))
            assert not found & (JAX | {"pasco_torch"}), (name, found)


def test_reference_loads_no_program_and_no_jax():
    loaded = loaded_after("import benchmark.reference.model, benchmark.reference.compare, "
                          "benchmark.reference.control")
    assert not loaded & (JAX | {"pasco_torch"}), loaded & (JAX | {"pasco_torch"})


def test_harness_loads_no_jax():
    loaded = loaded_after("import benchmark.run, benchmark.program, benchmark.kinds.eval_scans, "
                          "benchmark.calibrate\nbenchmark.program.parameter_shapes("
                          "benchmark.run.load_json('benchmark/configs/pasco_single_semkitti.json'))")
    assert "pasco_torch" in loaded
    assert not loaded & JAX, loaded & JAX
