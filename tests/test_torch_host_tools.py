"""The port's host tools against the reference package's, on the CPU:

* ``pasco_torch.data.label_gen.generate_instance_labels`` on a seeded
  semantic volume with thing components both above and below the 8-voxel
  floor: identical instance and cleaned semantic arrays;
* ``generate_all`` over a temporary SemanticKITTI layout (two sequences,
  raw label ids through the remap table, invalid voxels): byte-identical
  pickles; ``scripts_torch/gen_instance_labels.py`` writes the same files;
* ``pasco_torch.utils.converter``'s two functions: identical outputs;
* ``scripts_torch/visualize.py --median_filter 3`` against
  ``scripts_tpu/visualize.py`` on one output pickle: byte-identical PLYs;
* ``scripts_torch/profile_forward.py --report-only`` on a trace that
  ``torch.profiler`` writes on the CPU (host ops, labelled so) and on a
  trace with device kernels (the kernel groups, per iteration).
"""

import importlib
import json
import os
import pickle
import runpy
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _both(name):
    return (importlib.import_module(f"pasco_tpu.{name}"),
            importlib.import_module(f"pasco_torch.{name}"))


def _run_script(path, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [path, *argv])
    runpy.run_path(path, run_name="__main__")


def seeded_semantic(shape, seed, n_blobs=60):
    """Train ids: stuff noise, thing boxes of 1-5 voxels a side (many under
    the 8-voxel floor, some touching), a few unknown (255) voxels."""
    r = np.random.RandomState(seed)
    sem = r.choice([0, 0, 0, 9, 11, 15], size=shape).astype(np.uint8)
    for _ in range(n_blobs):
        lo = [r.randint(0, s - 1) for s in shape]
        ext = r.randint(1, 6, 3)
        sl = tuple(slice(a, min(a + e, s)) for a, e, s in zip(lo, ext, shape))
        sem[sl] = r.randint(1, 9)
    sem[r.rand(*shape) < 0.01] = 255
    return sem


def test_generate_instance_labels_identical():
    ref, port = _both("data.label_gen")
    sem = seeded_semantic((40, 36, 12), seed=0)
    inst_r, sem_r = ref.generate_instance_labels(sem)
    inst_p, sem_p = port.generate_instance_labels(sem)
    np.testing.assert_array_equal(inst_p, inst_r)
    np.testing.assert_array_equal(sem_p, sem_r)
    assert inst_p.dtype == inst_r.dtype and sem_p.dtype == sem_r.dtype
    # both branches ran: instances kept, and small ones cleared to 255
    assert inst_p.max() > 5
    assert (sem_p == 255).sum() > (sem == 255).sum()


def write_semkitti_voxels(root, frames=("000000", "000001", "000002"), seqs=("00", "08")):
    """Raw SemanticKITTI voxel labels (uint16 raw ids) and bit-packed
    invalid masks at the dataset's 256x256x32 for each sequence."""
    from pasco_torch.data.semantic_kitti import io_data

    lut = io_data.get_remap_lut()
    raw_of = {int(t): int(np.flatnonzero(lut == t)[0]) for t in np.unique(lut) if t != 255}
    for k, seq in enumerate(seqs):
        vox = os.path.join(root, "dataset", "sequences", seq, "voxels")
        os.makedirs(vox)
        for j, frame in enumerate(frames):
            sem = seeded_semantic((256, 256, 32), seed=10 * k + j, n_blobs=400)
            sem[sem == 255] = 0
            raw = np.vectorize(raw_of.get)(sem).astype(np.uint16)
            raw.reshape(-1).tofile(os.path.join(vox, f"{frame}.label"))
            invalid = np.random.RandomState(k + j).rand(256 * 256 * 32) < 0.02
            io_data.pack(invalid).tofile(os.path.join(vox, f"{frame}.invalid"))


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            with open(os.path.join(d, n), "rb") as fh:
                out[os.path.relpath(os.path.join(d, n), root)] = fh.read()
    return out


def test_generate_all_and_cli_identical(tmp_path, monkeypatch):
    ref, port = _both("data.label_gen")
    write_semkitti_voxels(str(tmp_path / "kitti"))
    kw = dict(sequences=["00", "08", "99"], n_processes=1, frame_interval=2)
    got_r = ref.generate_all(str(tmp_path / "kitti"), str(tmp_path / "ref"), **kw)
    got_p = port.generate_all(str(tmp_path / "kitti"), str(tmp_path / "port"), **kw)
    assert [os.path.relpath(p, tmp_path / "port") for p in got_p] == \
        [os.path.relpath(p, tmp_path / "ref") for p in got_r] == \
        ["00/000000_1_1.pkl", "00/000002_1_1.pkl", "08/000000_1_1.pkl", "08/000002_1_1.pkl"]
    files_r, files_p = _files(tmp_path / "ref"), _files(tmp_path / "port")
    assert files_p == files_r
    data = pickle.loads(files_p["00/000000_1_1.pkl"])
    assert data["instance_labels"].max() > 0 and (data["semantic_labels"] == 255).any()
    _run_script(os.path.join(ROOT, "scripts_torch", "gen_instance_labels.py"),
                ["--dataset_root", str(tmp_path / "kitti"), "--output_root",
                 str(tmp_path / "cli"), "--n_process", "1", "--frame_interval", "2",
                 "--sequences", "00", "08"], monkeypatch)
    assert _files(tmp_path / "cli") == files_r


def test_converter_identical():
    ref, port = _both("utils.converter")
    r = np.random.RandomState(0)
    thing_ids = (1, 2, 3, 4, 5, 6, 7, 8)
    sem = r.choice([0, 1, 2, 9, 11, 255], size=(20, 18, 6)).astype(np.int32)
    inst = np.where(np.isin(sem, thing_ids), r.randint(0, 4, sem.shape), 0).astype(np.int32)
    pan_r, segs_r = ref.semantic_instance_to_panoptic(sem, inst, thing_ids)
    pan_p, segs_p = port.semantic_instance_to_panoptic(sem, inst, thing_ids)
    np.testing.assert_array_equal(pan_p, pan_r)
    assert segs_p == segs_r and len(segs_p) > 4
    for a, b in zip(ref.panoptic_to_semantic_instance(pan_r, segs_r, thing_ids),
                    port.panoptic_to_semantic_instance(pan_p, segs_p, thing_ids)):
        np.testing.assert_array_equal(b, a)


def test_visualize_cli_identical(tmp_path, monkeypatch):
    r = np.random.RandomState(1)
    shape = (24, 20, 8)
    sem = r.randint(0, 20, shape).astype(np.uint8)
    pan = r.randint(0, 6, shape).astype(np.int32)
    segs = [{"id": i, "category_id": int(r.randint(1, 20)), "isthing": bool(i % 2)}
            for i in range(1, 6)]
    outs = [{"semantic_seg_dense": sem, "panoptic_seg_dense": pan, "segments_info": segs,
             "ssc_confidence": r.rand(*shape).astype(np.float32)} for _ in range(2)]
    path = tmp_path / "frame_000000.pkl"
    with open(path, "wb") as fh:
        pickle.dump({"outputs": outs}, fh)
    for pkg in ("scripts_tpu", "scripts_torch"):
        _run_script(os.path.join(ROOT, pkg, "visualize.py"),
                    ["--input", str(path), "--output_dir", str(tmp_path / pkg),
                     "--median_filter", "3"], monkeypatch)
    ref, port = _files(tmp_path / "scripts_tpu"), _files(tmp_path / "scripts_torch")
    assert sorted(port) == ["frame_000000_panoptic.ply", "frame_000000_semantic.ply",
                            "frame_000000_uncertainty.ply"]
    assert port == ref


def test_profile_report_only_reads_a_cpu_trace(tmp_path, monkeypatch, capsys):
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            torch.relu(x @ x).sum()
    prof.export_chrome_trace(str(tmp_path / "forward_trace.json"))
    _run_script(os.path.join(ROOT, "scripts_torch", "profile_forward.py"),
                ["--report-only", "--out", str(tmp_path), "--iters", "2", "--top", "3"],
                monkeypatch)
    out = capsys.readouterr().out
    assert "holds no device kernels" in out and "aten::mm" in out
    assert len([ln for ln in out.splitlines() if ln.startswith("  ")]) == 3


def test_profile_report_only_groups_kernels(tmp_path, monkeypatch, capsys):
    events = [{"cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 50}]
    for it in range(2):
        t0 = 1000 * it
        events += [
            {"cat": "kernel", "name": "void masked_conv3_kernel<64, false>", "ts": t0, "dur": 300},
            {"cat": "kernel", "name": "sm90_xmma_gemm_bf16", "ts": t0 + 300, "dur": 100},
            {"cat": "kernel", "name": "void extract_kernel<0>", "ts": t0 + 400, "dur": 20},
        ]
    (tmp_path / "train_trace.json").write_text(json.dumps({"traceEvents": events}))
    _run_script(os.path.join(ROOT, "scripts_torch", "profile_forward.py"),
                ["--report-only", "--train", "--out", str(tmp_path), "--top", "2"],
                monkeypatch)
    out = capsys.readouterr().out
    assert "kernel time 0.840 ms" in out                # both iterations of the one trace
    assert "masked_conv3" in out and "GEMM" in out and "stream_extract" in out
    assert "void extract_kernel<0>" not in out          # only the top 2 kernels listed


@pytest.mark.parametrize("script", ["gen_instance_labels", "visualize"])
def test_host_tool_clis_parse_the_reference_flags(script):
    """The port's CLIs accept exactly the reference CLIs' flags."""
    import argparse

    def flags(path):
        seen = []
        real = argparse.ArgumentParser.add_argument

        def record(self, *names, **kw):
            seen.extend(names)
            return real(self, *names, **kw)

        argparse.ArgumentParser.add_argument = record
        try:
            sys_argv, sys.argv = sys.argv, [path, "--help"]
            with pytest.raises(SystemExit):
                runpy.run_path(path, run_name="__main__")
        finally:
            sys.argv = sys_argv
            argparse.ArgumentParser.add_argument = real
        return sorted(seen)

    assert flags(os.path.join(ROOT, "scripts_torch", f"{script}.py")) == \
        flags(os.path.join(ROOT, "scripts_tpu", f"{script}.py"))
