"""Train the WaffleIron point-segmentation frontend on the port (counterpart
of ``scripts_tpu/train_waffleiron.py``, itself the reference's
``WaffleIron_mod/launch_train.py``: 48 layers x 256 channels, grids
(250,250)/(250,12)/(250,12), voxel 0.1 m, FOV +-50 m, AdamW +
WarmupCosine, CE + Lovasz).

    python scripts_torch/train_waffleiron.py --dataset_root <semkitti> --out <dir>
    python scripts_torch/train_waffleiron.py --synthetic --epochs 2 --steps_per_epoch 4

SemanticKITTI scans load from ``dataset_root/sequences/<seq>/velodyne/*.bin``
and ``labels`` (remapped to WaffleIron's 19 classes); without a dataset,
``--synthetic`` trains on generated scenes, drawn from ``RandomState(0)`` in
the reference's order.  The Segmenter reads ``[x, y, z, intensity, |xy|]``,
the reference trainer's layout (the reference extractor's differs: ROADMAP
queue 3).  ``--resume`` continues from ``<out>/ckpt_last.pkl`` at the epoch
after it.  Runs on the card (``--device cuda``, the default; raises
without one); at the end it prints the train steps' median seconds (after
the first) and, on the card, the peak device memory.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def synthetic_cloud(rng, n=12000, n_classes=19):
    xyz = rng.randn(n, 3).astype(np.float32) * np.array([15, 15, 1.5])
    intensity = rng.rand(n, 1).astype(np.float32)
    radius = np.linalg.norm(xyz[:, :2], axis=1, keepdims=True)
    pc = np.concatenate([xyz, intensity, radius], axis=1)
    labels = (
        (np.floor(xyz[:, 0] / 5) + np.floor(xyz[:, 1] / 5)) % n_classes
    ).astype(np.int32)
    labels[rng.rand(n) < 0.05] = 255
    return pc, labels


def main(argv=None):
    """Returns the :class:`WaffleIronTrainer` after its last epoch."""
    p = argparse.ArgumentParser()
    p.add_argument("--dataset_root", default=None)
    p.add_argument("--out", default="./logs/waffleiron")
    p.add_argument("--epochs", type=int, default=45)
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--num_points", type=int, default=20000)
    p.add_argument("--depth", type=int, default=48)
    p.add_argument("--channels", type=int, default=256)
    p.add_argument("--n_classes", type=int, default=19)
    p.add_argument("--lr", type=float, default=0.001)
    p.add_argument("--weight_decay", type=float, default=0.003)
    p.add_argument("--voxel", type=float, default=0.1)
    p.add_argument("--fov", type=float, default=50.0)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--steps_per_epoch", type=int, default=8,
                   help="synthetic mode: batches per epoch")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import torch

    from pasco_torch.models.waffleiron import Segmenter, segmenter_device
    from pasco_torch.training.waffleiron_train import (
        Compose,
        Crop,
        FlipXY,
        LimitNumPoints,
        RandomApply,
        Rotation,
        Scale,
        Voxelize,
        WaffleIronTrainer,
        build_point_batch,
        create_waffle_state,
        make_waffleiron_optimizer,
    )

    dev = segmenter_device(args.device)
    rng = np.random.RandomState(0)
    aug = Compose(
        [
            Crop(fov=((-args.fov, -args.fov, -8), (args.fov, args.fov, 8))),
            Voxelize(voxel_size=args.voxel, random=True, rng=rng),
            LimitNumPoints(max_point=args.num_points, random=True, rng=rng),
            RandomApply(Rotation(rng=rng), prob=0.5, rng=rng),
            RandomApply(FlipXY(rng=rng), prob=0.5, rng=rng),
            RandomApply(Scale(rng=rng), prob=0.5, rng=rng),
        ]
    )
    val_prep = Compose(
        [
            Crop(fov=((-args.fov, -args.fov, -8), (args.fov, args.fov, 8))),
            Voxelize(voxel_size=args.voxel, rng=rng),
            LimitNumPoints(max_point=args.num_points, rng=rng),
        ]
    )

    def batch_of(clouds, labels):
        return build_point_batch(clouds, labels, args.num_points, fov=args.fov, device=dev)

    if args.synthetic or args.dataset_root is None:
        def scans(n_scans):
            for _ in range(n_scans):
                yield synthetic_cloud(rng, n_classes=args.n_classes)

        def make_batches(prep, n_batches):
            def fn():
                for _ in range(n_batches):
                    clouds, labels = [], []
                    for pc, lab in scans(args.batch_size):
                        pc2, lab2 = prep(pc, lab)
                        clouds.append(pc2)
                        labels.append(lab2)
                    yield batch_of(clouds, labels)
            return fn

        train_fn = make_batches(aug, args.steps_per_epoch)
        val_fn = make_batches(val_prep, max(args.steps_per_epoch // 4, 1))
    else:
        from pasco_torch.data.semantic_kitti.io_data import (
            get_remap_lut,
            read_point_label,
            read_pointcloud,
        )

        # WaffleIron's 19 classes = the 20-class SSC remap minus "empty"
        remap = get_remap_lut()

        def read_pointcloud_scan(root, seq, frame):
            base = os.path.join(root, "sequences", seq)
            pc = read_pointcloud(os.path.join(base, "velodyne", frame + ".bin"))
            raw = read_point_label(os.path.join(base, "labels", frame + ".label"))
            sem = remap[(raw & 0xFFFF).astype(np.uint16)].astype(np.int32)
            lab = np.where(sem == 0, 255, sem - 1)   # drop empty, 0-based
            return pc, lab.astype(np.int32)

        def seq_files(split):
            seqs = (
                ["00", "01", "02", "03", "04", "05", "06", "07", "09", "10"]
                if split == "train"
                else ["08"]
            )
            files = []
            for s in seqs:
                d = os.path.join(args.dataset_root, "sequences", s, "velodyne")
                if os.path.isdir(d):
                    files += [
                        (s, f[:-4]) for f in sorted(os.listdir(d)) if f.endswith(".bin")
                    ]
            return files

        def make_batches(split, prep):
            files = seq_files(split)

            def fn():
                order = rng.permutation(len(files))
                for i in range(0, len(order) - args.batch_size + 1, args.batch_size):
                    clouds, labels = [], []
                    for j in order[i : i + args.batch_size]:
                        s, fr = files[j]
                        pc, lab = read_pointcloud_scan(args.dataset_root, s, fr)
                        radius = np.linalg.norm(pc[:, :2], axis=1, keepdims=True)
                        pc = np.concatenate([pc, radius], axis=1)
                        pc2, lab2 = prep(pc, lab)
                        clouds.append(pc2)
                        labels.append(lab2)
                    yield batch_of(clouds, labels)
            return fn

        train_fn = make_batches("train", aug)
        val_fn = make_batches("val", val_prep)

    net = Segmenter(n_classes=args.n_classes, channels=args.channels, depth=args.depth,
                    in_channels=5)
    net.reset_parameters(torch.Generator().manual_seed(0))
    net = net.to(dev)
    tx = make_waffleiron_optimizer(
        lr=args.lr, weight_decay=args.weight_decay,
        warmup_end=4 * args.steps_per_epoch,
        max_iter=args.epochs * args.steps_per_epoch,
    )
    next(iter(train_fn()))   # the reference draws one batch here (its init's shapes)
    state = create_waffle_state(net, tx)
    trainer = WaffleIronTrainer(net, tx, state, args.out)
    if args.resume and os.path.exists(os.path.join(args.out, "ckpt_last.pkl")):
        trainer.load_state()
        print(f"resumed from {os.path.join(args.out, 'ckpt_last.pkl')} at epoch "
              f"{trainer.current_epoch}")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    trainer.train(train_fn, val_fn, args.epochs)
    steps = trainer.step_sec
    if steps:
        median = statistics.median(steps[1:]) if len(steps) > 1 else steps[0]
        line = f"{len(steps)} train steps, median {median:.4f} s/step after the first"
        if dev.type == "cuda":
            line += (f", peak {torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB on "
                     f"{torch.cuda.get_device_name(dev)}")
        print(line)
    return trainer


if __name__ == "__main__":
    main()
