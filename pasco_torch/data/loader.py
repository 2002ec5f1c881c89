"""Scene loading for the trainer (counterpart of
``pasco_tpu/training/loop.py:61-156``): collated scenes from a dataset in
this process, read ahead by a thread (:class:`ReadAhead`), or made by a pool
of worker processes (:func:`load_scenes`, :func:`parallel_scene_iterator`).

NumPy only: this module imports no ``torch``, so a worker process that
imports it starts quickly and never touches a CUDA device.
"""

from __future__ import annotations

import collections
import os
import pickle
import queue
import tempfile
import threading
from typing import Dict, Iterable, Iterator, Tuple

import numpy as np

from pasco_torch.core.config import PaSCoConfig
from pasco_torch.data.semantic_kitti.collate import CollatedScene, collate


_END = object()


def _fill(iterator, q: "queue.Queue", closed: threading.Event, failure: list) -> None:
    try:
        for item in iterator:
            q.put(item)
            if closed.is_set():
                break
    except BaseException as e:           # handed to the consumer, raised there
        failure.append(e)
    finally:
        if hasattr(iterator, "close"):
            iterator.close()
        q.put(_END)


class ReadAhead:
    """The items of ``iterator``, made ahead by a thread that starts at once
    (the reference's ``_prefetch``, ``pasco_tpu/training/loop.py:61-78``),
    at most ``size`` waiting.  An exception in the thread is raised to the
    consumer.  :meth:`close` (also on leaving a ``with`` block) stops the
    thread, which then closes ``iterator``."""

    def __init__(self, iterator: Iterable, size: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=size)
        self._closed = threading.Event()
        self._failure: list = []
        self._done = False
        self._thread = threading.Thread(
            target=_fill, args=(iter(iterator), self._q, self._closed, self._failure),
            daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        if not self._done:
            item = self._q.get()
            if item is not _END:
                return item
            self._done = True
            if self._failure:
                raise self._failure[0]
        raise StopIteration

    def close(self) -> None:
        self._closed.set()
        while self._thread.is_alive():       # let a blocked put return
            try:
                self._q.get(timeout=0.1)
            except queue.Empty:
                pass

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def scene_iterator(dataset, cfg: PaSCoConfig, indices, max_targets: int = 64, rng=None):
    """Collated scenes of ``dataset[i]`` for ``i`` in ``indices``, in this
    process."""
    for i in indices:
        yield collate(dataset[i], cfg, max_targets=max_targets, rng=rng)


def index_rng(seed: int, i: int) -> np.random.RandomState:
    """The draws of scene ``i`` in a worker: the dataset's own draws (scan
    pairing, augmentation) and the collate's, seeded by the index, so that a
    scene does not depend on the worker that makes it
    (``pasco_tpu/training/loop.py:96-108``)."""
    return np.random.RandomState((seed * 100_003 + i) % (2**31 - 1))


_WORKER: Dict[str, object] = {}


def _worker_init(dataset, cfg, max_targets, out_dir):
    _WORKER.update(dataset=dataset, cfg=cfg, max_targets=max_targets, out_dir=out_dir)


def _write_scene(scene: CollatedScene, path: str) -> None:
    """``scene`` as a pickle whose arrays follow it raw (pickle protocol 5,
    out-of-band buffers), so that :func:`_read_scene` reads them with the
    interpreter lock released."""
    bufs = []
    meta = pickle.dumps(scene, protocol=5, buffer_callback=bufs.append)
    raws = [b.raw() for b in bufs]
    head = pickle.dumps((meta, [r.nbytes for r in raws]))
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for r in raws:
            f.write(r)


def _read_scene(path: str) -> CollatedScene:
    """The scene :func:`_write_scene` wrote (the file is removed)."""
    with open(path, "rb", buffering=0) as f:
        meta, sizes = pickle.loads(f.read(int.from_bytes(f.read(8), "little")))
        bufs = []
        for n in sizes:
            buf = np.empty(n, np.uint8)
            view, got = memoryview(buf), 0
            while got < n:
                k = f.readinto(view[got:])
                if not k:
                    raise EOFError(f"{path}: {got} of {n} bytes")
                got += k
            bufs.append(buf)
    os.remove(path)
    return pickle.loads(meta, buffers=bufs)


def _worker_load(i: int, seed: int, n: int) -> str:
    """Scene ``i`` collated and written to a file of the loader's
    directory (:func:`_write_scene`); returns the path.  NumPy only: a
    worker never initialises CUDA."""
    ds = _WORKER["dataset"]
    rng = index_rng(seed, i)
    if hasattr(ds, "rng"):
        ds.rng = rng
    scene = collate(ds[i], _WORKER["cfg"], max_targets=_WORKER["max_targets"], rng=rng)
    path = os.path.join(_WORKER["out_dir"], f"scene_{n}.bin")
    _write_scene(scene, path)
    return path


def load_scenes(dataset, cfg: PaSCoConfig, tasks: Iterable[Tuple[int, int]],
                max_targets: int = 64, num_workers: int = 3,
                prefetch: int = 2) -> Iterator[CollatedScene]:
    """Collated scenes for ``tasks`` (``(index, seed)`` pairs, the scene's
    draws from :func:`index_rng`), in order, made by a spawn pool of
    ``num_workers`` processes that keeps ``num_workers + prefetch`` scenes
    in flight.  A worker hands its scene (hundreds of MB at ``PaSCoConfig()``)
    over as a file in a temporary directory, which this generator reads
    when the caller asks for it (:func:`_read_scene`): a scene handed back
    through the pool would be unpickled by the pool's result thread, under
    the interpreter lock, while the main thread launches kernels.  The pool
    and the directory live as long as the generator."""
    import concurrent.futures as cf
    import multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="pasco_scenes_") as out_dir:
        ex = cf.ProcessPoolExecutor(
            max_workers=num_workers, mp_context=mp.get_context("spawn"),
            initializer=_worker_init, initargs=(dataset, cfg, max_targets, out_dir))
        try:
            tasks = enumerate(tasks)
            pending: "collections.deque" = collections.deque()

            def submit(k):
                for n, (i, seed) in tasks:
                    pending.append(ex.submit(_worker_load, int(i), seed, n))
                    if len(pending) >= k:
                        return

            submit(num_workers + prefetch)
            while pending:
                path = pending.popleft().result()
                submit(num_workers + prefetch)
                yield _read_scene(path)
        finally:
            ex.shutdown(wait=True, cancel_futures=True)


def parallel_scene_iterator(dataset, cfg: PaSCoConfig, indices, max_targets: int = 64,
                            num_workers: int = 3, seed: int = 0, prefetch: int = 2):
    """Scenes of ``indices`` in order from ``num_workers`` worker processes
    (:func:`load_scenes`), or from this process with one
    ``RandomState(seed)`` for ``num_workers <= 0``
    (``pasco_tpu/training/loop.py:111-156``)."""
    if num_workers <= 0:
        return scene_iterator(dataset, cfg, indices, max_targets,
                              rng=np.random.RandomState(seed))
    return load_scenes(dataset, cfg, ((i, seed) for i in indices), max_targets,
                       num_workers, prefetch)
