"""PyTorch/CUDA port of PaSCo-TPU: inference, evaluation and training.

The JAX package ``pasco_tpu`` is the reference.  This package imports
``torch`` and never ``jax``, and nothing of ``pasco_tpu``: it keeps its
own copies of the reference's JAX-free host modules under the same
relative paths (``core/config.py``, ``data/``, ``native/``,
``inference/{ensemble,panoptic}.py``, ``metrics/``).  Every Pallas kernel
of the reference is a hand-written CUDA C++ kernel for Hopper
(``csrc/``), built on first use by :mod:`pasco_torch.kernels`.
"""
