"""PyTorch/CUDA port of PaSCo-TPU's inference forward.

The JAX package ``pasco_tpu`` is the reference.  This package imports
``torch`` and never ``jax``; it reuses only the reference's JAX-free NumPy
host modules (config, data, ensembling, panoptic assembly).  Every Pallas
kernel on the inference path is a hand-written CUDA C++ kernel for Hopper
(``csrc/``), built on first use by :mod:`pasco_torch.kernels`.
"""
