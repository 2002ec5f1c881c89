"""Data parallelism over ``torch.distributed`` (counterpart of
``pasco_tpu/parallel``)."""
