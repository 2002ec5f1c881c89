"""The benchmark of the PyTorch/CUDA port of PaSCo: see benchmark/run.py."""
