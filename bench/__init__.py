"""The benchmark of the PyTorch/CUDA port (``repro_torch``): ``bench/run.py``."""
