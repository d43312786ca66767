"""PyTorch + CUDA port of the IMC joint hardware-workload co-optimization
system.  The JAX package ``repro`` is the reference; this package imports
nothing of it.  Entry points take ``device=`` (default ``"cuda"``)."""
