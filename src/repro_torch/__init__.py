"""PyTorch / CUDA port of the predictive multi-tier KV-cache serving
system.  Imports ``torch`` and numpy only; the JAX package ``repro`` is
the reference it is tested against."""
