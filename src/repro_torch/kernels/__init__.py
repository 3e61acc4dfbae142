"""Attention kernels (paged decode and prefill, dense causal prefill):
hand-written CUDA for Hopper (``csrc/``) beside their plain PyTorch
versions (``ref.py``)."""
