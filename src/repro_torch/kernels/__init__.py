"""Paged attention kernels: hand-written CUDA for Hopper (``csrc/``)
beside their plain PyTorch versions (``ref.py``)."""
