"""Tests and benches must see ONE device: the 512-device virtualization
belongs exclusively to launch/dryrun.py (assignment requirement)."""
import os


def pytest_configure(config):
    flags = os.environ.get("XLA_FLAGS", "")
    assert "host_platform_device_count" not in flags, (
        "XLA_FLAGS device-count virtualization must not leak into tests")
    config.addinivalue_line(
        "markers", "slow: multi-minute end-to-end runs (CPU interpret "
        "mode); deselect with -m 'not slow'")
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips elsewhere (run with "
        "-m gpu on the card)")
