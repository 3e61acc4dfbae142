"""The chunk and segment prefill attention kernels' share of their
roofline (kernels 2 / 3, 5 / 6), from each call's offsets or
positions, in %."""
from pb.readers import prefill_roofline as read  # noqa: F401
