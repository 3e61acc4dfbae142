"""The decode attention kernels' share of their roofline (kernels 1 / 4
under ``pb.op.paged_decode`` / ``pb.op.mla_decode``): each call's
bound from the frozen cost formulas at its own lengths, over the
device time of the kernels launched under the span, in %."""
from pb.readers import decode_roofline as read  # noqa: F401
