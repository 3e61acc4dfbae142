"""The device's idle share of the traced window: 1 - the union of its
activity intervals (kernels, copies, fills) over the window, in %."""
from pb.readers import idle_share as read  # noqa: F401
