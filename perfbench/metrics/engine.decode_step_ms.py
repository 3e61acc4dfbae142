"""Host time of ``ServingEngine.step`` over the steps that only decoded:
their whole time over their count, in ms."""
from pb.readers import decode_step_ms as read  # noqa: F401
