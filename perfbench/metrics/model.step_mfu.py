"""The whole step's share of the bf16 peak: the flops the window's tokens
need over the traced window x 989e12, in %."""
from pb.readers import step_mfu as read  # noqa: F401
