"""The 95th percentile over requests of each request's mean gap between
consecutive output tokens (over requests whose tokens in the window
span 0.25 s or more), in ms; recorded, not judged."""
from pb.readers import tbt_p95_ms as read  # noqa: F401
