"""The 95th percentile (nearest rank) of time to first token over every
request due in the window, from its due time; one with no first token
by the close counts at (close - due), in ms.  Past the knee the queue
grows all through the run, so this tail swings with the smallest
change: it is recorded, not judged."""
from pb.readers import ttft_p95_ms as read  # noqa: F401
