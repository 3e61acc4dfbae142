"""Pages held over the pool's pages after each step (the allocator's own
accounting), averaged over the steps, in %."""
from pb.readers import pool_used_share as read  # noqa: F401
