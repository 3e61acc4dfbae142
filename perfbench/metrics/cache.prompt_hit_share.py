"""1 - the engine's prefilled prompt tokens (``prefill_tokens_total``)
over the prompt tokens the admitted requests covered by the window's
close, by a cache hit or by prefill, in %."""
from pb.readers import prompt_hit_share as read  # noqa: F401
