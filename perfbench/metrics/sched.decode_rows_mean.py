"""Requests that got a token a decode step: the window's sum over its
steps that decoded, over their count."""
from pb.readers import decode_rows_mean as read  # noqa: F401
