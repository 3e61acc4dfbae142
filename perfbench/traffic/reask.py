"""Sessions that each ask one context (a document, or a prompt alone)
one or more times: turn k is [context ; user_k], the same context asked
again with a new question of ``user`` tokens (none where the mix has no
``user``).  ``turns`` [lo, hi] is the asks a session; turn k > 1
arrives ``gap_s`` after the first ask.  A turn whose prompt and answer
would not fit ``max_len`` ends its session.

Sessions arrive as a Poisson process at the cell's rate (open loop).
(Dealing the sessions to the arrival times in a seeded order, even
within runs of 8 arrivals, moved the tails of a 51-second window by
30-40 % between seeds, where two runs of one seed agreed within ~10 %:
so every seed gets the same sessions at the same times.)"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from pb.poisson import PoissonArrivals
from pb.traffic import Arrival, draw_gap, draw_len


def session_shapes(mix: Dict, n: int, rng: np.random.Generator) -> List:
    """``n`` sessions, each (context tokens, [(user tokens, answer
    tokens, gap s) for each turn])."""
    out = []
    lo, hi = mix.get("turns", [1, 1])
    for _ in range(n):
        n_turns = int(rng.integers(int(lo), int(hi) + 1))
        ctx = draw_len(rng, mix["context"])
        turns = []
        for k in range(n_turns):
            user = draw_len(rng, mix["user"]) if "user" in mix else 0
            ans = draw_len(rng, mix["answer"])
            gap = draw_gap(rng, mix["gap_s"]) if k else 0.0
            turns.append((user, ans, gap))
        out.append((ctx, turns))
    return out


def fitted(shapes, max_len: int):
    """Cut each session before its first turn that does not fit
    ``max_len`` (prompt + answer + 1 cache slots)."""
    out = []
    for ctx, turns in shapes:
        keep = []
        for user, ans, gap in turns:
            if ctx + user + ans + 1 > max_len:
                break
            keep.append((user, ans, gap))
        if keep:
            out.append((ctx, keep))
    return out


def generate(mix: Dict, rate: float, seconds: float, seed: int,
             vocab: int, max_len: int) -> List[Arrival]:
    """Every ask due before ``seconds``, sorted by time."""
    srng = np.random.default_rng(int(mix.get("structure_seed", 0)))
    starts = PoissonArrivals(rate, rng=srng).arrival_times(
        duration_s=seconds)
    shapes = fitted(session_shapes(mix, len(starts), srng), max_len)
    # every session needs a start: a cut session is dropped, so draw
    # enough shapes to cover the arrivals
    while len(shapes) < len(starts):
        shapes += fitted(session_shapes(mix, len(starts), srng), max_len)
    shapes = shapes[:len(starts)]
    rng = np.random.default_rng(int(seed))
    out: List[Arrival] = []
    for s, t0 in enumerate(starts):
        ctx, turns = shapes[s]
        body = [int(x) for x in rng.integers(1, vocab, ctx)]
        for k, (user, ans, gap) in enumerate(turns):
            t = t0 + gap
            prompt = body + [int(x) for x in rng.integers(1, vocab, user)]
            if t < seconds:
                out.append(Arrival(t, s, k, tuple(prompt), ans,
                                   k == len(turns) - 1))
    out.sort(key=lambda a: (a.t, a.session, a.turn))
    return out
