"""Traffic: a mix is a data file (``traffic/<mix>.json``) of lengths,
turns and gaps that names its generator, ``traffic/<generator>.py``,
found by that name; a cell gives the offered rate of sessions a second.
A mix of a shape that a generator already makes adds only its data
file; one of a new shape (bursts, segments) adds its generator too.

A generator's ``generate(mix, rate, seconds, seed, vocab, max_len)``
returns the run's schedule: every request due before ``seconds``,
sorted by time, each fitting ``max_len`` (prompt + answer + 1 cache
slots).  Every seed gets the same sessions at the same times, drawn
from the mix's ``structure_seed``; the seed draws every token, so two
seeds do the same work on other data."""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from pb import spec


@dataclass(frozen=True)
class Arrival:
    t: float                      # seconds after the window opens
    session: int
    turn: int
    prompt: Tuple[int, ...]
    max_new: int
    last_turn: bool


def draw_len(rng: np.random.Generator, d: Dict) -> int:
    """One length from a ``{"dist", ...}`` spec, clipped to [min, max]."""
    kind = d["dist"]
    lo, hi = int(d["min"]), int(d["max"])
    if kind == "fixed":
        return lo
    if kind == "uniform":
        return int(rng.integers(lo, hi + 1))
    if kind == "lognormal":
        v = float(d["median"]) * math.exp(float(d["sigma"])
                                          * rng.standard_normal())
        return int(min(hi, max(lo, round(v))))
    raise ValueError(f"unknown length distribution {kind!r}")


def draw_gap(rng: np.random.Generator, d: Dict) -> float:
    return float(rng.uniform(float(d["min"]), float(d["max"])))


def generate(mix: Dict, rate: float, seconds: float, seed: int,
             vocab: int, max_len: int) -> List[Arrival]:
    """The schedule of one run, from the mix's generator."""
    gen = spec.load_module("traffic", mix["generator"])
    return gen.generate(mix, rate, seconds, seed, vocab, max_len)
