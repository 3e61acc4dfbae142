"""Every mix under ``traffic/`` through the generator it names:
deterministic in its seed, inside the stated ranges, the same sessions
for every seed, and open loop; a generator is found by its name."""
from __future__ import annotations

import json
import pytest

import pbtiny  # noqa: F401  (puts perfbench/ and src/ on the path)
from pb import traffic

MIXES = sorted(p.stem for p in (pbtiny.BENCH / "traffic").glob("*.json"))
MAX_LEN = {"docqa": 16384, "chat-unique": 16384}
VOCAB = 129280


def load(name):
    return json.load(open(pbtiny.BENCH / "traffic" / f"{name}.json"))


def gen(name, seed, seconds=30.0, rate=1.5):
    return traffic.generate(load(name), rate, seconds, seed, VOCAB,
                            MAX_LEN[name])


def test_every_mix_is_covered():
    assert set(MIXES) == set(MAX_LEN)


@pytest.mark.parametrize("name", MIXES)
def test_deterministic_in_seed(name):
    a, b = gen(name, 2**31 + 11), gen(name, 2**31 + 11)
    assert a == b
    c = gen(name, 2**31 + 12)
    assert [x.prompt for x in a] != [x.prompt for x in c]


@pytest.mark.parametrize("name", MIXES)
def test_ranges(name):
    mix = load(name)
    arr = gen(name, 99)
    assert arr and all(0 <= a.t < 30.0 for a in arr)
    assert [a.t for a in arr] == sorted(a.t for a in arr)
    lo, hi = mix.get("turns", [1, 1])
    by_session = {}
    for a in arr:
        by_session.setdefault(a.session, []).append(a)
        assert mix["answer"]["min"] <= a.max_new <= mix["answer"]["max"]
        assert len(a.prompt) + a.max_new + 1 <= MAX_LEN[name]
        assert all(1 <= t < VOCAB for t in a.prompt)
    for turns in by_session.values():
        turns.sort(key=lambda a: a.turn)
        assert len(turns) <= hi
        first = turns[0]
        ctx, user = mix["context"], mix.get("user")
        umin = user["min"] if user else 0
        umax = user["max"] if user else 0
        assert ctx["min"] + umin <= len(first.prompt) <= ctx["max"] + umax
        for cur in turns[1:]:
            assert cur.t >= first.t
            # the same context, another question
            keep = len(first.prompt) - umax
            assert cur.prompt[:keep] == first.prompt[:keep]
    assert lo >= 1


@pytest.mark.parametrize("name", MIXES)
def test_every_seed_gets_the_same_sessions(name):
    """Two seeds serve the same sessions at the same times, on other
    tokens."""
    def shape(seed):
        return [(a.t, a.session, a.turn, len(a.prompt), a.max_new,
                 a.last_turn) for a in gen(name, seed)]
    assert shape(5) == shape(6)


def test_reask_keeps_the_context():
    arr = gen("docqa", 3)
    by = {}
    for a in arr:
        by.setdefault(a.session, []).append(a)
    asked = [v for v in by.values() if len(v) > 1]
    assert asked
    for v in asked:
        v.sort(key=lambda a: a.turn)
        q0 = len(v[0].prompt)
        # every ask is the same document, then its own question
        common = 0
        for x, y in zip(v[0].prompt, v[1].prompt):
            if x != y:
                break
            common += 1
        assert common >= q0 - 256
        assert 2.0 <= v[1].t - v[0].t <= 20.0


def test_poisson_rate():
    from pb.poisson import PoissonArrivals
    t = PoissonArrivals(4.0, seed=1).arrival_times(duration_s=2000.0)
    assert abs(len(t) / 2000.0 - 4.0) < 0.2


def test_generator_is_found_by_name():
    """A mix names its generator, ``traffic/<generator>.py``; a name
    with no file is refused."""
    from pb import spec
    for name in MIXES:
        mod = spec.load_module("traffic", load(name)["generator"])
        assert callable(mod.generate)
    with pytest.raises(KeyError):
        traffic.generate(dict(load("docqa"), generator="no-such"), 1.0,
                         5.0, 1, VOCAB, 16384)
