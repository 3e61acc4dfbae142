"""Synthetic workload trace generators (paper §V-A Workloads).

Each generator yields a stream of ``BlockAccess`` events — the cache-block
level abstraction the paper's trace replay operates on.  Distributional
targets follow the paper's descriptions:

  * ShareGPT-like: multi-turn conversations, mean input 500 / output 300
    tokens; a session's *input* history is re-read each turn (variable
    reuse), model outputs are single-use scratch ("intermediate reasoning
    is typically single-use", §III-C).
  * LMSYS-Chat-1M-like: mean prompt 1,200 tokens with high system-prompt
    reuse (a Zipf-dominated pool of prompt templates).
  * Synthetic Agentic: ReAct-style sessions with 5-15 tool invocations;
    tool-context blocks are shared within and across sessions; handoffs
    reset reuse.

Sessions are interleaved turn-by-turn over a concurrency window, so the
gap between one session's consecutive turns carries many other sessions'
traffic: recency != reuse, which is exactly the structure the Bayesian
predictor exploits and reactive LRU cannot (paper Problem 3).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

BLOCK = 128     # tokens per block (GQA block size, core/sizing.py)


@dataclass(frozen=True)
class BlockAccess:
    content_id: Tuple[int, ...]       # token-block surrogate (hashable)
    block_type: str
    transition: str
    session: str
    tool: Optional[str] = None
    new_session: bool = False


def _blocks(rng, kind: str, ident: int, n_tokens: int) -> List[Tuple]:
    """Content ids for n_tokens worth of blocks; identical (kind, ident)
    yields identical content (dedup / reuse target)."""
    n = max(1, int(round(n_tokens / BLOCK)))
    return [(hash((kind, ident, i)) & 0x7FFFFFFF,) for i in range(n)]


@dataclass
class TraceConfig:
    n_sessions: int = 200
    seed: int = 0
    concurrency: int = 32            # interleaved active sessions


Turn = List[BlockAccess]


def _sharegpt_session(rng, s: int) -> List[Turn]:
    sid = f"sg{s}"
    n_turns = int(rng.integers(2, 9))
    sys_id = int(rng.integers(0, 48))            # 48-prompt pool
    sys_blocks = _blocks(rng, "sys", sys_id, 300)
    history: List[Tuple] = []
    turns: List[Turn] = []
    for t in range(n_turns):
        ev: Turn = []
        first = (t == 0)
        for b in sys_blocks:
            ev.append(BlockAccess(b, "system_prompt", "reasoning_step",
                                  sid, new_session=first))
            first = False
        for b in history:                        # inputs only
            ev.append(BlockAccess(b, "user_context", "reasoning_step", sid))
        inp = _blocks(rng, "u", int(rng.integers(0, 1 << 30)),
                      max(64, int(rng.normal(500, 150))))
        out = _blocks(rng, "r", int(rng.integers(0, 1 << 30)),
                      max(64, int(rng.normal(300, 100))))
        for b in inp:
            ev.append(BlockAccess(b, "user_context", "reasoning_step", sid))
        for b in out:                            # single-use scratch
            ev.append(BlockAccess(b, "intermediate_reasoning",
                                  "reasoning_step", sid))
        history.extend(inp)
        history = history[-12:]
        turns.append(ev)
    return turns


def _lmsys_session(rng, s: int) -> List[Turn]:
    sid = f"lm{s}"
    n_turns = int(rng.integers(1, 6))
    tpl = min(11, int(rng.zipf(1.5)) - 1)        # 12 templates, zipf-heavy
    tpl_blocks = _blocks(rng, "tpl", tpl, 900)
    history: List[Tuple] = []
    turns: List[Turn] = []
    for t in range(n_turns):
        ev: Turn = []
        first = (t == 0)
        for b in tpl_blocks:
            ev.append(BlockAccess(b, "system_prompt", "same_tool_repeat",
                                  sid, new_session=first))
            first = False
        for b in history:
            ev.append(BlockAccess(b, "user_context", "reasoning_step", sid))
        inp = _blocks(rng, "u", int(rng.integers(0, 1 << 30)),
                      max(64, int(rng.normal(450, 150))))
        out = _blocks(rng, "r", int(rng.integers(0, 1 << 30)),
                      max(64, int(rng.normal(500, 150))))
        for b in inp:
            ev.append(BlockAccess(b, "user_context", "reasoning_step", sid))
        for b in out:
            ev.append(BlockAccess(b, "intermediate_reasoning",
                                  "reasoning_step", sid))
        history.extend(inp)
        history = history[-8:]
        turns.append(ev)
    return turns


TOOLS = [f"tool{i}" for i in range(32)]
_TOOL_CTX_CACHE: dict = {}


def _tool_ctx(rng, i: int) -> List[Tuple]:
    if i not in _TOOL_CTX_CACHE:
        _TOOL_CTX_CACHE[i] = _blocks(rng, "tool", i, 1100)
    return _TOOL_CTX_CACHE[i]


def _agentic_session(rng, s: int) -> List[Turn]:
    sid = f"ag{s}"
    n_calls = int(rng.integers(5, 16))
    sys_blocks = _blocks(rng, "agent_sys", int(rng.integers(0, 16)), 400)
    prev_tool: Optional[str] = None
    palette = rng.choice(len(TOOLS), size=3, replace=False)
    turns: List[Turn] = []
    first = True
    for c in range(n_calls):
        ev: Turn = []
        if prev_tool is not None and rng.random() < 0.55:
            tool = prev_tool
        elif rng.random() < 0.1:
            tool = TOOLS[int(rng.integers(0, len(TOOLS)))]
        else:
            tool = TOOLS[int(rng.choice(palette))]
        if prev_tool is None:
            trans = "reasoning_step"
        elif tool == prev_tool:
            trans = "same_tool_repeat"
        elif rng.random() < 0.1:
            trans = "agent_handoff"
        else:
            trans = "tool_switch"
        for b in sys_blocks:
            ev.append(BlockAccess(b, "system_prompt", trans, sid,
                                  tool=tool, new_session=first))
            first = False
        for b in _tool_ctx(rng, TOOLS.index(tool)):
            ev.append(BlockAccess(b, "tool_context", trans, sid, tool=tool))
        think = _blocks(rng, "think", int(rng.integers(0, 1 << 30)),
                        max(64, int(rng.normal(800, 250))))
        for b in think:
            ev.append(BlockAccess(b, "intermediate_reasoning", trans, sid,
                                  tool=tool))
        prev_tool = tool
        turns.append(ev)
    return turns


def _interleave_turns(sessions: List[List[Turn]],
                      cfg: TraceConfig) -> List[BlockAccess]:
    """One scheduling quantum = one full turn; a session's next turn
    arrives after ~concurrency other turns of traffic."""
    rng = np.random.default_rng(cfg.seed + 99)
    out: List[BlockAccess] = []
    pending = list(sessions)
    rng.shuffle(pending)
    live: List[List[Turn]] = []
    while pending or live:
        while pending and len(live) < cfg.concurrency:
            live.append(pending.pop())
        i = int(rng.integers(0, len(live)))
        out.extend(live[i].pop(0))
        if not live[i]:
            live.pop(i)
    return out


def _make(gen_session, cfg: TraceConfig, salt: int) -> List[BlockAccess]:
    rng = np.random.default_rng(cfg.seed + salt)
    sessions = [gen_session(rng, s) for s in range(cfg.n_sessions)]
    return _interleave_turns(sessions, cfg)


SESSION_GENERATORS = {"sharegpt": (_sharegpt_session, 0),
                      "lmsys": (_lmsys_session, 1),
                      "agentic": (_agentic_session, 2)}


def workload_sessions(workload: str, cfg: TraceConfig) -> List[List[Turn]]:
    """Session-level view of a workload: each session is a list of turns,
    each turn a list of ``BlockAccess`` events in submission order.

    The block-level traces (``sharegpt_trace`` & co.) interleave these
    same sessions turn-by-turn; the serving replay adapter
    (``traces/serving_replay.py``) instead drives each session's turns
    through the live ``ServingEngine`` as multi-turn requests.  Salts
    match ``_make``, so session content is identical to the flat trace
    under the same ``TraceConfig``.

    ``file:<path>`` workloads load a real ShareGPT/LMSYS JSON dump
    (``traces/ingest.py``) instead of a synthetic generator; the first
    ``cfg.n_sessions`` conversations replay block-for-block.
    """
    if workload.startswith("file:"):
        from repro_torch.traces.ingest import file_sessions
        return file_sessions(workload[len("file:"):], cfg.n_sessions)
    gen, salt = SESSION_GENERATORS[workload]
    if workload == "agentic":
        _TOOL_CTX_CACHE.clear()
    rng = np.random.default_rng(cfg.seed + salt)
    return [gen(rng, s) for s in range(cfg.n_sessions)]


def sharegpt_trace(cfg: TraceConfig) -> List[BlockAccess]:
    return _make(_sharegpt_session, cfg, 0)


def lmsys_trace(cfg: TraceConfig) -> List[BlockAccess]:
    return _make(_lmsys_session, cfg, 1)


def agentic_trace(cfg: TraceConfig) -> List[BlockAccess]:
    _TOOL_CTX_CACHE.clear()
    return _make(_agentic_session, cfg, 2)


GENERATORS = {"sharegpt": sharegpt_trace, "lmsys": lmsys_trace,
              "agentic": agentic_trace}
