"""The arithmetic of the metrics, from what one run recorded (``Ctx``).

End-to-end metrics come from the host clock around the served path;
per-layer ones from the trace (``--trace 1``), the step records and the
engine's counters.  A reader that finds nothing to read returns None,
and the metric is left out of the line."""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from pb import cost
from pb.serve import WindowResult
from pb.trace import DECODE_OPS, PREFILL_OPS, TraceSummary

# a time read from the host clock is off by some half a millisecond: a
# request's mean gap between tokens counts only over a span this long
MIN_SPAN_S = 0.25


@dataclass
class Ctx:
    window: WindowResult
    peak_bytes: int = 0
    setup_s: float = 0.0
    trace: Optional[TraceSummary] = None
    calls: List = field(default_factory=list)       # (op, bytes, flops)
    flops_per_token: float = 0.0    # 2 x active params outside the head
    head_flops: float = 0.0         # 2 x hidden x vocab, once a sampled token
    prompt_tokens_covered: int = 0
    check: Dict = field(default_factory=dict)


def pctl(vals: List[float], p: float) -> Optional[float]:
    """Nearest-rank percentile (p in (0, 1])."""
    if not vals:
        return None
    v = sorted(vals)
    return v[max(0, math.ceil(p * len(v)) - 1)]


# -- end to end ---------------------------------------------------------------
def ttfts(w: WindowResult) -> List[float]:
    """Every request due in the window: its first token's time from its
    due time, or (close - due) when none came before the close."""
    out = []
    for h, due in zip(w.handles, w.due):
        t = h.first_token_t
        out.append((t if t is not None and t <= w.t_close else w.t_close)
                   - due)
    return out


def tpots(w: WindowResult) -> List[float]:
    """Each request's mean gap between consecutive output tokens inside
    the window, where its tokens there span MIN_SPAN_S or more."""
    out = []
    for h in w.handles:
        ts = [t for t in h.token_times if t <= w.t_close]
        if len(ts) >= 2 and ts[-1] - ts[0] >= MIN_SPAN_S:
            out.append((ts[-1] - ts[0]) / (len(ts) - 1))
    return out


def output_tokens(w: WindowResult) -> int:
    return sum(1 for h in w.handles for t in h.token_times if t <= w.t_close)


def ttft_p95_ms(ctx: Ctx):
    v = pctl(ttfts(ctx.window), 0.95)
    return None if v is None else v * 1e3


def tbt_p95_ms(ctx: Ctx):
    v = pctl(tpots(ctx.window), 0.95)
    return None if v is None else v * 1e3


def output_tok_per_s(ctx: Ctx):
    return output_tokens(ctx.window) / ctx.window.seconds


def peak_mem_gb(ctx: Ctx):
    return ctx.peak_bytes / 1e9


def setup_s(ctx: Ctx):
    return ctx.setup_s


END_TO_END = {"output_tok_per_s": output_tok_per_s,
              "peak_mem_gb": peak_mem_gb, "setup_s": setup_s}


# -- per layer ----------------------------------------------------------------
def idle_share(ctx: Ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def roofline(ctx: Ctx, ops) -> Optional[float]:
    """Summed bounds of the calls over the device time of the kernels
    under their spans, in %."""
    t = ctx.trace
    if t is None:
        return None
    dev = sum(t.op_device_s.get(op, 0.0) for op in ops)
    calls = [(b, f) for op, b, f in ctx.calls if op in ops]
    if not calls or dev <= 0:
        return None
    return 100.0 * sum(cost.bound_s(b, f) for b, f in calls) / dev


def decode_roofline(ctx: Ctx):
    return roofline(ctx, DECODE_OPS)


def prefill_roofline(ctx: Ctx):
    return roofline(ctx, PREFILL_OPS)


def step_mfu(ctx: Ctx):
    """The flops the window's tokens need over the traced window at the
    bf16 peak: 2 x active parameters a computed token (prefill tokens
    and decode rows), the head once a sampled token, and the attention
    of every call."""
    t = ctx.trace
    if t is None or t.window_s <= 0:
        return None
    w = ctx.window
    rows = sum(s.decode_rows for s in w.steps)
    flops = (ctx.flops_per_token * (w.prefill_tokens + rows)
             + ctx.head_flops * rows + sum(f for _, _, f in ctx.calls))
    return 100.0 * flops / (t.window_s * cost.PEAK_FLOPS_BF16)


def decode_step_ms(ctx: Ctx):
    """Host time of the steps that decoded and prefilled nothing: their
    whole time over their count."""
    st = [s for s in ctx.window.steps
          if s.prefill_tokens == 0 and s.decode_rows > 0]
    if not st:
        return None
    return 1e3 * sum(s.t1 - s.t0 for s in st) / len(st)


def prompt_hit_share(ctx: Ctx):
    """1 - the prompt tokens prefilled over the prompt tokens the
    admitted requests covered by the close, by a hit or by prefill (a
    prompt less its last token, which the first decode step takes)."""
    if ctx.prompt_tokens_covered <= 0:
        return None
    return 100.0 * (1.0 - ctx.window.prefill_tokens
                    / ctx.prompt_tokens_covered)


def decode_rows_mean(ctx: Ctx):
    st = [s.decode_rows for s in ctx.window.steps if s.decode_rows > 0]
    return sum(st) / len(st) if st else None


def pool_used_share(ctx: Ctx):
    w = ctx.window
    if not w.steps or w.pool_pages <= 0:
        return None
    return 100.0 * sum(s.pages_used for s in w.steps) / (len(w.steps)
                                                         * w.pool_pages)
