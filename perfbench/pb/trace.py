"""Spans and the reduction of the profiler's trace (``--trace 1``).

The benchmark's own files wrap, at set-up, its calls into each layer:
the front-end's pump (``pb.pump``), ``ServingEngine.step`` (``pb.step``)
and the attention entry points of ``repro_torch.kernels.ops``
(``pb.op.<entry>``), which the model looks up at each call.  A wrap
keeps its host interval on the profiler's clock (``time.time_ns``); an
op's wrap also keeps the call's shapes and a reference to its lengths,
offsets or positions (no device read inside the window), from which the
frozen cost formulas price it once the window has closed.

The profiler traces the device only (CUPTI: kernels, copies, fills and
the runtime calls that launched them); host operators are not recorded,
which keeps its cost to the host's launch path.  The reduction reads the
raw events: each device activity is an interval; their union within the
traced window (the first pump's start to the last pump's end) is the
busy time; a kernel is charged to the ``pb.op`` span whose host interval
holds the runtime call that launched it (matched by correlation id)."""
from __future__ import annotations

import bisect
import contextlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

from pb import cost

DECODE_OPS = ("paged_decode", "mla_decode")
PREFILL_OPS = ("paged_prefill", "paged_prefill_seg", "mla_prefill",
               "mla_prefill_seg")


@dataclass
class OpCall:
    op: str
    shape: cost.CallShape
    ints: torch.Tensor            # lengths [B] / offsets [B] / positions [B, C]


@dataclass
class Spans:
    calls: List[OpCall] = field(default_factory=list)
    host: List[Tuple[int, int, str]] = field(default_factory=list)
    undo: List = field(default_factory=list)

    def remove(self) -> None:
        for fn in reversed(self.undo):
            fn()
        self.undo.clear()


def _shape_gqa(q, kp, bt, ints, chunk=None) -> cost.CallShape:
    return cost.CallShape(tuple(q.shape), q.element_size(), kp.shape[2],
                          kp.shape[3], kp.element_size(), bt.numel(),
                          ints.numel(),
                          0 if chunk is None else chunk.numel())


def _shape_mla(q_lat, q_rope, lat, bt, ints, chunk=None) -> cost.CallShape:
    return cost.CallShape(tuple(q_lat.shape), q_lat.element_size(), 0,
                          q_lat.shape[-1], lat.element_size(), bt.numel(),
                          ints.numel(),
                          0 if chunk is None else chunk.numel(),
                          rope=q_rope.shape[-1])


def install(frontend, engine, spans: Spans) -> None:
    """Put the spans around the pump, the step and the attention ops."""
    import time

    from repro_torch.kernels import ops
    host = spans.host
    clock = time.time_ns

    def wrap_attr(obj, attr, name, keep=None):
        inner = getattr(obj, attr)

        def wrapped(*a, **kw):
            if keep is not None:
                keep(*a, **kw)
            t0 = clock()
            try:
                return inner(*a, **kw)
            finally:
                host.append((t0, clock(), name))

        setattr(obj, attr, wrapped)
        spans.undo.append(lambda: setattr(obj, attr, inner))

    wrap_attr(frontend, "pump_once", "pb.pump")
    wrap_attr(engine, "step", "pb.step")

    def keep_decode(q, kp, vp, bt, lengths, *a, **kw):
        spans.calls.append(OpCall("paged_decode",
                                  _shape_gqa(q, kp, bt, lengths), lengths))

    def keep_prefill(op):
        def keep(q, kc, vc, kp, vp, bt, ints, *a, **kw):
            spans.calls.append(OpCall(op, _shape_gqa(q, kp, bt, ints, kc),
                                      ints))
        return keep

    def keep_mla_decode(q_lat, q_rope, lat, bt, lengths, *a, **kw):
        spans.calls.append(OpCall("mla_decode",
                                  _shape_mla(q_lat, q_rope, lat, bt, lengths),
                                  lengths))

    def keep_mla_prefill(op):
        def keep(q_lat, q_rope, chunk, lat, bt, ints, *a, **kw):
            spans.calls.append(OpCall(op, _shape_mla(q_lat, q_rope, lat, bt,
                                                     ints, chunk), ints))
        return keep

    keeps = {"paged_decode": keep_decode,
             "paged_prefill": keep_prefill("paged_prefill"),
             "paged_prefill_seg": keep_prefill("paged_prefill_seg"),
             "mla_decode": keep_mla_decode,
             "mla_prefill": keep_mla_prefill("mla_prefill"),
             "mla_prefill_seg": keep_mla_prefill("mla_prefill_seg")}
    for op, keep in keeps.items():
        wrap_attr(ops, op, f"pb.op.{op}", keep)


def call_cost(c: OpCall) -> Tuple[float, float]:
    """(bytes, flops) of one recorded call from its own ints."""
    ints = c.ints.detach().to("cpu", torch.int64)
    if c.op in DECODE_OPS:
        tokens = int(ints.clamp_min(0).sum())
        if c.op == "paged_decode":
            return cost.decode_cost(c.shape, tokens)
        return cost.mla_cost(c.shape, tokens, tokens)
    C = c.shape.q[1]
    if c.op.endswith("_seg"):
        pos = ints.reshape(-1)
        valid = pos[pos >= 0]
        pool = int(valid.max()) if valid.numel() else 0
        pairs = int((valid + 1).sum())
    else:
        off = ints.reshape(-1)
        pool = int(off.sum())
        pairs = int((C * off + C * (C + 1) // 2).sum())
    if c.op.startswith("mla"):
        return cost.mla_cost(c.shape, pool, pairs)
    return cost.prefill_cost(c.shape, pool, pairs)


@contextlib.contextmanager
def profiled(enabled: bool):
    """The profiler over the block when ``enabled`` and a card is there
    (device activity only); yields the profile object or None."""
    if not enabled or not torch.cuda.is_available():
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        yield prof


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    op_device_s: Dict[str, float]         # pb.op.<op> -> device seconds
    device_ops: List[Tuple[str, float]]   # top kernels by device time
    idle_gaps: List[Tuple[str, float]]    # idle time by host span
    n_device_events: int


def _union(intervals: List[Tuple[int, int]]) -> Tuple[int, List[Tuple[int, int]]]:
    """Total length of the union, and the merged intervals."""
    intervals.sort()
    merged: List[Tuple[int, int]] = []
    for s, e in intervals:
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return sum(e - s for s, e in merged), merged


def reduce_trace(prof, spans: List[Tuple[int, int, str]]
                 ) -> Optional[TraceSummary]:
    """The busy time, each op span's device time, the top kernels and
    the idle time by host span, from the raw events of ``prof`` and the
    host ``spans``.  None where the trace holds no device activity or
    the window no pump."""
    events = prof.profiler.kineto_results.events()
    cpu_dev = torch.autograd.DeviceType.CPU
    launches: Dict[int, int] = {}            # correlation id -> host start
    dev: List[Tuple[int, int, str, int]] = []
    for e in events:
        name = e.name()
        if e.device_type() == cpu_dev:
            if name.startswith("cu"):        # runtime / driver calls
                cid = e.correlation_id()
                if cid:
                    launches[cid] = e.start_ns()
        elif not e.is_user_annotation():
            dev.append((e.start_ns(), e.end_ns(), name, e.correlation_id()))
    pumps = [s for s in spans if s[2] == "pb.pump"]
    if not dev or not pumps:
        return None
    lo = min(s[0] for s in pumps)
    hi = max(s[1] for s in pumps)
    clipped = [(max(s, lo), min(e, hi)) for s, e, _, _ in dev
               if e > lo and s < hi]
    busy, merged = _union(clipped)
    # op spans, innermost first: sorted by start for bisect
    ops_sp = sorted((s, e, n[len("pb.op."):]) for s, e, n in spans
                    if n.startswith("pb.op."))
    starts = [s for s, _, _ in ops_sp]
    op_dev: Dict[str, float] = {}
    by_kernel: Dict[str, float] = {}
    for s, e, name, cid in dev:
        if e <= lo or s >= hi:
            continue
        dur = (e - s) / 1e9
        key = name[:120]
        by_kernel[key] = by_kernel.get(key, 0.0) + dur
        t = launches.get(cid)
        if t is None:
            continue
        op = _holder(ops_sp, starts, t)
        if op is not None:
            op_dev[op] = op_dev.get(op, 0.0) + dur
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
    gaps = idle_by_host(merged, lo, hi, spans)
    return TraceSummary((hi - lo) / 1e9, busy / 1e9, op_dev, top, gaps,
                        len(dev))


def _holder(level: List[Tuple[int, int, str]], starts: List[int],
            t: int) -> Optional[str]:
    """The span of one level (spans of a level do not overlap) that
    holds t, or None."""
    j = bisect.bisect_right(starts, t) - 1
    if j >= 0 and level[j][1] >= t:
        return level[j][2]
    return None


def idle_by_host(merged: List[Tuple[int, int]], lo: int, hi: int,
                 spans: List[Tuple[int, int, str]]) -> List[Tuple[str, float]]:
    """Idle device time inside the window, each gap named by the
    innermost benchmark span on the host at its middle (an op, else the
    step, else the pump, else "host"), summed by name: the ten
    largest."""
    levels = []
    for pred in (lambda n: n.startswith("pb.op."),
                 lambda n: n == "pb.step", lambda n: n == "pb.pump"):
        lv = sorted(x for x in spans if pred(x[2]))
        levels.append((lv, [s for s, _, _ in lv]))
    edges = [lo] + [x for iv in merged for x in iv] + [hi]
    out: Dict[str, float] = {}
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) // 2
        name = "host"
        for lv, starts in levels:
            got = _holder(lv, starts, mid)
            if got is not None:
                name = got
                break
        out[name] = out.get(name, 0.0) + (b - a) / 1e9
    return sorted(out.items(), key=lambda kv: -kv[1])[:10]
