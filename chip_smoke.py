#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit; imports nothing of JAX.
Phases, each printed as one JSON object on its own line; any failed
check raises and the script exits non-zero with no result line:

  device   the card's name and power limit (nvidia-smi) and torch's name;
  build    nvcc build of every kernel source (one nvcc per source, in
           parallel) with the compiler's register and spill report;
  kernels  each kernel at the serving path's shapes (llama3.2-1b:
           Hq=32, Hkv=8, hd=64, page=64, C=64, bf16 pools, ragged
           lengths up to 512 with inactive rows) against its plain
           PyTorch version on the same inputs, timed with CUDA events
           over a window of launches queued ahead of the device (L2
           flushed before each launch, the flushes' own time taken
           off), beside the least time the card could take for the
           same work;
  serve    the engine at full llama3.2-1b width (seeded random bf16
           weights, default EngineConfig) serving shared-prefix and
           segment-reuse traffic, 16 new tokens per request, with the
           kernels' launch counts taken over this phase alone;
  parity   one decode step, one prefill chunk and one segment chunk of
           the full-width model with the CUDA kernels and then with the
           plain versions (explicit backend="torch") on the same weights
           and state, and with plain versions that each get one mask
           wrong by one token, which the limit must catch.

Then the ``{"kernels": [...]}`` summary, the card's nvidia-smi line, and
last ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

H100_HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
H100_BF16_FLOPS = 989e12             # dense bf16 tensor-core peak
# Kernel vs plain version, bf16 outputs: both accumulate in float32 and
# round once to bf16, so another summation order can move an output by
# one bf16 step (2^-8 relative); the outputs are convex combinations of
# N(0,1) values, |o| < 4, so one step is at most 2^-6.
KERNEL_ATOL = 2.0 ** -6
# Full model, kernels vs plain versions (parity phase): logits and K/V
# are held to 2^-4 of the tensor's largest magnitude.  On an H100 the
# kernels' gap reads at most 2^-5.3 of it (bf16 rounding carried through
# 16 layers), and plain versions with a one-token mask error move the
# same tensors by at least 2^-1.3 of it; the phase checks both sides.
PARITY_RTOL = 2.0 ** -4


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------
def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> dict:
    """Device time of one ``fn()``, each launch after an L2 flush (the
    serving path meets every layer's pool cold).

    One CUDA-event window holds ``iters`` (flush, ``fn()``) pairs and a
    second one ``iters`` flushes alone; ``ms`` is their difference over
    ``iters``.  Both windows are queued behind a device-side sleep, and
    the sleep is checked to be still running once the host has queued
    the whole window, so the device never waits on the host inside it:
    the wrapper's checks and its ctypes call stay out of the reading."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()

    def window(with_fn: bool) -> float:
        cycles = 1 << 27
        for _ in range(6):
            torch.cuda._sleep(cycles)
            slept = torch.cuda.Event()
            slept.record()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                flush.zero_()
                if with_fn:
                    fn()
            end.record()
            queued_ahead = not slept.query()
            end.synchronize()
            if queued_ahead:
                return start.elapsed_time(end)
            cycles *= 4
        raise AssertionError("the host could not queue a timing window "
                             "ahead of the device")

    both, flushes = window(True), window(False)
    return {"ms": (both - flushes) / iters, "flush_ms": flushes / iters}


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / H100_HBM_BYTES_PER_S
    t_ops = flops / H100_BF16_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------
def ptxas_report(text: str) -> list:
    """Registers and spill stores per compiled entry, from ``-Xptxas -v``."""
    out, cur = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = {"entry": m.group(1), "registers": None,
                   "spill_store_bytes": 0}
            out.append(cur)
        elif cur is not None:
            m = re.search(r"(\d+) bytes spill stores", line)
            if m:
                cur["spill_store_bytes"] = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                cur["registers"] = int(m.group(1))
    return out


def phase_build(build, card):
    t0 = time.perf_counter()
    log = build.build_all()
    wall = time.perf_counter() - t0
    report = {name: {"nvcc_s": entry["seconds"],
                     "entries": ptxas_report(entry["ptxas"])}
              for name, entry in log.items()}
    emit({"phase": "build", "card": card, "wall_s": wall,
          "sources": report})


def make_kernel_inputs(torch, gen):
    """Main-path shapes: 64 decode rows over a 529-page pool (the
    default engine's slot and page counts at llama3.2-1b width)."""
    B, Hq, Hkv, hd, page, P, C = 64, 32, 8, 64, 64, 8, 64
    N = 1 + B * P + 16
    dev = "cuda"

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    kp, vp = randn(N, page, Hkv, hd), randn(N, page, Hkv, hd)
    perm = torch.randperm(N - 1, generator=gen, device=dev)[:B * P] + 1
    tables = perm.reshape(B, P).to(torch.int32)
    lengths = torch.randint(1, P * page + 1, (B,), generator=gen,
                            device=dev).to(torch.int32)
    lengths[::7] = 0                        # inactive rows
    tables[::7] = 0
    lengths[1] = P * page                   # one full table
    dec = dict(q=randn(B, Hq, hd), k_pages=kp, v_pages=vp,
               block_tables=tables, lengths=lengths)
    table1 = tables[1:2].contiguous()
    off = torch.tensor([320], dtype=torch.int32, device=dev)
    pre = dict(q=randn(1, C, Hq, hd), k_chunk=randn(1, C, Hkv, hd),
               v_chunk=randn(1, C, Hkv, hd), k_pages=kp, v_pages=vp,
               block_tables=table1, offsets=off)
    # a gap chunk: block 0's second half, then a resumed block, then the
    # tail; 8 padding slots
    pos = list(range(64, 96)) + list(range(256, 280))
    cpos = torch.tensor([pos + [-1] * (C - len(pos))], dtype=torch.int32,
                        device=dev)
    seg = dict(pre, chunk_positions=cpos)
    seg.pop("offsets")
    return dec, pre, seg


def decode_cost(a):
    q, kp, lengths = a["q"], a["k_pages"], a["lengths"]
    B, Hq, hd = q.shape
    Hkv = kp.shape[2]
    el = kp.element_size()
    toks = int(lengths.clamp_min(0).sum())
    nbytes = (2 * q.numel() * q.element_size() + 2 * toks * Hkv * hd * el
              + a["block_tables"].numel() * 4 + B * 4)
    flops = 4 * toks * Hq * hd
    return nbytes, flops


def prefill_cost(a, attended_pool, causal_pairs):
    """attended_pool: pool tokens read; causal_pairs: sum over queries of
    (pool keys + chunk keys) attended."""
    q, kp = a["q"], a["k_pages"]
    _, C, Hq, hd = q.shape
    Hkv = kp.shape[2]
    el = kp.element_size()
    nbytes = (2 * q.numel() * q.element_size()
              + 2 * a["k_chunk"].numel() * a["k_chunk"].element_size()
              + 2 * attended_pool * Hkv * hd * el
              + a["block_tables"].numel() * 4 + 4 * C)
    flops = 4 * causal_pairs * Hq * hd
    return nbytes, flops


def phase_kernels(torch, ops, card):
    gen = torch.Generator(device="cuda").manual_seed(1234)
    dec, pre, seg = make_kernel_inputs(torch, gen)
    C = pre["q"].shape[1]
    off = int(pre["offsets"][0])
    cp = [int(x) for x in seg["chunk_positions"][0]]
    valid = [p for p in cp if p >= 0]
    own = set(valid)
    seg_pool = {t for p in valid for t in range(p) if t not in own}
    seg_pairs = sum(len([t for t in range(p) if t not in own])
                    for p in cp if p >= 0) + C * (C + 1) // 2
    cases = [
        ("paged_decode", ops.paged_decode, dec, decode_cost(dec)),
        ("paged_prefill", ops.paged_prefill, pre,
         prefill_cost(pre, off, C * off + C * (C + 1) // 2)),
        ("paged_prefill_seg", ops.paged_prefill_seg, seg,
         prefill_cost(seg, len(seg_pool), seg_pairs)),
    ]
    rows = {}
    for name, fn, args, (nbytes, flops) in cases:
        out = fn(**args, backend="cuda")
        torch.cuda.synchronize()
        plain = fn(**args, backend="torch")
        err = float((out.float() - plain.float()).abs().max())
        finite = bool(torch.isfinite(out).all())
        if not finite or err > KERNEL_ATOL:
            raise AssertionError(f"{name}: kernel vs plain max_abs_err "
                                 f"{err} (tol {KERNEL_ATOL}), finite "
                                 f"{finite}")
        kt = time_ms(torch, lambda: fn(**args, backend="cuda"))
        pt = time_ms(torch, lambda: fn(**args, backend="torch"))
        bound_ms, bound_by = bound(nbytes, flops)
        rows[name] = {"max_abs_err": err, "tol": KERNEL_ATOL,
                      "ms": kt["ms"], "plain_ms": pt["ms"],
                      "flush_ms": kt["flush_ms"], "bound_ms": bound_ms,
                      "bound_by": bound_by, "bytes": nbytes,
                      "flops": flops, "library_ms": None}
        emit({"phase": "kernels", "card": card, "kernel": name,
              **rows[name]})
    # contiguous positions: the segment kernel equals the offset kernel
    # bit for bit
    contig = torch.arange(off, off + C, dtype=torch.int32,
                          device="cuda")[None]
    a = dict(pre)
    a.pop("offsets")
    same = torch.equal(ops.paged_prefill_seg(**a, chunk_positions=contig,
                                             backend="cuda"),
                       ops.paged_prefill(**pre, backend="cuda"))
    if not same:
        raise AssertionError("segment kernel with contiguous positions "
                             "differs from the offset kernel")
    emit({"phase": "kernels", "contiguous_seg_equals_offset": same})
    return rows


def phase_serve(torch, kernel_fns, card):
    from repro_torch.configs import get_config
    from repro_torch.serving import EngineConfig, SamplingParams, \
        ServingEngine

    cfg = get_config("llama3.2-1b")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = ServingEngine(cfg, EngineConfig(), device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    finite = []
    decode = eng.model.decode_step_paged

    def checked_decode(*a, **kw):
        logits, state = decode(*a, **kw)
        finite.append(torch.isfinite(logits).all())
        return logits, state
    eng.model.decode_step_paged = checked_decode

    rng = torch.Generator().manual_seed(7)

    def toks(n):
        return torch.randint(0, cfg.vocab_size, (n,),
                             generator=rng).tolist()

    bt = eng.manager.block_tokens                    # 128
    system = toks(2 * bt)
    shared = [system + toks(128) for _ in range(6)]
    s0, s1, s2, x0 = toks(bt), toks(bt), toks(bt), toks(bt)
    seg_a = s0 + s1 + s2 + toks(40)
    seg_b = x0 + s1 + s2 + toks(40)
    waves = [shared[:1], shared[1:], [seg_a], [seg_b]]

    for fn in kernel_fns.values():
        fn.launches = 0
    reqs, decode_s, decode_tokens, decode_steps, steps = [], 0.0, 0, 0, 0
    t_serve = time.perf_counter()
    for wave in waves:
        reqs += [eng.submit(p, params=SamplingParams(max_new_tokens=16))
                 for p in wave]
        while eng.scheduler.has_work():
            t = time.perf_counter()
            produced = eng.step()      # ends in a device->host copy
            dt = time.perf_counter() - t
            steps += 1
            if produced and eng.last_step_prefill_tokens == 0:
                decode_s += dt
                decode_tokens += produced
                decode_steps += 1
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t_serve
    launches = {name: fn.launches for name, fn in kernel_fns.items()}
    st = eng.stats()
    eng.shutdown()

    ttft = sorted(r.ttft for r in reqs)
    out = {"phase": "serve", "card": card, "model": cfg.name,
           "layers": cfg.n_layers, "d_model": cfg.d_model,
           "requests": len(reqs), "steps": steps,
           "init_s": init_s, "serve_s": serve_s,
           "ttft_p50_s": ttft[len(ttft) // 2],
           "ttft_p99_s": ttft[min(len(ttft) - 1,
                                  math.ceil(0.99 * len(ttft)) - 1)],
           "decode_tok_per_s": decode_tokens / decode_s if decode_s else None,
           "decode_only_steps": decode_steps,
           "decode_only_steps_tokens": decode_tokens,
           "decode_only_step_ms": (1e3 * decode_s / decode_steps
                                   if decode_steps else None),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": launches,
           "prefill_chunks": st["prefill_chunks"],
           "cow_share_hits": st["cow_share_hits"],
           "segment_chunks": st["segment_chunks"],
           "segment_share_hits": st["segment_share_hits"],
           "kernel_backend": st["kernel_backend"]}
    emit(out)
    bad = [r.request_id for r in reqs if len(r.generated) != 16]
    if bad:
        raise AssertionError(f"requests {bad} did not produce 16 tokens")
    if not all(bool(f) for f in finite):
        raise AssertionError("non-finite logits in a decode step")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"serve path")
    if st["cow_share_hits"] <= 0 or st["segment_chunks"] <= 0:
        raise AssertionError("serve traffic missed the CoW prefix or the "
                             "segment-reuse path")
    return eng.params, launches


def phase_parity(torch, params, card):
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model

    cfg = get_config("llama3.2-1b")
    model = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(99)
    L, Hkv, hd, page, P, B, N = cfg.n_layers, cfg.n_kv_heads, cfg.hd, 64, 8, \
        16, 1 + 16 * 8
    shape = (L, N, page, Hkv, hd)
    # pool K/V at the scale the model's own projections give (|k| ~ 1)
    kp = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    vp = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    tables = (torch.randperm(N - 1, generator=gen, device="cuda")[:B * P]
              + 1).reshape(B, P).to(torch.int32)
    lengths = torch.randint(1, P * page - 1, (B,), generator=gen,
                            device="cuda").to(torch.int32)
    lengths[3] = 0
    tables[3] = 0
    tokens = torch.randint(0, cfg.vocab_size, (B,), generator=gen,
                           device="cuda").to(torch.int32)
    rows = torch.arange(B, device="cuda")
    new_page, new_off = tables[rows, (lengths // page).long()].long(), \
        (lengths % page).long()
    C = 64
    chunk_state = {"k_pages": kp, "v_pages": vp,
                   "block_table": tables[0:1].contiguous()}
    ctoks = torch.randint(0, cfg.vocab_size, (1, C), generator=gen,
                          device="cuda").to(torch.int32)
    off = torch.tensor([int(lengths[0]) // 2], dtype=torch.int32,
                       device="cuda")
    pos = list(range(int(off), int(off) + 20)) + \
        list(range(int(off) + 84, int(off) + 120))
    cpos = torch.tensor([pos + [-1] * (C - len(pos))], dtype=torch.int32,
                        device="cuda")

    def run(be):
        state = {"k_pages": kp.clone(), "v_pages": vp.clone(),
                 "block_tables": tables, "lengths": lengths}
        logits, new = model.decode_step_paged(params, state, tokens,
                                              backend=be)
        out = {"decode_logits": logits,
               "decode_new_k": new["k_pages"][:, new_page, new_off],
               "decode_new_v": new["v_pages"][:, new_page, new_off]}
        for name, fn, arg in (("prefill_chunk", model.prefill_chunk, off),
                              ("prefill_chunk_seg", model.prefill_chunk_seg,
                               cpos)):
            kv = fn(params, chunk_state, ctoks, arg, backend=be)
            out[name + "_k"], out[name + "_v"] = kv["k"], kv["v"]
        return out

    runs = {"cuda": run("cuda"), "torch": run("torch")}
    with one_token_mask_errors(torch):
        runs["mutant"] = run("torch")
    res = {}
    for key, plain in runs["torch"].items():
        def gap(other):
            return float((runs[other][key].float() - plain.float())
                         .abs().max())
        scale = float(plain.float().abs().max())
        res[key] = {"max_abs_diff": gap("cuda"), "max_abs": scale,
                    "tol": PARITY_RTOL * scale,
                    "mutant_max_abs_diff": gap("mutant")}
    emit({"phase": "parity", "card": card, "rtol": PARITY_RTOL, **res})
    bad = {k: v for k, v in res.items() if not v["max_abs_diff"] <= v["tol"]}
    if bad:
        raise AssertionError(f"kernels vs plain versions differ: {bad}")
    blind = {k: v for k, v in res.items()
             if not v["mutant_max_abs_diff"] > v["tol"]}
    if blind:
        raise AssertionError(f"parity limit misses a one-token mask "
                             f"error: {blind}")


@contextlib.contextmanager
def one_token_mask_errors(torch):
    """Swap in plain versions that each get one mask wrong, the errors a
    kernel's masking could make: decode attends one pool token past the
    row's length, prefill the pool token at the offset (the slot the
    chunk's first token will fill), segment prefill does not exclude the
    slots the chunk will fill.  The parity limit must see each of them."""
    from repro_torch.kernels import ref
    saved = (ref.paged_decode_attention, ref.paged_prefill_attention,
             ref.paged_prefill_segments)
    decode, prefill, _ = saved

    def decode_past_length(q, k_pages, v_pages, block_tables, lengths):
        t = block_tables.shape[1] * k_pages.shape[1]
        return decode(q, k_pages, v_pages, block_tables,
                      torch.where(lengths < t, lengths + 1, lengths))

    def prefill_at_offset(q, k_chunk, v_chunk, k_pages, v_pages,
                          block_tables, offsets):
        return prefill(q, k_chunk, v_chunk, k_pages, v_pages, block_tables,
                       offsets + 1)

    def segments_own_slots(q, k_chunk, v_chunk, k_pages, v_pages,
                           block_tables, chunk_positions):
        t = block_tables.shape[1] * k_pages.shape[1]
        keypos = torch.arange(t, device=q.device)
        prior = keypos[None, None, :] < chunk_positions.long()[:, :, None]
        return ref._chunk_attend(q, k_chunk, v_chunk, k_pages, v_pages,
                                 block_tables, prior)

    (ref.paged_decode_attention, ref.paged_prefill_attention,
     ref.paged_prefill_segments) = (decode_past_length, prefill_at_offset,
                                    segments_own_slots)
    try:
        yield
    finally:
        (ref.paged_decode_attention, ref.paged_prefill_attention,
         ref.paged_prefill_segments) = saved


REPLACES = {
    "paged_decode": ("src/repro_torch/csrc/paged_decode.cu",
                     "src/repro/kernels/paged_attention.py:92"),
    "paged_prefill": ("src/repro_torch/csrc/paged_prefill.cu",
                      "src/repro/kernels/paged_prefill.py:119"),
    "paged_prefill_seg": ("src/repro_torch/csrc/paged_prefill.cu",
                          "src/repro/kernels/paged_prefill.py:295"),
}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch is missing beside this script",
              file=sys.stderr)
        return 3
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.paged_attention import paged_decode_attention
    from repro_torch.kernels.paged_prefill import (paged_prefill_attention,
                                                   paged_prefill_segments)
    kernel_fns = {"paged_decode": paged_decode_attention,
                  "paged_prefill": paged_prefill_attention,
                  "paged_prefill_seg": paged_prefill_segments}

    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "torch_name": kind,
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    phase_build(build, smi)
    rows = phase_kernels(torch, ops, smi)
    params, launches = phase_serve(torch, kernel_fns, smi)
    phase_parity(torch, params, smi)

    summary = []
    for name, row in rows.items():
        source, replaces = REPLACES[name]
        summary.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                        "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"]})
    emit({"kernels": summary})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
