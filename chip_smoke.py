#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit; imports nothing of JAX.
Phases, each printed as one JSON object on its own line; any failed
check raises and the script exits non-zero with no result line:

  device   the card's name and power limit (nvidia-smi) and torch's name;
  build    nvcc build of every kernel source (one nvcc per source, in
           parallel) with the compiler's register and spill report and,
           per compiled entry, its tensor-core instructions (HMMA /
           HGMMA) counted in ``cuobjdump -sass`` of the built library;
           the tensor-core bodies of flash prefill, of both MLA chunk
           prefill entries, of the MLA split decode, of the GQA decode
           bandwidth body, of the int8 decode and of both GQA chunk
           prefill entries must hold some;
  kernels  each GQA kernel at the serving path's shapes (llama3.2-1b:
           Hq=32, Hkv=8, hd=64, page=64, C=64, bf16 pools, ragged
           lengths up to 512 with inactive rows; the decode also with
           every row at 512, ``paged_decode_full``; the chunk prefill at
           offset 320 and at the window's last chunk, offset 448,
           ``paged_prefill_long``) against its plain
           PyTorch version on the same inputs, timed with CUDA events
           over a window of launches queued ahead of the device (L2
           flushed before each launch, the flushes' own time taken
           off), beside the least time the card could take for the
           same work, and the body the C entry ran for the case
           (``body``: "tensor_core" or "cuda_core");
  mla_kernels  the same for the three absorbed-MLA kernels at the MLA
           path's shapes (DeepSeek-V3: Hq=128, dl=512, dr=64, page=64,
           C=64, a 1857-page bf16 latent pool, 56 rows with lengths up
           to 2048), plus the decode on 8 rows of full 2048-token tables
           (``mla_paged_decode_long``); the decode rows carry the split
           plan (tokens a split, splits, blocks, partial bytes), the GQA
           decode and chunk prefill rows their one-wave plans (blocks,
           warp splits merged inside the block, no partials);
  serve    the engine at full llama3.2-1b width (seeded random bf16
           weights, default EngineConfig) serving shared-prefix and
           segment-reuse traffic, 16 new tokens per request, with every
           kernel's launch count zeroed just before and read just after;
  parity   one decode step, one prefill chunk and one segment chunk of
           the full-width model with the CUDA kernels and then with the
           plain versions (explicit backend="torch") on the same weights
           and state, and with plain versions that each get one mask
           wrong by one token, which the limit must catch;
  mla_serve, mla_parity  the same two for DeepSeek-V3 at every
           published width with the depth cut to 8 layers
           (EngineConfig(max_len=2048), 512-token blocks);
  kernels  (continued) causal flash prefill at llama3.2-1b width (B=1,
           S=384 and the ragged S=416) beside
           F.scaled_dot_product_attention as the library yardstick, and
           int8 paged decode over 64 slots of 512 tokens seen as 64-token
           pages and over the int8_decode path's 4 slots at its eighth
           step (``paged_decode_int8_path``, also timed with a float32
           query on the CUDA-core body, ``cuda_core_ms``), each against
           its plain version and timed as above;
  dense_serve  the serve traffic on EngineConfig(paged=False): the dense
           slot cache, monolithic prefill (flash prefill for a prompt
           with no prefix hit) and decode through the paged decode
           kernel over the slots seen as pages;
  monolithic_serve  the same traffic on the paged pool with
           chunked_prefill=False and fused_step=False;
  int8_decode  build_model(kv_dtype="int8"): bf16 prefills of four
           prompts, their K/V quantized into the int8 slot state, then
           16 decode steps through the int8 kernel;
  dense_parity  one prefill and one bf16 and one int8 decode step of the
           full-width model with the kernels, the plain versions and
           one-token mask-error versions (slots past each row's length
           hold 8x larger K/V).

Then the ``{"kernels": [...]}`` summary, the card's nvidia-smi line, and
last ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
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
# The library yardstick (F.scaled_dot_product_attention) is a fused
# kernel that may keep its probabilities in bf16 for the product with V,
# so it may sit more than one output step from the float32 plain version
# (its gap reads 2^-6 on an H100); the check only guards against timing
# another function (a wrong mask moves outputs by O(1)).
LIBRARY_ATOL = 2.0 ** -4
# Full model, kernels vs plain versions (parity phase): logits and K/V
# are held to 2^-4 of the tensor's largest magnitude.  On an H100 the
# kernels' gap reads at most 2^-5.3 of it (bf16 rounding carried through
# 16 layers), and plain versions with a one-token mask error move the
# same tensors by at least 2^-1.3 of it; the phase checks both sides.
PARITY_RTOL = 2.0 ** -4
# DeepSeek-V3 at every published width; 61 layers of bf16 weights
# (88.6 GB) do not fit one 80 GB card, 8 layers (13.2 GB) do.
MLA_LAYERS = 8
MLA_MAX_LEN = 2048
# the MLA engine's pool at that depth (1 GiB KV budget, 64-token pages):
# 56 slots of 32 pages, 1857 pages with the scratch page and headroom
MLA_ROWS, MLA_TABLE_PAGES, MLA_POOL_PAGES = 56, 32, 1857
# Full MLA model (8 layers), kernels vs plain versions: logits and latents
# are held to 2^-4 of the tensor's largest magnitude.  On an H100 the
# kernels' gap reads at most 2^-5.79 of it, and plain versions with a
# one-token mask error over stale slots move the same tensors by at
# least 2^0.40 of it; the phase checks both sides.
MLA_PARITY_RTOL = 2.0 ** -4
# pool slots no correct mask reads (past a row's length, at or past a
# chunk's offset, a segment chunk's own slots) hold stale latents this
# many times larger, as unwritten slots of a live pool hold whatever
# another request left there; a one-token mask error then reads them
STALE_SCALE = 8.0


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


def sass_tensor_core_counts(build, name) -> dict:
    """Compiled entry -> its tensor-core instructions (HMMA / HGMMA) in
    ``cuobjdump -sass`` of the built library of ``csrc/<name>.cu``."""
    tool = Path(build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(build.lib_path(name))],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    counts, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1)
            counts[cur] = 0
        elif cur is not None and re.search(r"\bH(G)?MMA\b", line):
            counts[cur] += 1
    return counts


# entries that must run on the tensor cores: (source, entry name part,
# how many such entries)
TENSOR_CORE_ENTRIES = (("flash_prefill", "flash_prefill_tc", 4),
                       ("mla_paged_prefill", "mla_tc_kernelILi0E", 2),
                       ("mla_paged_prefill", "mla_tc_kernelILi1E", 2),
                       ("mla_paged_decode", "mla_tc_kernelILi2E", 2),
                       ("paged_decode", "paged_decode_tc", 4),
                       ("paged_decode", "paged_decode_int8_tc", 4),
                       ("paged_prefill", "paged_prefill_tcILb0E", 4),
                       ("paged_prefill", "paged_prefill_tcILb1E", 4))


def phase_build(build, card):
    t0 = time.perf_counter()
    log = build.build_all()
    wall = time.perf_counter() - t0
    report = {}
    for name, entry in log.items():
        sass = sass_tensor_core_counts(build, name)
        entries = {e["entry"]: e for e in ptxas_report(entry["ptxas"])}
        for fn, n in sass.items():
            entries.setdefault(fn, {"entry": fn})["tensor_core_sass"] = n
        report[name] = {"nvcc_s": entry["seconds"],
                        "entries": list(entries.values())}
    emit({"phase": "build", "card": card, "wall_s": wall,
          "sources": report})
    for name, part, want in TENSOR_CORE_ENTRIES:
        found = [e for e in report[name]["entries"] if part in e["entry"]]
        if len(found) != want or not all(e.get("tensor_core_sass", 0) > 0
                                         for e in found):
            raise AssertionError(f"build: {name} entries {part}: {found} "
                                 f"(want {want}, each with HMMA / HGMMA)")


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


def kernel_body(name, a) -> str:
    """The body the C entry runs for case ``name`` on inputs ``a``, as
    its dispatch by type and width decides: "tensor_core" or
    "cuda_core"."""
    from repro_torch.kernels import build
    from repro_torch.kernels import mla_paged_decode as mpd
    from repro_torch.kernels.paged_attention import DTYPE_CODES
    tc = 0
    if name.startswith("paged_decode_int8"):
        fn = build.entry("paged_decode", "paged_decode_int8_tensor_core",
                         [ctypes.c_int] * 4)
        q = a["q"]
        tc = fn(q.shape[-2], a["k_pages"].shape[2], q.shape[-1],
                DTYPE_CODES[q.dtype])
    elif name.startswith(("paged_decode", "paged_prefill")):
        src = ("paged_decode" if name.startswith("paged_decode")
               else "paged_prefill")
        fn = build.entry(src, f"{src}_tensor_core", [ctypes.c_int] * 5)
        q, kp = a["q"], a["k_pages"]
        tc = fn(q.shape[-2], kp.shape[2], q.shape[-1], DTYPE_CODES[q.dtype],
                DTYPE_CODES[kp.dtype])
    elif name.startswith("mla_paged_decode"):
        tc = mpd.tensor_core(a["q_lat"].shape[-1], a["q_rope"].shape[-1],
                             DTYPE_CODES[a["q_lat"].dtype],
                             DTYPE_CODES[a["latent_pages"].dtype])
    elif name.startswith("flash_prefill"):
        fn = build.entry("flash_prefill", "flash_prefill_tensor_core",
                         [ctypes.c_int] * 2)
        tc = fn(a["q"].shape[-1], DTYPE_CODES[a["q"].dtype])
    elif name.startswith("mla_paged_prefill"):
        fn = build.entry("mla_paged_prefill", "mla_paged_prefill_tensor_core",
                         [ctypes.c_int] * 5)
        q_lat = a["q_lat"]
        n_cp = q_lat.shape[1] if "chunk_positions" in a else 0
        tc = fn(q_lat.shape[-1], a["q_rope"].shape[-1], n_cp,
                DTYPE_CODES[q_lat.dtype], DTYPE_CODES[a["latent_pages"].dtype])
    return "tensor_core" if tc else "cuda_core"


def check_and_time(torch, cases, card, phase):
    """Each case against its plain version (``backend="torch"``), then
    both timed, and the library call that computes the same function
    where one exists (``library``: a callable on the same inputs, held to
    the plain version too); one JSON line per kernel, with the body the
    kernel ran and its achieved TFLOP/s."""
    rows = {}
    for case in cases:
        name, fn, args, (nbytes, flops) = case[:4]
        library = case[4] if len(case) > 4 else None
        extra = case[5] if len(case) > 5 else {}
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
        rows[name] = {"body": kernel_body(name, args),
                      "max_abs_err": err, "tol": KERNEL_ATOL,
                      "ms": kt["ms"], "plain_ms": pt["ms"],
                      "flush_ms": kt["flush_ms"], "bound_ms": bound_ms,
                      "bound_by": bound_by, "bytes": nbytes,
                      "flops": flops, "tflops": flops / kt["ms"] / 1e9,
                      "library_ms": None, **extra}
        if library is not None:
            lib_err = float((library().float() - plain.float()).abs().max())
            if not lib_err <= LIBRARY_ATOL:
                raise AssertionError(f"{name}: the library yardstick differs "
                                     f"from the plain version by {lib_err}")
            rows[name]["library_ms"] = time_ms(torch, library)["ms"]
            rows[name]["library_max_abs_err"] = lib_err
        emit({"phase": phase, "card": card, "kernel": name, **rows[name]})
    return rows


def seg_counts(cpos):
    """(pool tokens read, attended (query, key) pairs) of one segment
    chunk: each query attends the pool below its position except the
    chunk's own slots, plus chunk keys j <= i (padding included)."""
    C = len(cpos)
    valid = [p for p in cpos if p >= 0]
    own = set(valid)
    pool = {t for p in valid for t in range(p) if t not in own}
    pairs = sum(len([t for t in range(p) if t not in own])
                for p in valid) + C * (C + 1) // 2
    return len(pool), pairs


def prefill_plan(a) -> dict:
    """The GQA chunk prefill's plan on inputs ``a`` (tensor-core body):
    one block per (16 / G queries, KV head, row), its key walk dealt to
    four warps (16 keys of every 64-key tile each) and merged inside the
    block, so no partial leaves it."""
    B, C, Hq, _ = a["q"].shape
    Hkv = a["k_pages"].shape[2]
    qb = 16 // (Hq // Hkv)
    return {"splits": 1, "warp_splits": 4, "queries_a_block": qb,
            "blocks": B * Hkv * -(-C // qb), "partial_bytes": 0}


def phase_kernels(torch, ops, card):
    gen = torch.Generator(device="cuda").manual_seed(1234)
    dec, pre, seg = make_kernel_inputs(torch, gen)
    C = pre["q"].shape[1]
    off = int(pre["offsets"][0])
    seg_pool, seg_pairs = seg_counts(
        [int(x) for x in seg["chunk_positions"][0]])
    # the window's last chunk: the longest pool walk on the serve path
    long_off = pre["block_tables"].shape[1] * pre["k_pages"].shape[1] - C
    pre_long = dict(pre, offsets=torch.full_like(pre["offsets"], long_off))
    B, Hkv = dec["q"].shape[0], dec["k_pages"].shape[2]
    # the bandwidth body walks a row in one block per (row, KV head)
    plan = {"splits": 1, "blocks": B * Hkv, "partial_bytes": 0}
    # every row at the full 512-token table: the bytes of a batch with no
    # short row, where the longest row no longer sets the time
    full = dict(dec, lengths=torch.full_like(dec["lengths"],
                                             dec["block_tables"].shape[1]
                                             * dec["k_pages"].shape[1]))
    cases = [
        ("paged_decode", ops.paged_decode, dec, decode_cost(dec), None,
         plan),
        ("paged_decode_full", ops.paged_decode, full, decode_cost(full),
         None, plan),
        ("paged_prefill", ops.paged_prefill, pre,
         prefill_cost(pre, off, C * off + C * (C + 1) // 2), None,
         prefill_plan(pre)),
        ("paged_prefill_long", ops.paged_prefill, pre_long,
         prefill_cost(pre_long, long_off,
                      C * long_off + C * (C + 1) // 2), None,
         prefill_plan(pre_long)),
        ("paged_prefill_seg", ops.paged_prefill_seg, seg,
         prefill_cost(seg, seg_pool, seg_pairs), None, prefill_plan(seg)),
    ]
    rows = check_and_time(torch, cases, card, "kernels")
    check_contiguous(torch, ops.paged_prefill_seg, ops.paged_prefill, pre,
                     C, "kernels")
    return rows


def check_contiguous(torch, seg_op, offset_op, pre, C, phase):
    """With contiguous positions the segment kernel equals the offset
    kernel bit for bit."""
    off = int(pre["offsets"][0])
    a = dict(pre)
    a.pop("offsets")
    a["chunk_positions"] = torch.arange(off, off + C, dtype=torch.int32,
                                        device="cuda")[None]
    same = torch.equal(seg_op(**a, backend="cuda"),
                       offset_op(**pre, backend="cuda"))
    if not same:
        raise AssertionError(f"{phase}: segment kernel with contiguous "
                             f"positions differs from the offset kernel")
    emit({"phase": phase, "contiguous_seg_equals_offset": same})


# ---------------------------------------------------------------------------
# the MLA path
# ---------------------------------------------------------------------------
def mla_config():
    """DeepSeek-V3 at every published width, depth cut 61 -> 8 layers."""
    from repro_torch.configs.paper_models import DEEPSEEK_V3
    return dataclasses.replace(DEEPSEEK_V3, n_layers=MLA_LAYERS)


def make_mla_kernel_inputs(torch, gen, cfg):
    """MLA path shapes: 56 decode rows (every 7th inactive, one full
    2048-token table, the rest up to 1600 tokens) over the engine's
    1857-page latent pool; one prefill chunk of 64 at offset 1024; one
    segment chunk spanning two gaps (positions 480-511, then 1536-1567,
    the slots between resumed)."""
    B, P, N = MLA_ROWS, MLA_TABLE_PAGES, MLA_POOL_PAGES
    Hq, dl, dr, page, C = cfg.n_heads, cfg.d_latent, cfg.d_rope, 64, 64
    dev = "cuda"

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    lat = randn(N, page, dl + dr)
    perm = torch.randperm(N - 1, generator=gen, device=dev)[:B * P] + 1
    tables = perm.reshape(B, P).to(torch.int32)
    lengths = torch.randint(1, 1601, (B,), generator=gen,
                            device=dev).to(torch.int32)
    lengths[::7] = 0                        # inactive rows
    tables[::7] = 0
    lengths[1] = P * page                   # one full table
    scale = 1.0 / math.sqrt(cfg.hd + dr)    # the engine's scale
    dec = dict(q_lat=randn(B, Hq, dl), q_rope=randn(B, Hq, dr),
               latent_pages=lat, block_tables=tables, lengths=lengths,
               d_latent=dl, scale=scale)
    pre = dict(q_lat=randn(1, C, Hq, dl), q_rope=randn(1, C, Hq, dr),
               lat_chunk=randn(1, C, dl + dr), latent_pages=lat,
               block_tables=tables[1:2].contiguous(),
               offsets=torch.tensor([1024], dtype=torch.int32, device=dev),
               d_latent=dl, scale=scale)
    pos = list(range(480, 512)) + list(range(1536, 1568))
    seg = dict(pre, chunk_positions=torch.tensor(
        [pos], dtype=torch.int32, device=dev))
    seg.pop("offsets")
    return dec, pre, seg


def mla_cost(a, pool_tokens, pairs):
    """Bytes (each input read once, the context written once) and flops
    of one MLA call: per attended (query, key) pair, Hq * (2*dk + 2*dl)
    flops (scores over dl + dr, then the context over dl)."""
    q_lat, q_rope, lat = a["q_lat"], a["q_rope"], a["latent_pages"]
    Hq, dl = q_lat.shape[-2:]
    dk = dl + q_rope.shape[-1]
    eq = q_lat.element_size()
    ints = a.get("lengths", a.get("offsets", a.get("chunk_positions")))
    nbytes = ((2 * q_lat.numel() + q_rope.numel()) * eq
              + pool_tokens * dk * lat.element_size()
              + (a["lat_chunk"].numel() * eq if "lat_chunk" in a else 0)
              + (a["block_tables"].numel() + ints.numel()) * 4)
    return nbytes, pairs * Hq * (2 * dk + 2 * dl)


def mla_decode_plan(a) -> dict:
    """The tensor-core MLA decode's split plan on inputs ``a``: tokens a
    split, splits of the grid, blocks launched (those past a row's
    length exit at once), blocks that walk keys, and the float32 partial
    bytes written (the combine reads them back once)."""
    from repro_torch.kernels import mla_paged_decode as mpd
    q_lat, lat = a["q_lat"], a["latent_pages"]
    B, Hq, dl = q_lat.shape
    window = a["block_tables"].shape[1] * lat.shape[1]
    split, S = mpd.decode_split_tokens(window), mpd.decode_splits(window)
    groups = -(-Hq // 64)
    used = [max(1, -(-min(max(int(n), 0), window) // split))
            for n in a["lengths"].tolist()]
    return {"split_tokens": split, "splits": S, "blocks": groups * S * B,
            "blocks_walking": groups * sum(used),
            "partial_bytes": sum(n for n in used if n > 1)
            * Hq * (dl + 2) * 4}


def phase_mla_kernels(torch, ops, card, cfg):
    gen = torch.Generator(device="cuda").manual_seed(4321)
    dec, pre, seg = make_mla_kernel_inputs(torch, gen, cfg)
    window = dec["block_tables"].shape[1] * dec["latent_pages"].shape[1]
    dec_tokens = int(dec["lengths"].clamp(0, window).sum())
    C = pre["q_lat"].shape[1]
    off = int(pre["offsets"][0])
    seg_pool, seg_pairs = seg_counts(
        [int(x) for x in seg["chunk_positions"][0]])
    # the small batch of long rows the split exists for: 8 rows, each a
    # full 2048-token table of its own pages
    B8, P = 8, dec["block_tables"].shape[1]
    lat = dec["latent_pages"]
    perm = torch.randperm(lat.shape[0] - 1, generator=gen,
                          device="cuda")[:B8 * P] + 1
    Hq, dl = dec["q_lat"].shape[1:]
    dr = dec["q_rope"].shape[-1]
    long = dict(dec, q_lat=torch.randn((B8, Hq, dl), generator=gen,
                                       device="cuda").to(torch.bfloat16),
                q_rope=torch.randn((B8, Hq, dr), generator=gen,
                                   device="cuda").to(torch.bfloat16),
                block_tables=perm.reshape(B8, P).to(torch.int32),
                lengths=torch.full((B8,), window, dtype=torch.int32,
                                   device="cuda"))
    cases = [
        ("mla_paged_decode", ops.mla_decode, dec,
         mla_cost(dec, dec_tokens, dec_tokens), None, mla_decode_plan(dec)),
        ("mla_paged_decode_long", ops.mla_decode, long,
         mla_cost(long, B8 * window, B8 * window), None,
         mla_decode_plan(long)),
        ("mla_paged_prefill", ops.mla_prefill, pre,
         mla_cost(pre, off, C * off + C * (C + 1) // 2)),
        ("mla_paged_prefill_seg", ops.mla_prefill_seg, seg,
         mla_cost(seg, seg_pool, seg_pairs)),
    ]
    rows = check_and_time(torch, cases, card, "mla_kernels")
    check_contiguous(torch, ops.mla_prefill_seg, ops.mla_prefill, pre, C,
                     "mla_kernels")
    return rows


# ---------------------------------------------------------------------------
# the dense layout: causal flash prefill and int8 decode over slot pages
# ---------------------------------------------------------------------------
def flash_cost(a):
    """Bytes (q, k, v read once, the output written once) and flops
    (4 * hd per attended (query, key) pair and query head) of one causal
    prefill."""
    q, k = a["q"], a["k"]
    B, S, Hq, hd = q.shape
    el = q.element_size()
    nbytes = (2 * q.numel() + 2 * k.numel()) * el
    return nbytes, 4 * B * (S * (S + 1) // 2) * Hq * hd


def make_int8_decode_inputs(torch, gen, attn, lengths=None):
    """The dense int8 decode's shapes at llama3.2-1b width: 64 slots of
    512 tokens (the default engine's slot count and max_len) quantized
    with the port's quantize_kv and seen as 64-token pages; ragged
    lengths, every 7th row inactive (length 0), one full row.  With
    ``lengths``, one slot a length instead."""
    B, S, Hq, Hkv, hd = 64, 512, 32, 8, 64
    dev = "cuda"
    if lengths is not None:
        B = len(lengths)
    k = torch.randn((B, S, Hkv, hd), generator=gen, device=dev)
    v = torch.randn((B, S, Hkv, hd), generator=gen, device=dev)
    (kq, ks), (vq, vs) = attn.quantize_kv(k), attn.quantize_kv(v)
    (kp, vp, ksp, vsp), tables = attn.slot_pages(kq, vq, ks, vs)
    if lengths is None:
        lengths = torch.randint(1, S + 1, (B,), generator=gen,
                                device=dev).to(torch.int32)
        lengths[::7] = 0
        lengths[1] = S
    else:
        lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return dict(q=torch.randn((B, Hq, hd), generator=gen,
                              device=dev).to(torch.bfloat16),
                k_pages=kp, v_pages=vp, k_scales=ksp, v_scales=vsp,
                block_tables=tables, lengths=lengths)


def int8_decode_cost(a):
    """Each attended token's int8 K and V of every KV head plus their
    bf16 scales, q read and the output written once; flops as bf16
    decode."""
    q, kp, lengths = a["q"], a["k_pages"], a["lengths"]
    B, Hq, hd = q.shape
    Hkv = kp.shape[2]
    toks = int(lengths.clamp_min(0).sum())
    nbytes = (2 * q.numel() * q.element_size()
              + 2 * toks * Hkv * (hd * kp.element_size()
                                  + a["k_scales"].element_size())
              + a["block_tables"].numel() * 4 + B * 4)
    return nbytes, 4 * toks * Hq * hd


def phase_dense_kernels(torch, ops, card):
    import torch.nn.functional as F
    from repro_torch.models import attention as attn
    gen = torch.Generator(device="cuda").manual_seed(5678)
    Hq, Hkv, hd = 32, 8, 64
    cases = []
    # S = 384: the serve traffic's first prompt padded to 32; 416 ends in
    # a ragged 32-row tile of the kernel's 64-row tiles
    for name, S in (("flash_prefill", 384), ("flash_prefill_ragged", 416)):
        a = {"q": torch.randn((1, S, Hq, hd), generator=gen, device="cuda"),
             "k": torch.randn((1, S, Hkv, hd), generator=gen, device="cuda"),
             "v": torch.randn((1, S, Hkv, hd), generator=gen, device="cuda")}
        a = {key: t.to(torch.bfloat16) for key, t in a.items()}
        # the library's [B, H, S, hd] layout of the same values
        qh, kh, vh = (a[key].transpose(1, 2).contiguous()
                      for key in ("q", "k", "v"))

        def sdpa(qh=qh, kh=kh, vh=vh):
            return F.scaled_dot_product_attention(
                qh, kh, vh, is_causal=True, enable_gqa=True).transpose(1, 2)
        cases.append((name, ops.flash_causal, a, flash_cost(a), sdpa))
    dec = make_int8_decode_inputs(torch, gen, attn)
    # the int8_decode path's own shape: its 4 slots at the eighth of its
    # 16 decode steps (prompts of 384 / 256 / 448 / 100 tokens, + 8)
    path = make_int8_decode_inputs(torch, gen, attn,
                                   lengths=INT8_PATH_LENGTHS)
    for name, a in (("paged_decode_int8", dec),
                    ("paged_decode_int8_path", path)):
        # one block per (row, KV head) walks the row; nothing to combine
        plan = {"splits": 1, "blocks": a["q"].shape[0]
                * a["k_pages"].shape[2], "partial_bytes": 0}
        cases.append((name, ops.paged_decode_int8, a, int8_decode_cost(a),
                      None, plan))
    rows = check_and_time(torch, cases, card, "kernels")
    # for the record: the same call with a float32 query, which runs the
    # CUDA-core body
    f32 = dict(path, q=path["q"].float())
    body = kernel_body("paged_decode_int8_path", f32)
    if body != "cuda_core":
        raise AssertionError(f"int8 decode with a float32 query ran {body}")
    cc = time_ms(torch, lambda: ops.paged_decode_int8(**f32, backend="cuda"))
    emit({"phase": "kernels", "card": card,
          "kernel": "paged_decode_int8_path", "cuda_core_ms": cc["ms"]})
    return rows


def phase_serve(torch, kernel_fns, path, card, cfg, ecfg, system_blocks,
                shared_tail, phase="serve", pool=None,
                expect=("cow_share_hits", "segment_chunks")):
    """Serve ``cfg`` on the engine: 6 requests of a shared system prefix
    (``system_blocks`` manager blocks) plus ``shared_tail`` tokens each,
    the first alone, then five; then a segment pair A = [S0 S1 S2 | tail]
    and B = [X0 S1 S2 | tail] of one-block segments.  Every kernel's
    count is zeroed just before the traffic and read just after; each
    kernel of ``path`` must have launched, and each engine counter in
    ``expect`` must be above 0.  ``pool``: the (slots, table pages, pool
    pages) the kernel phase assumed for this engine."""
    from repro_torch.serving import SamplingParams, ServingEngine

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = ServingEngine(cfg, ecfg, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    shape = ((eng.kv.n_slots, eng.kv.pages_per_slot, eng.kv.n_pages)
             if eng.paged else (eng.kv.n_slots, eng.kv.max_len))
    if pool is not None and shape != pool:
        raise AssertionError(f"engine pool {shape} is not the kernel "
                             f"phase's {pool}")
    finite = []

    def checked(decode):
        def checked_decode(*a, **kw):
            logits, state = decode(*a, **kw)
            finite.append(torch.isfinite(logits).all())
            return logits, state
        return checked_decode
    eng.model.decode_step_paged = checked(eng.model.decode_step_paged)
    eng.model.decode_step = checked(eng.model.decode_step)

    rng = torch.Generator().manual_seed(7)

    def toks(n):
        return torch.randint(0, cfg.vocab_size, (n,),
                             generator=rng).tolist()

    bt = eng.manager.block_tokens
    system = toks(system_blocks * bt)
    shared = [system + toks(shared_tail) for _ in range(6)]
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
            prefills = eng.monolithic_prefills
            produced = eng.step()      # ends in a device->host copy
            dt = time.perf_counter() - t
            steps += 1
            # decode-only: no prompt chunk and no admission prefill
            if (produced and eng.last_step_prefill_tokens == 0
                    and eng.monolithic_prefills == prefills):
                decode_s += dt
                decode_tokens += produced
                decode_steps += 1
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t_serve
    launches = {name: fn.launches for name, fn in kernel_fns.items()}
    st = eng.stats()
    eng.shutdown()

    ttft = sorted(r.ttft for r in reqs)
    out = {"phase": phase, "card": card, "model": cfg.name,
           "layers": cfg.n_layers, "d_model": cfg.d_model,
           "paged": st["paged"], "chunked": st["chunked"],
           "fused": st["fused"],
           ("slots_table_pages_pool_pages" if eng.paged
            else "slots_max_len"): shape,
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
           "monolithic_prefills": st["monolithic_prefills"],
           "cow_share_hits": st["cow_share_hits"],
           "inject_hits": st["inject_hits"],
           "segment_chunks": st["segment_chunks"],
           "segment_share_hits": st["segment_share_hits"],
           "kernel_backend": st["kernel_backend"]}
    emit(out)
    bad = [r.request_id for r in reqs if len(r.generated) != 16]
    if bad:
        raise AssertionError(f"requests {bad} did not produce 16 tokens")
    if not all(bool(f) for f in finite):
        raise AssertionError("non-finite logits in a decode step")
    for name in path:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"{phase} path")
    missed = [key for key in expect if st[key] <= 0]
    if missed:
        raise AssertionError(f"serve traffic missed {missed}")
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
    parity_report(runs, PARITY_RTOL, card, "parity")


def parity_report(runs, rtol, card, phase):
    """Hold the kernels' run to the plain versions' within ``rtol`` of
    each tensor's largest magnitude, and check that the mask-error run
    lands outside it."""
    res = {}
    for key, plain in runs["torch"].items():
        def gap(other):
            return float((runs[other][key].float() - plain.float())
                         .abs().max())
        scale = float(plain.float().abs().max())
        res[key] = {"max_abs_diff": gap("cuda"), "max_abs": scale,
                    "tol": rtol * scale,
                    "mutant_max_abs_diff": gap("mutant")}
    emit({"phase": phase, "card": card, "rtol": rtol, **res})
    bad = {k: v for k, v in res.items() if not v["max_abs_diff"] <= v["tol"]}
    if bad:
        raise AssertionError(f"kernels vs plain versions differ: {bad}")
    blind = {k: v for k, v in res.items()
             if not v["mutant_max_abs_diff"] > v["tol"]}
    if blind:
        raise AssertionError(f"parity limit misses a one-token mask "
                             f"error: {blind}")


def stale_slots(torch, pool, tables, first_stale):
    """Scale the latent pool slots at row positions >= ``first_stale[b]``
    of each row's table by STALE_SCALE (in place)."""
    L, N, page, D = pool.shape
    pos = torch.arange(tables.shape[1] * page, device=pool.device)
    pid = tables.long()[:, pos // page]
    slot = pid * page + pos % page                          # [B, T]
    idx = slot[pos[None, :] >= first_stale.long()[:, None]]
    pool.view(L, N * page, D)[:, idx] *= STALE_SCALE


def phase_mla_parity(torch, params, cfg, card):
    """One decode step, one prefill chunk and one segment chunk of the
    8-layer DeepSeek-V3 model with the MLA kernels, with their plain
    versions, and with plain versions that each get one mask wrong by
    one token, on the same weights and latent state."""
    from repro_torch.models.model import build_model

    model = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(98)
    L, D, page, P, B = cfg.n_layers, cfg.d_latent + cfg.d_rope, 64, 24, 8
    N = 1 + B * P

    def pool():
        return torch.randn((L, N, page, D), generator=gen,
                           device="cuda").to(torch.bfloat16)
    tables = (torch.randperm(N - 1, generator=gen, device="cuda")[:B * P]
              + 1).reshape(B, P).to(torch.int32)
    lengths = torch.randint(64, P * page - 1, (B,), generator=gen,
                            device="cuda").to(torch.int32)
    tokens = torch.randint(0, cfg.vocab_size, (B,), generator=gen,
                           device="cuda").to(torch.int32)
    rows = torch.arange(B, device="cuda")
    new_page = tables[rows, (lengths // page).long()].long()
    new_off = (lengths % page).long()
    dec_pool = pool()
    stale_slots(torch, dec_pool, tables, lengths + 1)
    C = 64
    table0 = tables[0:1].contiguous()
    off = int(lengths[0]) // 2
    pos = list(range(off, off + 20)) + list(range(off + 84, off + 120))
    cpos = torch.tensor([pos + [-1] * (C - len(pos))], dtype=torch.int32,
                        device="cuda")
    # the offset chunk sees nothing resident at or past `off`; the
    # segment chunk's resumed span off+20 .. off+83 is resident
    chunk_pool = pool()
    stale_slots(torch, chunk_pool, table0,
                torch.tensor([off], device="cuda"))
    seg_pool = chunk_pool.clone()
    fresh = (torch.arange(off + 20, off + 84, device="cuda"))
    idx = table0.long()[0, fresh // page] * page + fresh % page
    seg_pool.view(L, N * page, D)[:, idx] /= STALE_SCALE
    ctoks = torch.randint(0, cfg.vocab_size, (1, C), generator=gen,
                          device="cuda").to(torch.int32)

    def run(be):
        state = {"latent_pages": dec_pool.clone(), "block_tables": tables,
                 "lengths": lengths}
        logits, new = model.decode_step_paged(params, state, tokens,
                                              backend=be)
        out = {"decode_logits": logits,
               "decode_new_latent": new["latent_pages"][:, new_page,
                                                        new_off]}
        for name, fn, arg, lat in (
                ("prefill_chunk", model.prefill_chunk,
                 torch.tensor([off], dtype=torch.int32, device="cuda"),
                 chunk_pool),
                ("prefill_chunk_seg", model.prefill_chunk_seg, cpos,
                 seg_pool)):
            state = {"latent_pages": lat, "block_table": table0}
            out[name + "_latent"] = fn(params, state, ctoks, arg,
                                       backend=be)["latent"]
        return out

    runs = {"cuda": run("cuda"), "torch": run("torch")}
    with one_token_mask_errors(torch):
        runs["mutant"] = run("torch")
    parity_report(runs, MLA_PARITY_RTOL, card, "mla_parity")


# the int8_decode phase's prompt lengths; its kernel sees each row's
# length plus the decode steps so far (the new token included)
INT8_PROMPTS = (384, 256, 448, 100)
INT8_PATH_LENGTHS = tuple(n + 8 for n in INT8_PROMPTS)


def phase_int8_decode(torch, kernel_fns, params, card, cfg):
    """``build_model(cfg, kv_dtype="int8")``: bf16 prefills of four
    prompts of ragged lengths (the flash prefill kernel), their K/V
    quantized with ``quantize_kv`` into the int8 slot state, then 16
    greedy decode steps through the int8 decode kernel over the slots
    seen as pages.  Every count is zeroed just before and read just
    after; both kernels must have launched."""
    from repro_torch.models import attention as attn
    from repro_torch.models.model import build_model

    model = build_model(cfg, kv_dtype="int8")
    lens, max_len, steps = INT8_PROMPTS, 512, 16
    gen = torch.Generator(device="cuda").manual_seed(21)
    prompts = [torch.randint(0, cfg.vocab_size, (1, n), generator=gen,
                             device="cuda").to(torch.int32) for n in lens]
    for fn in kernel_fns.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = model.init_decode_state(len(lens), max_len, device="cuda")
    first = []
    for b, toks in enumerate(prompts):
        logits, st1 = model.prefill(params, {"tokens": toks})
        n = toks.shape[1]
        for key in ("k", "v"):
            vals, scale = attn.quantize_kv(st1[key][:, 0])
            state[key][:, b, :n] = vals
            state[key + "_scale"][:, b, :n] = scale
        state["lengths"][b] = n
        first.append(logits.argmax(dim=-1))
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    tok = torch.cat(first).to(torch.int32)
    step_s, finite = [], []
    for _ in range(steps):
        t = time.perf_counter()
        logits, state = model.decode_step(params, state, tok)
        tok = logits.argmax(dim=-1).to(torch.int32)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        finite.append(bool(torch.isfinite(logits).all()))
    launches = {name: fn.launches for name, fn in kernel_fns.items()}
    want = [n + steps for n in lens]
    emit({"phase": "int8_decode", "card": card, "model": cfg.name,
          "layers": cfg.n_layers, "rows": len(lens), "prompt_lens": lens,
          "max_len": max_len, "prefill_s": prefill_s,
          "decode_step_ms_median": 1e3 * sorted(step_s)[steps // 2],
          "decode_step_ms_mean": 1e3 * sum(step_s) / steps,
          "launches": launches})
    if not all(finite):
        raise AssertionError("int8_decode: non-finite logits")
    if state["lengths"].tolist() != want:
        raise AssertionError(f"int8_decode: lengths {state['lengths']} "
                             f"!= {want}")
    for name in ("flash_prefill", "paged_decode_int8"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"int8_decode path")
    return launches


def phase_dense_parity(torch, params, cfg, card):
    """One monolithic prefill (S = 416, a ragged tile) and one bf16 and
    one int8 dense decode step of the full-width model with the kernels,
    with their plain versions, and with plain versions that each get one
    mask wrong by one token, on the same weights and slot state; slots
    past each row's new token hold 8x larger K/V."""
    from repro_torch.models import attention as attn
    from repro_torch.models.model import build_model

    gen = torch.Generator(device="cuda").manual_seed(97)
    L, Hkv, hd, B, S = cfg.n_layers, cfg.n_kv_heads, cfg.hd, 16, 512
    lengths = torch.randint(1, S - 1, (B,), generator=gen,
                            device="cuda").to(torch.int32)
    tokens = torch.randint(0, cfg.vocab_size, (B,), generator=gen,
                           device="cuda").to(torch.int32)
    ptoks = torch.randint(0, cfg.vocab_size, (1, 416), generator=gen,
                          device="cuda").to(torch.int32)
    stale = (torch.arange(S, device="cuda")[None, :]
             > lengths.long()[:, None])                       # [B, S]

    def slots():
        x = torch.randn((L, B, S, Hkv, hd), generator=gen, device="cuda")
        x[:, stale] *= STALE_SCALE
        return x
    k, v = slots(), slots()
    dense = {"k": k.bfloat16(), "v": v.bfloat16(), "lengths": lengths}
    (kq, ks), (vq, vs) = attn.quantize_kv(k), attn.quantize_kv(v)
    int8 = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs,
            "lengths": lengths}
    del k, v
    m16, m8 = build_model(cfg), build_model(cfg, kv_dtype="int8")
    rows, at = torch.arange(B, device="cuda"), lengths.long()

    def run(be):
        logits, st = m16.prefill(params, {"tokens": ptoks}, backend=be)
        out = {"prefill_logits": logits, "prefill_k": st["k"],
               "prefill_v": st["v"]}
        logits, new = m16.decode_step(
            params, {key: t.clone() for key, t in dense.items()}, tokens,
            backend=be)
        out.update(decode_logits=logits, decode_new_k=new["k"][:, rows, at],
                   decode_new_v=new["v"][:, rows, at])
        logits, new = m8.decode_step(
            params, {key: t.clone() for key, t in int8.items()}, tokens,
            backend=be)
        out.update(int8_decode_logits=logits,
                   int8_decode_new_k=(new["k"][:, rows, at].float()
                                      * new["k_scale"][:, rows, at].float()))
        return out

    runs = {"cuda": run("cuda"), "torch": run("torch")}
    with one_token_mask_errors(torch):
        runs["mutant"] = run("torch")
    parity_report(runs, PARITY_RTOL, card, "dense_parity")


@contextlib.contextmanager
def one_token_mask_errors(torch):
    """Swap in plain versions that each get one mask wrong, the errors a
    kernel's masking could make: decode attends one pool token past the
    row's length, prefill the pool token at the offset (the slot the
    chunk's first token will fill), segment prefill does not exclude the
    slots the chunk will fill; the same three for the MLA versions; the
    flash prefill admits key i + 1 for query i, and the int8 decode
    attends one pool token past the row's length.  The parity limit must
    see each of them."""
    from repro_torch.kernels import ref
    names = ("paged_decode_attention", "paged_prefill_attention",
             "paged_prefill_segments", "mla_paged_decode",
             "mla_paged_prefill", "mla_paged_prefill_segments",
             "flash_prefill", "paged_decode_attention_int8")
    saved = {n: getattr(ref, n) for n in names}

    def one_more(lengths, t):
        return torch.where(lengths < t, lengths + 1, lengths)

    def decode_past_length(q, k_pages, v_pages, block_tables, lengths):
        t = block_tables.shape[1] * k_pages.shape[1]
        return saved["paged_decode_attention"](
            q, k_pages, v_pages, block_tables, one_more(lengths, t))

    def prefill_at_offset(q, k_chunk, v_chunk, k_pages, v_pages,
                          block_tables, offsets):
        return saved["paged_prefill_attention"](
            q, k_chunk, v_chunk, k_pages, v_pages, block_tables, offsets + 1)

    def own_slots_prior(chunk_positions, t, device):
        keypos = torch.arange(t, device=device)
        return keypos[None, None, :] < chunk_positions.long()[:, :, None]

    def segments_own_slots(q, k_chunk, v_chunk, k_pages, v_pages,
                           block_tables, chunk_positions):
        t = block_tables.shape[1] * k_pages.shape[1]
        return ref._chunk_attend(q, k_chunk, v_chunk, k_pages, v_pages,
                                 block_tables,
                                 own_slots_prior(chunk_positions, t,
                                                 q.device))

    def mla_decode_past_length(q_lat, q_rope, latent_pages, block_tables,
                               lengths, d_latent, scale=None):
        t = block_tables.shape[1] * latent_pages.shape[1]
        return saved["mla_paged_decode"](
            q_lat, q_rope, latent_pages, block_tables, one_more(lengths, t),
            d_latent, scale)

    def mla_prefill_at_offset(q_lat, q_rope, lat_chunk, latent_pages,
                              block_tables, offsets, d_latent, scale=None):
        return saved["mla_paged_prefill"](
            q_lat, q_rope, lat_chunk, latent_pages, block_tables,
            offsets + 1, d_latent, scale)

    def mla_segments_own_slots(q_lat, q_rope, lat_chunk, latent_pages,
                               block_tables, chunk_positions, d_latent,
                               scale=None):
        t = block_tables.shape[1] * latent_pages.shape[1]
        return ref._mla_chunk_attend(
            q_lat, q_rope, lat_chunk, latent_pages, block_tables,
            own_slots_prior(chunk_positions, t, q_lat.device), d_latent,
            scale)

    def flash_one_ahead(q, k, v):
        b, s = q.shape[:2]
        mask = ref.causal_mask(s, s, 1, q.device).expand(b, s, s)
        return ref._attend(q, k, v, mask)

    def int8_decode_past_length(q, k_pages, v_pages, k_scales, v_scales,
                                block_tables, lengths):
        t = block_tables.shape[1] * k_pages.shape[1]
        return saved["paged_decode_attention_int8"](
            q, k_pages, v_pages, k_scales, v_scales, block_tables,
            one_more(lengths, t))

    mutants = (decode_past_length, prefill_at_offset, segments_own_slots,
               mla_decode_past_length, mla_prefill_at_offset,
               mla_segments_own_slots, flash_one_ahead,
               int8_decode_past_length)
    for n, fn in zip(names, mutants):
        setattr(ref, n, fn)
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(ref, n, fn)


REPLACES = {
    "paged_decode": ("src/repro_torch/csrc/paged_decode.cu",
                     "src/repro/kernels/paged_attention.py:92"),
    "paged_prefill": ("src/repro_torch/csrc/paged_prefill.cu",
                      "src/repro/kernels/paged_prefill.py:119"),
    "paged_prefill_seg": ("src/repro_torch/csrc/paged_prefill.cu",
                          "src/repro/kernels/paged_prefill.py:295"),
    "mla_paged_decode": ("src/repro_torch/csrc/mla_paged_decode.cu",
                         "src/repro/kernels/mla_paged_decode.py:67"),
    "mla_paged_prefill": ("src/repro_torch/csrc/mla_paged_prefill.cu",
                          "src/repro/kernels/paged_prefill.py:416"),
    "mla_paged_prefill_seg": ("src/repro_torch/csrc/mla_paged_prefill.cu",
                              "src/repro/kernels/paged_prefill.py:523"),
    "flash_prefill": ("src/repro_torch/csrc/flash_prefill.cu",
                      "src/repro/kernels/flash_prefill.py:65"),
    "paged_decode_int8": ("src/repro_torch/csrc/paged_decode.cu",
                          "src/repro/kernels/paged_attention.py:195"),
}
GQA_PATH = ("paged_decode", "paged_prefill", "paged_prefill_seg")
MLA_PATH = ("mla_paged_decode", "mla_paged_prefill", "mla_paged_prefill_seg")
# the dense and monolithic paths: flash prefill for a prompt with no
# prefix hit, the paged decode kernel over slots or pages
DENSE_PATH = ("flash_prefill", "paged_decode")


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
    from repro_torch.configs import get_config
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.flash_prefill import flash_prefill
    from repro_torch.kernels.mla_paged_decode import mla_paged_decode
    from repro_torch.kernels.paged_attention import (
        paged_decode_attention, paged_decode_attention_int8)
    from repro_torch.kernels.paged_prefill import (mla_paged_prefill,
                                                   mla_paged_prefill_segments,
                                                   paged_prefill_attention,
                                                   paged_prefill_segments)
    from repro_torch.serving import EngineConfig
    kernel_fns = {"paged_decode": paged_decode_attention,
                  "paged_prefill": paged_prefill_attention,
                  "paged_prefill_seg": paged_prefill_segments,
                  "mla_paged_decode": mla_paged_decode,
                  "mla_paged_prefill": mla_paged_prefill,
                  "mla_paged_prefill_seg": mla_paged_prefill_segments,
                  "flash_prefill": flash_prefill,
                  "paged_decode_int8": paged_decode_attention_int8}

    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "torch_name": kind,
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    phase_build(build, smi)
    mla_cfg = mla_config()
    rows = phase_kernels(torch, ops, smi)
    rows.update(phase_mla_kernels(torch, ops, smi, mla_cfg))
    rows.update(phase_dense_kernels(torch, ops, smi))

    # each path is driven with every count zeroed just before it; a
    # kernel's launches are those of its own path
    params, counts = phase_serve(torch, kernel_fns, GQA_PATH, smi,
                                 get_config("llama3.2-1b"), EngineConfig(),
                                 system_blocks=2, shared_tail=128)
    launches = {name: counts[name] for name in GQA_PATH}
    phase_parity(torch, params, smi)
    del params
    torch.cuda.empty_cache()
    params, counts = phase_serve(
        torch, kernel_fns, MLA_PATH, smi, mla_cfg,
        EngineConfig(max_len=MLA_MAX_LEN), system_blocks=1, shared_tail=588,
        phase="mla_serve",
        pool=(MLA_ROWS, MLA_TABLE_PAGES, MLA_POOL_PAGES))
    launches.update({name: counts[name] for name in MLA_PATH})
    phase_mla_parity(torch, params, mla_cfg, smi)
    del params
    torch.cuda.empty_cache()

    llama = get_config("llama3.2-1b")
    params, counts = phase_serve(torch, kernel_fns, DENSE_PATH, smi, llama,
                                 EngineConfig(paged=False), system_blocks=2,
                                 shared_tail=128, phase="dense_serve",
                                 expect=("inject_hits",
                                         "monolithic_prefills"))
    launches["flash_prefill"] = counts["flash_prefill"]
    phase_serve(torch, kernel_fns, DENSE_PATH, smi, llama,
                EngineConfig(chunked_prefill=False, fused_step=False),
                system_blocks=2, shared_tail=128, phase="monolithic_serve",
                expect=("cow_share_hits", "monolithic_prefills"))
    counts = phase_int8_decode(torch, kernel_fns, params, smi, llama)
    launches["paged_decode_int8"] = counts["paged_decode_int8"]
    phase_dense_parity(torch, params, llama, smi)

    summary = []
    for name, row in rows.items():
        if name not in REPLACES:
            continue               # a second shape of a listed kernel
        source, replaces = REPLACES[name]
        summary.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "body": row["body"],
                        "launches": launches[name],
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
