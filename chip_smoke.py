#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py
    python3 chip_smoke.py --mla-depth-probe LAYERS

Needs one CUDA card and the CUDA toolkit; imports nothing of JAX.
Phases, each printed as one JSON object on its own line; any failed
check raises and the script exits non-zero with no result line:

  device   the card's name and power limit (nvidia-smi) and torch's name;
  build    nvcc build of every kernel source (one nvcc per source, in
           parallel) with the compiler's register and spill report and,
           per compiled entry, its tensor-core instructions (HMMA /
           HGMMA) counted in ``cuobjdump -sass`` of the built library;
           the tensor-core bodies of flash prefill and of its backward
           (dK/dV and dQ), of both MLA chunk prefill entries, of the MLA
           split decode, of the GQA decode's bandwidth and Hopper bodies
           (``paged_decode_tc``, ``paged_decode_wg``: `mma.sync`), of the
           int8 decode and of both GQA chunk prefill entries must hold
           some, and the warp-specialised flash bodies
           (``flash_prefill_wg``, ``bwd_dkdv_wg``, ``bwd_dkdv_pair_wg``,
           ``bwd_dq_wg``), the GQA chunk prefill's Hopper body
           (``paged_prefill_wg``), the MLA decode's
           (``mla_decode_wg``) and the MLA chunk / segment prefill's
           (``mla_prefill_wg``) HGMMA (``wgmma``) ones: none may compile
           to ``mma.sync`` alone;
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
           (``body``: "tensor_core", "cuda_core", or for flash prefill
           and its backward "wgmma", "mma_sync" or "cuda_core", for the
           GQA chunk prefill "wgmma", "tensor_core" or "cuda_core", for
           the GQA decode "hopper", "tensor_core" or "cuda_core", each
           with its split plan: splits, blocks, the blocks that walk
           keys on the case's inputs, the partials' bytes); then the
           three at the trace replay's 32-token pages (``*_page32``: the
           chunk at offset 336, every slot no row may read holding 8x
           larger K/V), and kernels 1-3 there with those slots holding
           inf / NaN (``*_page32_nonfinite``: the output, and the
           decode's log-sum-exp, equal to the clean pool's bit for bit
           and finite); then the three at
           granite-moe-3b-a800m's engine shapes (``*_g3``: Hq 24 over
           Hkv 8, G = 3, hd 64, 32 slots);
  mla_kernels  the same for the three absorbed-MLA kernels at the MLA
           path's shapes (DeepSeek-V3: Hq=128, dl=512, dr=64, page=64,
           C=64, a 1857-page bf16 latent pool, 56 rows with lengths up
           to 2048), plus the decode on 8 rows of full 2048-token tables
           (``mla_paged_decode_long``), the chunk prefill of a whole
           1100-token prompt at offset 0 (``mla_paged_prefill_offset0``,
           the monolithic prefill's call) and the decode over 56 latent
           slots of 2048 tokens seen as pages (``mla_paged_decode_slots``,
           the dense layout's call); every row carries the body
           ("wgmma", "tensor_core" or "cuda_core"), the decode rows the
           split plan (tokens a split, splits, blocks, partial bytes),
           and the offset-0 prefill one F.scaled_dot_product_attention
           call as its library yardstick (``library_backend``);
  serve    the engine at full llama3.2-1b width (seeded random bf16
           weights, default EngineConfig) serving shared-prefix and
           segment-reuse traffic, 16 new tokens per request, with every
           kernel's launch count zeroed just before and read just after,
           and calls 1, 2, 4, 8, ... of kernels 1-6 held to their plain
           versions on the traffic's own inputs (``kernel_checks``; also
           in moe_serve, the three MLA serve phases, replay, replay_full,
           examples and chaos);
  parity   one decode step, one prefill chunk and one segment chunk of
           the full-width model with the CUDA kernels and then with the
           plain versions (explicit backend="torch") on the same weights
           and state, and with plain versions that each get one mask
           wrong by one token, which the limit must catch;
  moe_serve  the serve traffic on granite-moe-3b-a800m at full width
           (40 experts top-8, seeded bf16 weights, default EngineConfig:
           32 slots): kernels 1-3 at G = 3, and the share of the active
           decode rows' (expert, slot) assignments that capacity dropped;
  moe_parity  ``parity`` on that model with its routing pinned to the
           kernels' run (a bf16 step flips top-k choices at near ties),
           then layer 0's MoE FFN at the decode batch in float32 on the
           card and on the CPU (routing identical, outputs within the
           limit), and the bf16 layer timed beside its weight-read bound
           (``moe_layer``);
  mla_serve, mla_parity  the same two for DeepSeek-V3 at every
           published width with the depth cut to 8 layers
           (EngineConfig(max_len=2048), 512-token blocks);
  mla_dense_serve, mla_monolithic_serve  the mla_serve traffic on the
           same weights with EngineConfig(paged=False) (latent slots,
           kernel 5 at offset 0 for a whole prompt, kernel 4 over the
           slots seen as pages) and with chunked_prefill=False,
           fused_step=False (the paged pool, kernel 5 at offset 0);
  mla_dense_parity  one 1100-token monolithic prefill and one dense
           decode step (8 slots of 2048 tokens, 8x stale latents past
           each row) with the kernels, the plain versions and one-token
           mask-error versions;
  kernels  (continued) causal flash prefill at llama3.2-1b width (B=1,
           S=384 and the ragged S=416) beside
           F.scaled_dot_product_attention as the library yardstick, and
           int8 paged decode over 64 slots of 512 tokens seen as 64-token
           pages and over the int8_decode path's 4 slots at its eighth
           step (``paged_decode_int8_path``, also timed with a float32
           query on the CUDA-core body, ``cuda_core_ms``), each against
           its plain version and timed as above on the Hopper body (and
           each with int8 +-127 values and inf / NaN scales in every slot
           no row reads: output and log-sum-exp bit for bit, finite,
           ``*_nonfinite``); then flash prefill at
           the cross-attention families' self layers (llama-3.2-vision:
           32 / 8 heads, hd 128, S 512 and the ragged 100; whisper-tiny:
           6 / 6 heads, hd 64, G 1, S 128) beside the same library call,
           and the paged decode over the vlm_generate and encdec_generate
           phases' slots at their middle step (``*_vlm``, ``*_whisper``);
           flash prefill at zamba2-1.2b's shared attention (32 / 32
           heads, hd 64, G 1, S 512) and the paged decode over the
           hybrid_generate phase's 4 slots of 1024 (``*_zamba2``);
  dense_serve  the serve traffic on EngineConfig(paged=False): the dense
           slot cache, monolithic prefill (flash prefill for a prompt
           with no prefix hit) and decode through the paged decode
           kernel over the slots seen as pages;
  monolithic_serve  the same traffic on the paged pool with
           chunked_prefill=False and fused_step=False;
  int8_decode  build_model(kv_dtype="int8"): bf16 prefills of four
           prompts, their K/V quantized into the int8 slot state, then
           16 decode steps through the int8 kernel, its calls 1, 2, 4,
           8, ... held to the plain version (``checked_kernel_calls``);
  dense_parity  one prefill and one bf16 and one int8 decode step of the
           full-width model with the kernels, the plain versions and
           one-token mask-error versions (slots past each row's length
           hold 8x larger K/V);
  vlm_generate  llama-3.2-vision-11b at full width and depth (40 self
           layers, 8 gated cross blocks, seeded bf16 weights with every
           cross gate at 0.5): four prompts (512 / 384 / 448 / 100
           tokens), each with 1601 seeded patch embeddings, prefilled
           alone (flash prefill) into one 4 x 1024 slot state, then 32
           greedy decode steps (paged decode over the slots seen as
           pages); the state's bytes must equal
           ``sizing.decode_state_bytes`` and zeroing a row's patches must
           move its logits;
  vlm_parity  one 416-token prefill and one decode step of that model
           with the kernels, the plain versions and one-token mask-error
           versions (logits, K/V and the patches' keys and values);
  encdec_generate, encdec_parity  the same two for whisper-tiny at full
           width: eight decoder prompts (4 to 128 tokens) with 1500
           seeded frame embeddings each, 448-token slots, 64 steps; a
           100-token prefill and 8 rows in the parity phase;
  hybrid_generate  zamba2-1.2b at full width and depth (38 Mamba2
           layers, one shared attention block applied 6 times, seeded
           bf16 weights): four prompts (512 / 384 / 200 / 100 tokens)
           prefilled alone into rows of one 4 x 1024 state (K/V slots and
           every Mamba leaf), then 32 greedy steps; flash prefill 24
           launches and paged decode 192, exactly; the state's bytes are
           the port's specs' (the JAX spec's), short of
           ``sizing.decode_state_bytes`` by exactly the conv tap it
           counts and the state does not keep;
  hybrid_parity  one 416-token prefill and one decode step over 4 random
           slot rows (8x stale slots, random Mamba state) with the
           kernels, the plain versions and one-token mask-error versions;
  hybrid_checks  decode against teacher forcing at full width in float32
           (the bar of tests/test_model_consistency.py; the bf16 gap
           printed beside it, not held) and layer 0's ``mamba_block`` in
           float32 on the card against the CPU;
  rwkv_generate, rwkv_checks  the same for rwkv6-1.6b at full width (24
           layers; no kernel: the state equals the sizing formula's
           bytes, no kernel may launch; ``time_mix`` for the mixer);
  every generate phase first checks that earlier phases hold less than
           0.2 GB on the card beside its weights (``held_at_start_gb``);
  kernels  (continued) the flash prefill backward (``flash_prefill_bwd``:
           D, dK/dV and dQ kernels; bf16 on the tensor cores, the dK/dV
           walk split at small batch, float32 on the CUDA cores) against
           its plain version at llama3.2-1b's training micro-step (4 x
           1024, 32 / 8 heads, hd 64; with each kernel's device ms from
           the profiler), the ragged 1000, llama-3.2-vision's 32 / 8 at
           hd 128, whisper-tiny's 6 / 6 and one float32 case, beside the
           backward of F.scaled_dot_product_attention; the forward kernel
           with its log-sum-exp at the micro-step (``flash_prefill_lse``);
           both again at DeepSeek-V3's train_mla micro-step (2 x 1024,
           128 / 128 heads, Q/K 192 over V 128: ``*_mla``; the backward
           also at the ragged 1000 and in float32 at 1 x 256), SDPA on
           the first of its backends that takes V narrower than Q/K
           (``library_backend``);
  flash_long  kernels 7 and 7b where they set the pace on the card:
           kernel 7 with its log-sum-exp at dryrun_card's prefill shape
           (8 x 32768, 32 / 8 heads, hd 64; ``flash_prefill_32k``), and
           kernels 7 and 7b at the train cell's micro-batch (4 x 4096;
           ``flash_prefill_4k``, ``flash_prefill_bwd_4k``); each held on
           the whole to SDPA (on ``sdpa_backend``'s backend) and on a
           slice to the plain version: the last 512 queries of one
           sequence against all its keys through ``ref._attend`` with
           the causal mask at that offset (the output and lse; for the
           backward dQ, by autograd through it); ms, TFLOP/s, bound and
           SDPA ms; the C entries' bodies at every width pair;
  decode_lse  kernels 1 and 8 with their log-sum-exp output (the split
           decode's merge weights) at the kernels phase's paged_decode
           and 64-slot paged_decode_int8 rows, on the bf16 tensor-core
           bodies and with a float32 query on the CUDA-core bodies:
           output and log-sum-exp against the plain versions, -1e30 on
           every row of length 0, and each row's table cut into two
           halves launched with their log-sum-exps and merged by the
           split decode's ``merge_slices`` against the whole-row launch;
           the tensor-core launch timed without and with the output in
           turns (LSE_REPEATS each) beside the bound with its bytes;
  train    llama3.2-1b at full width and depth: 6 AdamW steps of 8 x 1024
           tokens in two micro-steps (``make_train_step``, every layer
           under remat, attention through the flash prefill kernel and
           its backward); per step the loss, host ms, the host's ms
           until the step returned (before its synchronise) and
           tokens/s, the peak memory, one more step under the profiler,
           the median step beside the one measured with the backward's
           CUDA-core body (``CUDA_CORE_BWD_TRAIN``); the loss must be
           finite and fall, and the launches equal 2 x layers x
           micro-steps of kernel 7 and layers x micro-steps of the
           backward a step;
  train_parity  the same step's loss and every gradient leaf at two
           layers with the kernels and with the plain versions on the
           card;
  train_resume  at two layers, 4 steps straight against 2 steps, a
           checkpoint saved and restored under build/, and 2 more: every
           param and AdamW leaf equal bit for bit;
  train_families  one train_loss and backward of zamba2-1.2b (6 layers),
           rwkv6-1.6b (4), whisper-tiny and llama-3.2-vision-11b (10) at
           full width: the loss finite, every gradient present and finite;
  train_mla  the train phase for DeepSeek-V3 at every published width,
           the depth cut to TRAIN_MLA_LAYERS of 61: 4 x 1024 tokens a step
           in two micro-steps, MLA in the non-absorbed form (per-head K
           [c_kv W_uk ; k_rope] 192 wide, V c_kv W_uv 128 wide) through
           kernel 7 and its backward at that width pair; the same checks
           (finite, falling loss, exact launches);
  train_mla_parity  train_parity for DeepSeek-V3 at one layer, 1 x 512
           tokens a micro-step; the attention weights' gradients (wq,
           w_dkv, w_kr, w_uk, w_uv, wo) nonzero;
  train_launch  ``python -m repro_torch.launch.train`` on llama3.2-1b
           at full width and depth (8 x 1024 tokens a step in two
           micro-steps) under a one-rank nccl group (the variables
           torchrun sets, a process of its own): 2 steps with a
           checkpoint each under build/ and ``--crash-at 1`` (exit 17),
           the relaunch resuming, then the same command's ``main`` with
           no group in this process; the two final checkpoints equal
           leaf for leaf (bit for bit); each run's group line, kernel
           launches, step times and save / restore seconds;
  dryrun   ``python -m repro_torch.launch.dryrun`` in four subprocesses
           off the card (meta tensors over a fake 256- or 512-rank
           process group): llama3.2-1b's train_4k, prefill_32k and
           decode_32k on 16x16, rwkv6-1.6b's long_500k on 2x16x16,
           granite-moe-3b-a800m's train_4k with expert parallelism and
           llama3.2-1b's with sequence parallelism; per cell the
           per-device flops, HBM and wire bytes, the bottleneck, the
           step-time bound at the H100's rates, the roofline fraction
           and the estimated peak memory;
  dryrun_card  llama3.2-1b at full width and depth on a (1, 1) mesh:
           each of the three shapes at its cut batch (CARD_BATCH), the
           dry run's estimate, then the entry point on the card through the
           kernels (the train step: kernels 7 and 7b; prefill: 7;
           decode over the dense slots at a full 32k window: 1), side
           by side: estimated and measured peak (within PEAK_BAND),
           step-time bound and measured step, roofline fraction;
  replay   the live-engine trace replay (``traces/serving_replay.py``)
           of the reduced llama3.2-1b at 32-token blocks and pages, four
           cells (lmsys and agentic whole-prefix, sharegpt and lmsys with
           segment reuse; 12 sessions x 6 turns, seed 0, bayesian,
           transfers inline), every counter equal to the CPU run's
           (``REPLAY_PINS``, pinned in tests/test_torch_replay.py);
           calls 1, 2, 4, 8, ... of kernels 1-3 on the path held to their
           plain versions on the same tensors, and every injected block
           read back from the pool bit for bit against its payload;
  replay_full  the same four cells with llama3.2-1b at full width on one
           shared params tree, with the same kernel and inject checks:
           every turn completes with finite logits and in-vocab tokens,
           KV is demoted, fetched back and injected (payload bytes across
           the host link counted), kernels 1-3 launch at 32-token pages;
  cluster  two full-width replicas on the lmsys replay under round-robin
           routing with the fleet-shared tier 4 and the async transfer
           worker, one replica failed mid-replay: shared-tier imports
           (read back bit for bit), every turn completes on the survivor,
           the device memory falls by at least the failed replica's KV
           pool; then the serve CLI (``repro_torch.launch.serve``) with
           two replicas and a failure;
  frontend the wall-clock ``ServingFrontend`` over the full-width replay
           engine under a 5-second open-loop lmsys load, its pump thread
           stepping the card on that thread's default stream; the ledger
           must balance;
  examples the README's examples on the port (``examples/torch_*.py``):
           the three serving examples on the card and on the CPU in this
           process, on the same seeded weights, every printed line equal
           but the device line; again at full width (``--full-width``),
           every engine run finished and the completion and prefix-hit
           counts the reduced runs', with wall seconds and peak memory;
           the train demo (reduced llama3.2-1b, 200 steps, every run
           resumed from one step-0 checkpoint of the card's weights) on
           the card and on the CPU, its lines equal once wall-clock
           readings are masked and its losses and gradient norms within
           DEMO_LOSS_RTOL; cut at step 100 (exit 17) and relaunched, its
           final checkpoint equal to the straight run's leaf for leaf;
           the replay example at 2 sessions x 2 turns;
  chaos    ``scripts/torch_replay_smoke.py``'s chaos replay on the card
           (transient read / write errors and payload corruption on
           tiers 1-5): no request hung, a retry absorbed, every injected
           corruption caught by its crc32 check, every counter equal to
           the CPU run's (``CHAOS_PINS``, pinned in
           tests/test_torch_examples.py); kernels 1-3's launches.

Then the ``{"kernels": [...]}`` summary, the card's nvidia-smi line, and
last ``{"ok": true, "device": {...}}``.

``--mla-depth-probe LAYERS`` runs none of this: two steps of the
train_mla step at LAYERS layers, and one JSON line with the parameter
count and either the peak memory or the out-of-memory error with the
bytes allocated when it struck (``probe_mla_depth``; one depth a
process, on a fresh card).  TRAIN_MLA_LAYERS is fixed from it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
# the package's cost formulas and H100 constants (kernels/cost.py,
# launch/mesh.py), bound in main() once src/ is on the path
cost = h100 = None

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
# (workload, segment_reuse) -> the reduced replay's counters; the same
# dict as tests/test_torch_replay.py, which holds the CPU run to it and
# this copy to its own
REPLAY_PINS = {
    ("lmsys", False): {
        "engine_hit_rate": 0.852, "seen_blocks": 250, "hot_hits_t0": 142,
        "hot_hits_t1": 71, "cow_share_hits": 142, "inject_hits": 76,
        "segment_hit_blocks": 0, "promotions": 5, "requests_done": 28,
        "ttft_p50": 0.07900000000000004, "ttft_p95": 0.14482343999999994,
        "ttft_p99": 0.15272343999999993},
    ("agentic", False): {
        "engine_hit_rate": 0.8393393393393394, "seen_blocks": 666,
        "hot_hits_t0": 267, "hot_hits_t1": 292, "cow_share_hits": 267,
        "inject_hits": 318, "segment_hit_blocks": 0, "promotions": 26,
        "requests_done": 71, "ttft_p50": 0.1264000000000003,
        "ttft_p95": 0.24490000000000012, "ttft_p99": 0.2844000000000001},
    ("sharegpt", True): {
        "engine_hit_rate": 0.7196819085487077, "seen_blocks": 503,
        "hot_hits_t0": 127, "hot_hits_t1": 235, "cow_share_hits": 91,
        "inject_hits": 196, "segment_hit_blocks": 216, "promotions": 141,
        "requests_done": 58, "ttft_p50": 0.0868999999999999,
        "ttft_p95": 0.11849999999999997, "ttft_p99": 0.12639999999999996},
    ("lmsys", True): {
        "engine_hit_rate": 0.944, "seen_blocks": 250, "hot_hits_t0": 142,
        "hot_hits_t1": 94, "cow_share_hits": 142, "inject_hits": 76,
        "segment_hit_blocks": 32, "promotions": 14, "requests_done": 28,
        "ttft_p50": 0.07900000000000004, "ttft_p95": 0.14482343999999994,
        "ttft_p99": 0.15272343999999993},
}
# pool slots no correct mask reads (past a row's length, at or past a
# chunk's offset, a segment chunk's own slots) hold stale latents this
# many times larger, as unwritten slots of a live pool hold whatever
# another request left there; a one-token mask error then reads them
STALE_SCALE = 8.0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def memory_left(torch, after: str) -> None:
    """The device memory still allocated once a group of phases has
    dropped what it made, before and after a garbage collection: the
    next group's peaks count it in."""
    import gc
    torch.cuda.synchronize()
    before_gc = torch.cuda.memory_allocated()
    gc.collect()
    emit({"phase": "memory_left", "after": after,
          "allocated_gb": before_gc / 1e9,
          "after_gc_gb": torch.cuda.memory_allocated() / 1e9})


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
    """Compiled entry -> its tensor-core instructions in ``cuobjdump
    -sass`` of the built library of ``csrc/<name>.cu``: {"HMMA": n,
    "HGMMA": n} (``mma.sync`` and ``wgmma``)."""
    tool = Path(build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(build.lib_path(name))],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    counts, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1)
            counts[cur] = {"HMMA": 0, "HGMMA": 0}
        elif cur is not None:
            m = re.search(r"\b(HG?MMA)\b", line)
            if m:
                counts[cur][m.group(1)] += 1
    return counts


# entries that must run on the tensor cores: (source, entry name part,
# how many such entries, and for the warp-specialised bodies "HGMMA":
# they must hold `wgmma` instructions, not only `mma.sync` ones)
TENSOR_CORE_ENTRIES = (("flash_prefill", "flash_prefill_tc", 2),
                       ("flash_prefill", "flash_prefill_wg", 4, "HGMMA"),
                       ("flash_prefill_bwd", "bwd_dkdv_tc", 1),
                       ("flash_prefill_bwd", "bwd_dkdv_wg", 1, "HGMMA"),
                       ("flash_prefill_bwd", "bwd_dkdv_pair_wg", 2, "HGMMA"),
                       ("flash_prefill_bwd", "bwd_dq_tc", 1),
                       ("flash_prefill_bwd", "bwd_dq_wg", 3, "HGMMA"),
                       ("mla_paged_prefill", "mla_tc_kernelILi0E", 2),
                       ("mla_paged_prefill", "mla_tc_kernelILi1E", 2),
                       ("mla_paged_decode", "mla_tc_kernelILi2E", 2),
                       ("mla_paged_decode", "mla_decode_wg", 1, "HGMMA"),
                       ("mla_paged_prefill", "mla_prefill_wg", 2, "HGMMA"),
                       ("paged_decode", "paged_decode_tc", 4),
                       # kernels 1 and 8's Hopper body, bf16 and int8
                       # pages at hd 64 / 128; kernel 8's by name
                       ("paged_decode", "paged_decode_wg", 4),
                       ("paged_decode", "paged_decode_wgILi64ELb1E", 1),
                       ("paged_decode", "paged_decode_wgILi128ELb1E", 1),
                       ("paged_decode", "paged_decode_int8_tc", 4),
                       ("paged_prefill", "paged_prefill_tcILb0E", 4),
                       ("paged_prefill", "paged_prefill_tcILb1E", 4),
                       ("paged_prefill", "paged_prefill_wgILb0E", 2, "HGMMA"),
                       ("paged_prefill", "paged_prefill_wgILb1E", 2, "HGMMA"))


def phase_build(build, card):
    t0 = time.perf_counter()
    log = build.build_all()
    wall = time.perf_counter() - t0
    report = {}
    for name, entry in log.items():
        sass = sass_tensor_core_counts(build, name)
        entries = {e["entry"]: e for e in ptxas_report(entry["ptxas"])}
        for fn, n in sass.items():
            e = entries.setdefault(fn, {"entry": fn})
            e["tensor_core_sass"] = n["HMMA"] + n["HGMMA"]
            e["hgmma_sass"] = n["HGMMA"]
        report[name] = {"nvcc_s": entry["seconds"],
                        "entries": list(entries.values())}
    emit({"phase": "build", "card": card, "wall_s": wall,
          "sources": report})
    for name, part, want, *inst in TENSOR_CORE_ENTRIES:
        key = "hgmma_sass" if inst else "tensor_core_sass"
        found = [e for e in report[name]["entries"] if part in e["entry"]]
        if len(found) != want or not all(e.get(key, 0) > 0 for e in found):
            raise AssertionError(f"build: {name} entries {part}: {found} "
                                 f"(want {want}, each with "
                                 f"{inst[0] if inst else 'HMMA / HGMMA'})")


def make_kernel_inputs(torch, gen, page=64, offset=320, B=64, Hq=32):
    """Main-path shapes: 64 decode rows over a 512-token window, at
    64-token pages a 529-page pool (the default engine's slot and page
    counts at llama3.2-1b width); one chunk at ``offset`` of row 1.
    ``B=32, Hq=24``: granite-moe-3b-a800m's engine (G = 3)."""
    Hkv, hd, C = 8, 64, 64
    P = 512 // page
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
    off = torch.tensor([offset], dtype=torch.int32, device=dev)
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






def kernel_body(name, a) -> str:
    """The body the C entry runs for case ``name`` on inputs ``a``, as
    its dispatch by type and width decides: "tensor_core" or
    "cuda_core"; flash prefill and its backward "wgmma", "mma_sync" or
    "cuda_core"; the GQA chunk prefill (by page size too) "wgmma",
    "tensor_core" (``mma.sync``) or "cuda_core"; the GQA decode (by page
    size too) "hopper", "tensor_core" or "cuda_core"; the MLA decode and
    chunk / segment prefill (by page size too) "wgmma", "tensor_core" or
    "cuda_core"; the int8 decode (by page size and window too) "hopper",
    "tensor_core" or "cuda_core"."""
    from repro_torch.kernels import mla_paged_decode as mpd
    from repro_torch.kernels.paged_attention import DTYPE_CODES
    if name.startswith("paged_decode_int8"):
        from repro_torch.kernels.paged_attention import int8_body
        q, kp = a["q"], a["k_pages"]
        return int8_body(q.shape[-2], kp.shape[2], q.shape[-1], kp.shape[1],
                         a["block_tables"].shape[1], DTYPE_CODES[q.dtype])
    if name.startswith("paged_prefill"):
        from repro_torch.kernels.paged_prefill import body
        q, kp = a["q"], a["k_pages"]
        return body(q.shape[-2], kp.shape[2], q.shape[-1], kp.shape[1],
                    DTYPE_CODES[q.dtype], DTYPE_CODES[kp.dtype])
    elif name.startswith("paged_decode"):
        from repro_torch.kernels.paged_attention import body
        q, kp = a["q"], a["k_pages"]
        return body(q.shape[-2], kp.shape[2], q.shape[-1], kp.shape[1],
                    a["block_tables"].shape[1], DTYPE_CODES[q.dtype],
                    DTYPE_CODES[kp.dtype])
    elif name.startswith("mla_paged_decode"):
        lat = a["latent_pages"]
        return mpd.body(a["q_lat"].shape[-1], a["q_rope"].shape[-1],
                        lat.shape[1], DTYPE_CODES[a["q_lat"].dtype],
                        DTYPE_CODES[lat.dtype])
    elif name.startswith("flash_prefill_bwd"):
        from repro_torch.kernels.flash_prefill import bwd_body
        return bwd_body(a["q"].shape[-1], a["v"].shape[-1],
                        DTYPE_CODES[a["q"].dtype])
    elif name.startswith("flash_prefill"):
        from repro_torch.kernels.flash_prefill import body
        return body(a["q"].shape[-1], a["v"].shape[-1],
                    DTYPE_CODES[a["q"].dtype])
    elif name.startswith("mla_paged_prefill"):
        from repro_torch.kernels.paged_prefill import mla_body
        q_lat, lat = a["q_lat"], a["latent_pages"]
        n_cp = q_lat.shape[1] if "chunk_positions" in a else 0
        return mla_body(q_lat.shape[-1], a["q_rope"].shape[-1], n_cp,
                        lat.shape[1], DTYPE_CODES[q_lat.dtype],
                        DTYPE_CODES[lat.dtype])
    return "cuda_core"


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
        bound_ms, bound_by = cost.bound(nbytes, flops)
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
    """The GQA chunk prefill's plan on inputs ``a``.  The `wgmma` body:
    ``prefill_split_plan``'s splits of the key walk (from the shapes
    alone), the blocks, the blocks that walk keys on these inputs (their
    offsets or pool limits, read here on the host) and the partials the
    clusters merge in shared memory.  The `mma.sync` body: one block per
    (16 / G queries, KV head, row), its walk dealt to four warps and
    merged inside the block."""
    from repro_torch.kernels import paged_prefill as pp
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import DTYPE_CODES
    B, C, Hq, hd = a["q"].shape
    _, page, Hkv, _ = a["k_pages"].shape
    P = a["block_tables"].shape[1]
    if pp.body(Hq, Hkv, hd, page, DTYPE_CODES[a["q"].dtype],
               DTYPE_CODES[a["k_pages"].dtype]) != "wgmma":
        qb = 16 // (Hq // Hkv)
        return {"splits": 1, "warp_splits": 4, "queries_a_block": qb,
                "blocks": B * Hkv * -(-C // qb), "partial_bytes": 0}
    plan = pp.prefill_split_plan(B, C, Hq, Hkv, hd, page, P)
    ends = (a["offsets"] if "offsets" in a
            else ref.pool_limits(a["chunk_positions"])).tolist()
    live = Hkv * sum(plan.live_splits(e, qb) for e in ends
                     for qb in range(plan.query_blocks))
    return {"splits": plan.splits, "tiles_a_split": plan.tiles,
            "pool_splits": plan.pool_splits,
            "chunk_splits": plan.chunk_splits,
            "queries_a_block": plan.queries, "blocks": plan.blocks,
            "live_blocks": live, "cluster": [1, plan.splits, 1],
            "partial_bytes": plan.partial_bytes,
            "partials_in": "shared memory"}


def decode_plan(a) -> dict:
    """The GQA decode's plan on inputs ``a``.  The Hopper body:
    ``decode_split_plan``'s splits of each (row, KV head)'s walk (from the
    shapes alone), the blocks, the blocks that walk keys and those that
    stay for a cluster's merge on these inputs (their lengths, read here
    on the host), and the partials the clusters merge in shared memory.
    The `mma.sync` body: one block per (row, KV head), its walk dealt to
    four warps and merged inside the block.  The int8 decode (inputs
    with ``k_scales``) by its own body's gate."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels.paged_attention import DTYPE_CODES
    B, Hq, hd = a["q"].shape
    _, page, Hkv, _ = a["k_pages"].shape
    P = a["block_tables"].shape[1]
    qd = DTYPE_CODES[a["q"].dtype]
    if ("k_scales" in a and pa.int8_body(Hq, Hkv, hd, page, P, qd)
            != "hopper") or ("k_scales" not in a and pa.body(
                Hq, Hkv, hd, page, P, qd,
                DTYPE_CODES[a["k_pages"].dtype]) != "hopper"):
        return {"splits": 1, "warp_splits": 4, "blocks": B * Hkv,
                "partial_bytes": 0}
    plan = pa.decode_split_plan(B, Hq, Hkv, hd, page, P)
    live = [plan.live_splits(n) for n in a["lengths"].tolist()]
    return {"splits": plan.splits, "tiles_a_split": plan.tiles,
            "warp_splits": 4, "blocks": plan.blocks,
            "live_blocks": Hkv * sum(live),
            "staying_blocks": Hkv * sum(plan.splits if n > 1 else 1
                                        for n in live),
            "cluster": [plan.splits, 1, 1],
            "partial_bytes": plan.partial_bytes,
            "partials_in": "shared memory"}


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
    # every row at the full 512-token table: the bytes of a batch with no
    # short row, where the longest row no longer sets the time
    full = dict(dec, lengths=torch.full_like(dec["lengths"],
                                             dec["block_tables"].shape[1]
                                             * dec["k_pages"].shape[1]))
    cases = [
        ("paged_decode", ops.paged_decode, dec, cost.decode_cost(dec), None,
         decode_plan(dec)),
        ("paged_decode_full", ops.paged_decode, full, cost.decode_cost(full),
         None, decode_plan(full)),
        ("paged_prefill", ops.paged_prefill, pre,
         cost.prefill_cost(pre, off, C * off + C * (C + 1) // 2), None,
         prefill_plan(pre)),
        ("paged_prefill_long", ops.paged_prefill, pre_long,
         cost.prefill_cost(pre_long, long_off,
                      C * long_off + C * (C + 1) // 2), None,
         prefill_plan(pre_long)),
        ("paged_prefill_seg", ops.paged_prefill_seg, seg,
         cost.prefill_cost(seg, seg_pool, seg_pairs), None, prefill_plan(seg)),
    ]
    cases += page32_cases(torch, gen, ops)
    cases += g3_cases(torch, gen, ops)
    rows = check_and_time(torch, cases, card, "kernels")
    check_contiguous(torch, ops.paged_prefill_seg, ops.paged_prefill, pre,
                     C, "kernels")
    check_nonfinite_unread(torch, gen, ops, card)
    return rows


def check_nonfinite_unread(torch, gen, ops, card):
    """Kernels 1-3 at the trace replay's 32-token pages (decode rows of
    ragged lengths; chunks at offset 336; the gap segment chunk) with
    every slot no row may read (at or past a decode row's length, at or
    past the offset or pool limit, a segment chunk's own slots) holding
    inf in K and NaN in V, then NaN in K and inf in V: the output (and
    the decode's log-sum-exp) must equal the clean pool's bit for bit and
    be finite.  The bodies land whole pages and zero those V rows before
    P V."""
    from repro_torch.kernels import ref
    dec, pre, seg = make_kernel_inputs(torch, gen, page=32, offset=336)
    for name, op, a in (("paged_prefill_page32", ops.paged_prefill, pre),
                        ("paged_prefill_seg_page32", ops.paged_prefill_seg,
                         seg),
                        ("paged_decode_page32", ops.paged_decode, dec)):
        page = a["k_pages"].shape[1]
        pos = torch.arange(a["block_tables"].shape[1] * page, device="cuda")
        if "lengths" in a:
            unread = pos[None] >= a["lengths"].long()[:, None]
        elif "offsets" in a:
            unread = pos[None] >= a["offsets"].long()[:, None]
        else:
            cpos = a["chunk_positions"].long()
            limit = ref.pool_limits(a["chunk_positions"]).long()
            unread = ((pos[None, :, None] == cpos[:, None, :]).any(-1)
                      | (pos[None] >= limit[:, None]))
        pid = a["block_tables"].long()[:, pos // page][unread]
        slot = (pos % page).expand_as(unread)[unread]
        kw = {"with_lse": True} if "lengths" in a else {}

        def run(b):
            out = op(**b, backend="cuda", **kw)
            return out if kw else (out,)
        clean = run(a)
        err = float((clean[0].float()
                     - op(**a, backend="torch").float()).abs().max())
        same = []
        for kbad, vbad in ((math.inf, math.nan), (math.nan, math.inf)):
            dirty = dict(a, k_pages=a["k_pages"].clone(),
                         v_pages=a["v_pages"].clone())
            dirty["k_pages"][pid, slot] = kbad
            dirty["v_pages"][pid, slot] = vbad
            outs = run(dirty)
            same.append(all(bool(torch.isfinite(o).all())
                            and torch.equal(o, c)
                            for o, c in zip(outs, clean)))
        emit({"phase": "kernels", "card": card, "check": name + "_nonfinite",
              "body": kernel_body(name, a), "unread_slots": int(pid.numel()),
              "clean_max_abs_err": err, "tol": KERNEL_ATOL,
              "unchanged_and_finite": same})
        if not all(same) or not err <= KERNEL_ATOL:
            raise AssertionError(f"{name}: non-finite unread slots changed "
                                 f"the output ({same}) or the clean output "
                                 f"is {err} from the plain version")


def stale_pools(torch, a, unread):
    """Case ``a`` with clones of its K/V pools [N, page, Hkv, hd] whose
    slots at the row positions where ``unread`` [B, T] holds are scaled
    by STALE_SCALE, as pool pages reused under tier churn hold stale
    rows."""
    page = a["k_pages"].shape[1]
    pos = torch.arange(unread.shape[1], device=unread.device)
    pid = a["block_tables"].long()[:, pos // page][unread]
    slot = (pos % page).expand_as(unread)[unread]
    out = dict(a)
    for key in ("k_pages", "v_pages"):
        out[key] = a[key].clone()
        out[key][pid, slot] *= STALE_SCALE
    return out


def page32_cases(torch, gen, ops):
    """Kernels 1-3 at the trace replay's 32-token pages (a 64-key tile
    gathers two pages), the same heads and 512-token window, the chunk
    at offset 336 (mid-page); every slot no row may read (past a decode
    row's length, at or past the chunk's offset, a segment chunk's own
    slots and those past its last position) holds stale K/V."""
    dec, pre, seg = make_kernel_inputs(torch, gen, page=32, offset=336)
    C = pre["q"].shape[1]
    pos = torch.arange(dec["block_tables"].shape[1] * 32, device="cuda")
    dec = stale_pools(torch, dec, pos[None] >= dec["lengths"].long()[:, None])
    pre = stale_pools(torch, pre, pos[None] >= pre["offsets"].long()[:, None])
    cpos = seg["chunk_positions"].long()
    own = (pos[None, :, None] == cpos[:, None, :]).any(-1)
    past = pos[None] > cpos.max(-1).values[:, None]
    seg = stale_pools(torch, seg, own | past)
    off = int(pre["offsets"][0])
    return [
        ("paged_decode_page32", ops.paged_decode, dec, cost.decode_cost(dec),
         None, decode_plan(dec)),
        ("paged_prefill_page32", ops.paged_prefill, pre,
         cost.prefill_cost(pre, off, C * off + C * (C + 1) // 2), None,
         prefill_plan(pre)),
        ("paged_prefill_seg_page32", ops.paged_prefill_seg, seg,
         cost.prefill_cost(seg, *seg_counts([int(x) for x in cpos[0]])), None,
         prefill_plan(seg)),
    ]


def g3_cases(torch, gen, ops):
    """Kernels 1-3 at the moe_serve engine's shapes: granite-moe-3b-a800m
    (Hq 24 over Hkv 8, G = 3, hd 64), its 32 slots of 512 tokens at
    64-token pages; the chunk at offset 320 (``*_g3`` rows)."""
    dec, pre, seg = make_kernel_inputs(torch, gen, B=32, Hq=24)
    C = pre["q"].shape[1]
    off = int(pre["offsets"][0])
    return [
        ("paged_decode_g3", ops.paged_decode, dec, cost.decode_cost(dec), None,
         decode_plan(dec)),
        ("paged_prefill_g3", ops.paged_prefill, pre,
         cost.prefill_cost(pre, off, C * off + C * (C + 1) // 2), None,
         prefill_plan(pre)),
        ("paged_prefill_seg_g3", ops.paged_prefill_seg, seg,
         cost.prefill_cost(seg, *seg_counts(
             [int(x) for x in seg["chunk_positions"][0]])), None,
         prefill_plan(seg)),
    ]


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




def mla_decode_plan(a) -> dict:
    """The tensor-core MLA decode's split plan on inputs ``a`` (the
    `wgmma` and the `mma.sync` body share it): tokens a split, splits of
    the grid, blocks launched (those past a row's length exit at once),
    blocks that walk keys, and the float32 partial bytes written (the
    combine reads them back once)."""
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
         cost.mla_cost(dec, dec_tokens, dec_tokens), None, mla_decode_plan(dec)),
        ("mla_paged_decode_long", ops.mla_decode, long,
         cost.mla_cost(long, B8 * window, B8 * window), None,
         mla_decode_plan(long)),
        ("mla_paged_prefill", ops.mla_prefill, pre,
         cost.mla_cost(pre, off, C * off + C * (C + 1) // 2)),
        ("mla_paged_prefill_seg", ops.mla_prefill_seg, seg,
         cost.mla_cost(seg, seg_pool, seg_pairs)),
    ]
    cases += mla_dense_cases(torch, gen, cfg, ops)
    rows = check_and_time(torch, cases, card, "mla_kernels")
    check_contiguous(torch, ops.mla_prefill_seg, ops.mla_prefill, pre, C,
                     "mla_kernels")
    return rows


# the mla_dense_parity prompt: a whole prompt through kernel 5 at offset 0
MLA_PROMPT = 1100


def mla_dense_cases(torch, gen, cfg, ops):
    """Kernels 4 and 5 on the dense layout's routes at DeepSeek-V3 width:
    the chunk prefill at offset 0 with a whole 1100-token prompt as the
    chunk over a one-slot pool it never reads
    (``mla_paged_prefill_offset0``, the monolithic prefill's call), and
    the decode over the mla_dense_serve engine's latent slot cache (56
    slots of 2048 tokens seen as 64-token pages by ``slot_pages``, ragged
    lengths, every 7th row empty; ``mla_paged_decode_slots``)."""
    from repro_torch.models import attention as attn
    Hq, dl, dr, C = cfg.n_heads, cfg.d_latent, cfg.d_rope, MLA_PROMPT
    dev = "cuda"

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    scale = attn.mla_scale(cfg)
    pre = dict(q_lat=randn(1, C, Hq, dl), q_rope=randn(1, C, Hq, dr),
               lat_chunk=randn(1, C, dl + dr),
               latent_pages=torch.zeros((1, 64, dl + dr),
                                        dtype=torch.bfloat16, device=dev),
               block_tables=torch.zeros((1, 1), dtype=torch.int32,
                                        device=dev),
               offsets=torch.zeros((1,), dtype=torch.int32, device=dev),
               d_latent=dl, scale=scale)
    (pages,), tables = attn.slot_pages(randn(MLA_ROWS, MLA_MAX_LEN, dl + dr))
    lengths = torch.randint(1, MLA_MAX_LEN + 1, (MLA_ROWS,), generator=gen,
                            device=dev).to(torch.int32)
    lengths[::7] = 0
    lengths[1] = MLA_MAX_LEN
    dec = dict(q_lat=randn(MLA_ROWS, Hq, dl), q_rope=randn(MLA_ROWS, Hq, dr),
               latent_pages=pages, block_tables=tables, lengths=lengths,
               d_latent=dl, scale=scale)
    toks = int(lengths.sum())
    sdpa, backend = mla_sdpa(torch, pre)
    return [
        ("mla_paged_prefill_offset0", ops.mla_prefill, pre,
         cost.mla_cost(pre, 0, C * (C + 1) // 2), sdpa,
         {"library_backend": backend}),
        ("mla_paged_decode_slots", ops.mla_decode, dec,
         cost.mla_cost(dec, toks, toks), None, mla_decode_plan(dec)),
    ]


def mla_sdpa(torch, a):
    """The library yardstick of kernel 5 at offset 0 (a whole prompt as
    the chunk, no pool token read): one F.scaled_dot_product_attention
    call, causal, q = [q_lat ; q_rope] with every head over the chunk's
    latent as one shared head (k all dl + dr columns, v the first dl),
    the kernel's scale, on ``sdpa_backend``'s backend (PyTorch's flash
    backend takes no head wider than 256).  The callable (output in the
    kernel's [B, C, Hq, dl] layout) and the backend's name."""
    import torch.nn.functional as F
    dl = a["d_latent"]
    qh = torch.cat([a["q_lat"], a["q_rope"]], -1).transpose(1, 2) \
        .contiguous()
    kh = a["lat_chunk"][:, None].contiguous()
    vh = a["lat_chunk"][:, None, :, :dl].contiguous()
    backend, ctx = sdpa_backend(torch, qh, kh, vh, None)

    def sdpa():
        with ctx():
            return F.scaled_dot_product_attention(
                qh, kh, vh, is_causal=True, scale=a["scale"],
                enable_gqa=True).transpose(1, 2)
    return sdpa, backend


# ---------------------------------------------------------------------------
# the dense layout: causal flash prefill and int8 decode over slot pages
# ---------------------------------------------------------------------------


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




# kernels 1 and 8 with their log-sum-exp: float32 log-sum-exps of the
# same float32 scores summed in another order (tests/test_torch_gpu.py's
# bound)
LSE_ATOL = 1e-3
# the decode_lse timings: without / with the output, in turns, each this
# many times
LSE_REPEATS = 3


def lse_check(torch, ops, name, op, a):
    """``op`` (kernel 1 or 8) on inputs ``a`` with its log-sum-exp,
    against the plain versions (output within KERNEL_ATOL, log-sum-exp
    within LSE_ATOL, -1e30 and finite on every row of length 0); then
    each row's block table cut into two halves of pages, each half
    launched with its log-sum-exp and the two merged by the split
    decode's ``merge_slices``, against the whole-row launch.  Returns the
    errors."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.abstract import merge_slices
    out, lse = op(**a, backend="cuda", with_lse=True)
    torch.cuda.synchronize()
    plain = op(**a, backend="torch")
    ref_lse = ref.paged_decode_lse(a["q"], a["k_pages"], a["block_tables"],
                                   a["lengths"], a.get("k_scales"))
    empty = a["lengths"] == 0
    err = {"max_abs_err": float((out.float() - plain.float()).abs().max()),
           "lse_max_abs_err": float((lse - ref_lse).abs().max()),
           "lse_finite": bool(torch.isfinite(lse).all()),
           "empty_rows": int(empty.sum()),
           "empty_rows_neg_1e30": bool((lse[empty] == -1e30).all())}
    page = a["k_pages"].shape[1]
    p1 = a["block_tables"].shape[1] // 2
    parts = []
    for tables, n in ((a["block_tables"][:, :p1],
                       a["lengths"].clamp(max=p1 * page)),
                      (a["block_tables"][:, p1:],
                       (a["lengths"] - p1 * page).clamp(min=0))):
        parts.append(op(**dict(a, block_tables=tables.contiguous(),
                               lengths=n), backend="cuda", with_lse=True))
    merged = merge_slices(torch.stack([o.float() for o, _ in parts]),
                          torch.stack([x for _, x in parts]))
    err["split_merge_max_abs_err"] = float(
        (merged - out.float()).abs().max())
    if not (err["max_abs_err"] <= KERNEL_ATOL
            and err["lse_max_abs_err"] <= LSE_ATOL and err["lse_finite"]
            and err["empty_rows_neg_1e30"]
            and err["split_merge_max_abs_err"] <= KERNEL_ATOL
            and bool(torch.isfinite(merged).all())):
        raise AssertionError(f"{name}: log-sum-exp output {err}")
    return err


def phase_decode_lse(torch, ops, card):
    """Kernels 1 and 8 with their log-sum-exp output (the split decode's
    merge weights) at the kernels phase's main-path shapes: kernel 1's
    ``paged_decode`` row (64 rows of llama3.2-1b over 512-token tables,
    every 7th row of length 0) and kernel 8's 64-slot row, each on its
    bf16 tensor-core body and with a float32 query on its CUDA-core body
    (``lse_check``); then the tensor-core launch timed without and with
    the output in turns, LSE_REPEATS times each, beside the bound with
    the log-sum-exp's [B, Hq] float32 written once."""
    from repro_torch.models import attention as attn
    dec = make_kernel_inputs(torch, torch.Generator(
        device="cuda").manual_seed(1234))[0]
    i8 = make_int8_decode_inputs(torch, torch.Generator(
        device="cuda").manual_seed(5678), attn)
    rows = {}
    for name, op, a, (nbytes, flops) in (
            ("paged_decode", ops.paged_decode, dec, cost.decode_cost(dec)),
            ("paged_decode_int8", ops.paged_decode_int8, i8,
             cost.int8_decode_cost(i8))):
        checks = {}
        for q_dtype in ("bfloat16", "float32"):
            b = dict(a, q=a["q"].to(getattr(torch, q_dtype)))
            checks[q_dtype] = {"body": kernel_body(name, b),
                               **lse_check(torch, ops, name, op, b)}
        times = {"without": [], "with": []}
        for turn in ("without", "with", "with", "without") * (
                (LSE_REPEATS + 1) // 2):
            if len(times[turn]) < LSE_REPEATS:
                times[turn].append(time_ms(torch, lambda: op(
                    **a, backend="cuda", with_lse=turn == "with"))["ms"])
        lse_bytes = a["q"].shape[0] * a["q"].shape[1] * 4
        bound_ms, bound_by = cost.bound(nbytes + lse_bytes, flops)
        rows[name] = {"checks": checks, "ms_without_lse": times["without"],
                      "ms_with_lse": times["with"], "lse_bytes": lse_bytes,
                      "bound_ms_with_lse": bound_ms, "bound_by": bound_by,
                      "bound_ms_without_lse": cost.bound(nbytes, flops)[0]}
        emit({"phase": "decode_lse", "card": card, "kernel": name,
              **rows[name]})
    return rows


def flash_case(torch, gen, ops, name, S, Hq, Hkv, hd):
    """Causal flash prefill of one bf16 prompt of S tokens, beside
    F.scaled_dot_product_attention (causal, GQA) as the library
    yardstick."""
    import torch.nn.functional as F
    a = {"q": torch.randn((1, S, Hq, hd), generator=gen, device="cuda"),
         "k": torch.randn((1, S, Hkv, hd), generator=gen, device="cuda"),
         "v": torch.randn((1, S, Hkv, hd), generator=gen, device="cuda")}
    a = {key: t.to(torch.bfloat16) for key, t in a.items()}
    # the library's [B, H, S, hd] layout of the same values
    qh, kh, vh = (a[key].transpose(1, 2).contiguous()
                  for key in ("q", "k", "v"))

    def sdpa():
        return F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True, enable_gqa=True).transpose(1, 2)
    return (name, ops.flash_causal, a, cost.flash_cost(a), sdpa)


def slot_decode_case(torch, gen, ops, attn, name, S, Hq, Hkv, hd, lengths):
    """The paged decode kernel over bf16 slot caches [B, S, Hkv, hd] seen
    as pages (``attention.slot_pages``), one row a length, as the dense
    layout's ``decode_attention`` calls it."""
    B = len(lengths)
    k, v = (torch.randn((B, S, Hkv, hd), generator=gen, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    (kp, vp), tables = attn.slot_pages(k, v)
    a = dict(q=torch.randn((B, Hq, hd), generator=gen,
                           device="cuda").to(torch.bfloat16),
             k_pages=kp, v_pages=vp, block_tables=tables,
             lengths=torch.tensor(lengths, dtype=torch.int32, device="cuda"))
    return (name, ops.paged_decode, a, cost.decode_cost(a), None,
            decode_plan(a))


def cross_cases(torch, gen, ops, attn):
    """Kernels 7 and 1 at the cross-attention families' self-attention
    shapes and zamba2's shared attention: flash prefill at
    llama-3.2-vision's 32 q / 8 kv heads, hd 128 (its longest smoke
    prompt, 512, and the ragged 100), at whisper-tiny's 6 / 6 heads, hd
    64, G 1 (its longest prompt, 128) and at zamba2-1.2b's 32 / 32 heads,
    hd 64, G 1 (512); the paged decode over the ``vlm_generate`` phase's
    4 slots of 1024 tokens, the ``encdec_generate`` phase's 8 slots of
    448 and the ``hybrid_generate`` phase's 4 slots of 1024 at their
    middle decode step."""
    vlm, whisper, zamba = (32, 8, 128), (6, 6, 64), (32, 32, 64)
    return [
        flash_case(torch, gen, ops, "flash_prefill_vlm", 512, *vlm),
        flash_case(torch, gen, ops, "flash_prefill_vlm_ragged", 100, *vlm),
        flash_case(torch, gen, ops, "flash_prefill_whisper", 128, *whisper),
        slot_decode_case(torch, gen, ops, attn, "paged_decode_vlm",
                         VLM_MAX_LEN, *vlm,
                         [n + VLM_STEPS // 2 for n in VLM_PROMPTS]),
        slot_decode_case(torch, gen, ops, attn, "paged_decode_whisper",
                         ENCDEC_MAX_LEN, *whisper,
                         [n + ENCDEC_STEPS // 2 for n in ENCDEC_PROMPTS]),
        flash_case(torch, gen, ops, "flash_prefill_zamba2", 512, *zamba),
        slot_decode_case(torch, gen, ops, attn, "paged_decode_zamba2",
                         RECURRENT_MAX_LEN, *zamba,
                         [n + RECURRENT_STEPS // 2
                          for n in RECURRENT_PROMPTS]),
    ]


def phase_dense_kernels(torch, ops, card):
    from repro_torch.models import attention as attn
    gen = torch.Generator(device="cuda").manual_seed(5678)
    # S = 384: the serve traffic's first prompt padded to 32; 416 ends in
    # a ragged 32-row tile of the kernel's 64-row tiles
    cases = [flash_case(torch, gen, ops, name, S, 32, 8, 64)
             for name, S in (("flash_prefill", 384),
                             ("flash_prefill_ragged", 416))]
    dec = make_int8_decode_inputs(torch, gen, attn)
    # the int8_decode path's own shape: its 4 slots at the eighth of its
    # 16 decode steps (prompts of 384 / 256 / 448 / 100 tokens, + 8)
    path = make_int8_decode_inputs(torch, gen, attn,
                                   lengths=INT8_PATH_LENGTHS)
    for name, a in (("paged_decode_int8", dec),
                    ("paged_decode_int8_path", path)):
        cases.append((name, ops.paged_decode_int8, a, cost.int8_decode_cost(a),
                      None, decode_plan(a)))
    cases += cross_cases(torch, gen, ops, attn)
    rows = check_and_time(torch, cases, card, "kernels")
    for name, a in (("paged_decode_int8", dec),
                    ("paged_decode_int8_path", path)):
        check_int8_unread(torch, ops, card, name, a)
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


def check_int8_unread(torch, ops, card, name, a):
    """Kernel 8 on inputs ``a`` with every slot no row may read (at or
    past its length) holding int8 127 in K and -127 in V with an inf K
    and a NaN V scale, then the signs and the scales swapped: the output
    and its log-sum-exp must equal the clean pool's bit for bit and be
    finite (the producer never loads a scale past a row's end, and an
    unread key's P is 0)."""
    page = a["k_pages"].shape[1]
    pos = torch.arange(a["block_tables"].shape[1] * page, device="cuda")
    unread = pos[None] >= a["lengths"].long()[:, None]
    slot = (a["block_tables"].long()[:, pos // page] * page + pos % page)
    slots = slot[unread][~torch.isin(slot[unread], slot[~unread])]
    clean = ops.paged_decode_int8(**a, backend="cuda", with_lse=True)
    same = []
    for bads in ((127, -127, math.inf, math.nan),
                 (-127, 127, math.nan, math.inf)):
        dirty = dict(a)
        for key, bad in zip(("k_pages", "v_pages", "k_scales", "v_scales"),
                            bads):
            dirty[key] = a[key].clone()
            dirty[key].view(-1, *a[key].shape[2:])[slots] = bad
        outs = ops.paged_decode_int8(**dirty, backend="cuda", with_lse=True)
        same.append(all(bool(torch.isfinite(o).all()) and torch.equal(o, c)
                        for o, c in zip(outs, clean)))
    emit({"phase": "kernels", "card": card, "check": name + "_nonfinite",
          "body": kernel_body(name, a), "unread_slots": int(slots.numel()),
          "unchanged_and_finite": same})
    if not all(same) or slots.numel() == 0:
        raise AssertionError(f"{name}: int8 +-127 / inf / NaN scales in "
                             f"unread slots changed the output ({same})")


def phase_serve(torch, kernel_fns, path, card, cfg, ecfg, system_blocks,
                shared_tail, phase="serve", pool=None,
                expect=("cow_share_hits", "segment_chunks"), params=None,
                instrument=None, check_calls=False):
    """Serve ``cfg`` on the engine: 6 requests of a shared system prefix
    (``system_blocks`` manager blocks) plus ``shared_tail`` tokens each,
    the first alone, then five; then a segment pair A = [S0 S1 S2 | tail]
    and B = [X0 S1 S2 | tail] of one-block segments.  Every kernel's
    count is zeroed just before the traffic and read just after; each
    kernel of ``path`` must have launched, and each engine counter in
    ``expect`` must be above 0.  ``pool``: the (slots, table pages, pool
    pages) the kernel phase assumed for this engine.  ``params``: a
    weight tree to serve (else the engine's seeded init); ``instrument``:
    called with the engine before the traffic, returns a function whose
    dict joins the phase's line.  ``check_calls``: kernels 1-6 held to
    their plain versions on the traffic's own calls
    (``checked_kernel_calls``)."""
    from repro_torch.serving import SamplingParams, ServingEngine

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = ServingEngine(cfg, ecfg, device="cuda", params=params)
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

    report = instrument(eng) if instrument is not None else dict
    for fn in kernel_fns.values():
        fn.launches = 0
    reqs, decode_s, decode_tokens, decode_steps, steps = [], 0.0, 0, 0, 0
    calls = []
    t_serve = time.perf_counter()
    with (checked_kernel_calls(torch, calls) if check_calls
          else contextlib.nullcontext()):
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
           "kernel_backend": st["kernel_backend"], **report()}
    if check_calls:
        out["kernel_checks"] = kernel_check_report(torch, calls)
    emit(out)
    if check_calls:
        held_to_plain(phase, out["kernel_checks"], launches)
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


def phase_parity(torch, params, card, cfg=None, phase="parity"):
    """One decode step, one prefill chunk and one segment chunk of the
    full-width model (llama3.2-1b, or ``cfg``) with the CUDA kernels,
    with the plain versions and with one-token mask-error versions, on
    the same weights and pool.  An MoE model's routing is pinned to the
    kernels' run (``PinnedRouting``), so the comparison sees the
    attention kernels: a one-step difference in bf16 flips top-k choices
    at near ties, and the flipped tokens' FFN outputs differ by O(1)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model

    cfg = cfg or get_config("llama3.2-1b")
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

    with PinnedRouting(torch) as pin:
        runs = {"cuda": run("cuda")}
        pin.replay()
        runs["torch"] = run("torch")
        pin.replay()
        with one_token_mask_errors(torch):
            runs["mutant"] = run("torch")
    parity_report(runs, PARITY_RTOL, card, phase, pin.report())


def parity_report(runs, rtol, card, phase, extra=None, parity_only=()):
    """Hold the kernels' run to the plain versions' within ``rtol`` of
    each tensor's largest magnitude, and check that the mask-error run
    lands outside it (for every tensor but those in ``parity_only``,
    which a mask error reaches only diluted, and which the other tensors
    of the same entry point catch)."""
    res = {}
    for key, plain in runs["torch"].items():
        def gap(other):
            return float((runs[other][key].float() - plain.float())
                         .abs().max())
        scale = float(plain.float().abs().max())
        res[key] = {"max_abs_diff": gap("cuda"), "max_abs": scale,
                    "tol": rtol * scale,
                    "mutant_max_abs_diff": gap("mutant")}
    emit({"phase": phase, "card": card, "rtol": rtol, **(extra or {}),
          **res})
    bad = {k: v for k, v in res.items() if not v["max_abs_diff"] <= v["tol"]}
    if bad:
        raise AssertionError(f"kernels vs plain versions differ: {bad}")
    blind = {k: v for k, v in res.items()
             if k not in parity_only
             and not v["mutant_max_abs_diff"] > v["tol"]}
    if blind:
        raise AssertionError(f"parity limit misses a one-token mask "
                             f"error: {blind}")


class PinnedRouting:
    """Within the context, every ``moe.route`` call of the first run is
    logged (its top-k experts, capacity positions and kept mask); after
    ``replay()`` each later run takes the logged decisions call by call,
    with its own router probabilities renormalised over the logged
    experts, and the tokens whose own set of kept experts differs are
    counted.  A dense model makes no route call."""

    def __init__(self, torch):
        from repro_torch.models import moe
        self.torch, self.moe, self.route = torch, moe, moe.route
        self.log, self.at, self.differ = [], None, []

    def __enter__(self):
        def pinned(p, xg, cfg):
            out = self.route(p, xg, cfg)
            if self.at is None:
                self.log.append(out[2:])
                return out
            probs, _, top_i, _, keep = out
            ri, rp, rk = self.log[self.at]
            self.at += 1
            self.differ[-1].append((self.kept(ri, rk, probs.shape[-1])
                                    != self.kept(top_i, keep,
                                                 probs.shape[-1]))
                                   .any(-1).sum())
            tp = probs.gather(-1, ri)
            return probs, tp / tp.sum(-1, keepdim=True), ri, rp, rk
        self.moe.route = pinned
        return self

    def __exit__(self, *exc):
        self.moe.route = self.route

    def kept(self, top_i, keep, e):
        """[G,t,E]: the experts that process each token."""
        experts = self.torch.arange(e, device=top_i.device)
        return ((top_i[..., None] == experts) & keep[..., None]).any(-2)

    def replay(self):
        """Start a run that replays the first run's decisions."""
        self.at = 0
        self.differ.append([])

    def report(self) -> dict:
        tokens = sum(int(ri.numel() // ri.shape[-1]) for ri, _, _ in
                     self.log)
        return {"routing_calls": len(self.log), "routed_tokens": tokens,
                "tokens_whose_own_kept_experts_differed_by_replay":
                [int(sum(d)) for d in self.differ if d]}


def moe_drops(torch):
    """``phase_serve`` instrument: keep every decode step's routing (the
    kept masks of ``moe.route``, by reference: no device work, no sync)
    beside the step's active rows (length > 0; the rest carry token 0);
    the report is the share of the active rows' (expert, slot)
    assignments that capacity dropped."""
    from repro_torch.models import moe
    route, seen, active = moe.route, [], [None]

    def spy(p, xg, cfg):
        out = route(p, xg, cfg)
        if active[0] is not None:
            seen.append((out[4][0], active[0]))
        return out

    def install(eng):
        decode = eng.model.decode_step_paged

        def decode_step_paged(params, state, tokens, **kw):
            active[0] = state["lengths"] > 0
            try:
                return decode(params, state, tokens, **kw)
            finally:
                active[0] = None
        eng.model.decode_step_paged = decode_step_paged
        moe.route = spy

        def report():
            moe.route = route
            keep = torch.stack([k for k, _ in seen])          # [R, B, k]
            act = torch.stack([a for _, a in seen])[..., None]
            assigned = int((act.expand_as(keep)).sum())
            dropped = int((~keep & act).sum())
            return {"moe_decode_routings": len(seen),
                    "active_assignments": assigned,
                    "active_assignments_dropped": dropped,
                    "active_drop_share": dropped / assigned}
        return report
    return install


def phase_moe_parity(torch, params, cfg, card, rows):
    """``phase_parity`` on granite-moe-3b-a800m at full width (kernels 1-3
    at G = 3, hd 64, routing pinned), then layer 0's MoE FFN at the
    moe_serve decode batch (``rows`` tokens, the second half one repeated
    input, as inactive rows all carry token 0) in float32 on the card and
    on the CPU from the same inputs: the routing must be identical and
    the outputs within the parity limit; and the bf16 layer timed beside
    its bound (all 40 experts' weights read once)."""
    from repro_torch.models import moe

    phase_parity(torch, params, card, cfg, phase="moe_parity")
    lp = {k: v[0] for k, v in params["layers"]["ffn"].items()}
    gen = torch.Generator(device="cuda").manual_seed(96)
    h = torch.randn((rows, 1, cfg.d_model), generator=gen, device="cuda")
    h[rows // 2:] = h[rows // 2]
    p32 = {k: v.float() for k, v in lp.items()}
    pcpu = {k: v.cpu() for k, v in p32.items()}
    out, aux = moe.moe_ffn(p32, h, cfg)
    ref, ref_aux = moe.moe_ffn(pcpu, h.cpu(), cfg)
    card_route = moe.route(p32, h.reshape(1, rows, -1), cfg)[2:]
    cpu_route = moe.route(pcpu, h.cpu().reshape(1, rows, -1), cfg)[2:]
    same = all(torch.equal(a.cpu(), b) for a, b in zip(card_route, cpu_route))
    err = float((out.cpu() - ref).abs().max())
    tol = PARITY_RTOL * float(ref.abs().max())
    hb = h.bfloat16()
    # a call queues ~50 small kernels: a short window keeps the queue
    # below its depth while the device sleeps
    t = time_ms(torch, lambda: moe.moe_ffn(lp, hb, cfg), iters=4)
    weights = sum(v.numel() * v.element_size() for v in lp.values())
    cap = moe.capacity(rows, cfg)
    flops = 3 * 2 * cfg.n_experts * cap * cfg.d_model * cfg.moe_ff
    nbytes = weights + 2 * h.numel() * hb.element_size()
    bound_ms, bound_by = cost.bound(nbytes, flops)
    keep = cpu_route[2]
    emit({"phase": "moe_layer", "card": card, "rows": rows,
          "capacity": cap, "routing_identical": same,
          "assignments_dropped": int((~keep).sum()),
          "max_abs_err_f32": err, "tol": tol,
          "aux_card": float(aux), "aux_cpu": float(ref_aux),
          "bf16_ms": t["ms"], "bound_ms": bound_ms, "bound_by": bound_by,
          "weight_bytes": weights, "flops": flops})
    if not same:
        raise AssertionError("moe_layer: routing on the card differs from "
                             "the CPU's")
    if not err <= tol:
        raise AssertionError(f"moe_layer: card vs CPU {err} > {tol}")


def phase_mla_dense_parity(torch, params, cfg, card):
    """One monolithic prefill of a 1100-token prompt (kernel 5 at offset
    0) and one dense decode step over 8 latent slots of 2048 tokens seen
    as pages (kernel 4) of the 8-layer DeepSeek-V3 model with the
    kernels, the plain versions and one-token mask-error versions; every
    slot past a row's new token holds 8x larger latents."""
    from repro_torch.models.model import build_model

    model = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(95)
    L, D, B, S = cfg.n_layers, cfg.d_latent + cfg.d_rope, 8, MLA_MAX_LEN
    ptoks = torch.randint(0, cfg.vocab_size, (1, MLA_PROMPT), generator=gen,
                          device="cuda").to(torch.int32)
    lengths = torch.randint(64, S - 1, (B,), generator=gen,
                            device="cuda").to(torch.int32)
    tokens = torch.randint(0, cfg.vocab_size, (B,), generator=gen,
                           device="cuda").to(torch.int32)
    lat = torch.randn((L, B, S, D), generator=gen, device="cuda")
    lat[:, torch.arange(S, device="cuda")[None, :]
        > lengths.long()[:, None]] *= STALE_SCALE
    lat = lat.bfloat16()
    rows, at = torch.arange(B, device="cuda"), lengths.long()

    def run(be):
        logits, st = model.prefill(params, {"tokens": ptoks}, backend=be)
        out = {"prefill_logits": logits, "prefill_latent": st["latent"]}
        logits, new = model.decode_step(
            params, {"latent": lat.clone(), "lengths": lengths}, tokens,
            backend=be)
        out.update(decode_logits=logits,
                   decode_new_latent=new["latent"][:, rows, at])
        return out

    runs = {"cuda": run("cuda"), "torch": run("torch")}
    with one_token_mask_errors(torch):
        runs["mutant"] = run("torch")
    # the last position's logits see a chunk key one ahead only through
    # the other positions' later-layer latents, averaged over 1100 keys;
    # the prefill's latents of every position and layer catch it
    parity_report(runs, MLA_PARITY_RTOL, card, "mla_dense_parity",
                  parity_only=("prefill_logits",))


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
    seen as pages, its calls 1, 2, 4, 8, ... held to the plain version on
    the path's own tensors (``checked_kernel_calls``: worst error within
    one bf16 step, finite).  Every count is zeroed just before and read
    just after; both kernels must have launched."""
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
    step_s, finite, calls = [], [], []
    with checked_kernel_calls(torch, calls):
        for _ in range(steps):
            t = time.perf_counter()
            logits, state = model.decode_step(params, state, tok)
            tok = logits.argmax(dim=-1).to(torch.int32)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t)
            finite.append(bool(torch.isfinite(logits).all()))
    launches = {name: fn.launches for name, fn in kernel_fns.items()}
    checks = kernel_check_report(torch, calls)
    want = [n + steps for n in lens]
    emit({"phase": "int8_decode", "card": card, "model": cfg.name,
          "layers": cfg.n_layers, "rows": len(lens), "prompt_lens": lens,
          "max_len": max_len, "prefill_s": prefill_s,
          "decode_step_ms_median": 1e3 * sorted(step_s)[steps // 2],
          "decode_step_ms_mean": 1e3 * sum(step_s) / steps,
          "launches": launches, "kernel_checks": checks})
    if not all(finite):
        raise AssertionError("int8_decode: non-finite logits")
    held_to_plain("int8_decode", checks, launches, ("paged_decode_int8",))
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


# ---------------------------------------------------------------------------
# the cross-attention families: the VLM and the encoder-decoder
# ---------------------------------------------------------------------------
# llama-3.2-vision-11b at full width and depth: four prompts, each with
# its image's 1601 patch embeddings, 32 greedy steps over 1024-token slots
VLM_PROMPTS, VLM_MAX_LEN, VLM_STEPS = (512, 384, 448, 100), 1024, 32
# the seeded init sets every cross gate to 0, and tanh(0) = 0 would
# switch the cross blocks off
VLM_GATE = 0.5
# whisper-tiny at full width: eight decoder prompts, each with its 1500
# audio frames, 64 greedy steps over Whisper's 448-token target length
ENCDEC_PROMPTS = (4, 4, 16, 16, 64, 64, 128, 128)
ENCDEC_MAX_LEN, ENCDEC_STEPS = 448, 64
# the parity phases' prompts: 416 ends in a ragged 32-row tile of the
# flash kernel's 64-row tiles, 100 in a ragged 36-row one
VLM_PARITY_PROMPT, ENCDEC_PARITY_PROMPT = 416, 100


def cross_params(torch, cfg):
    """Seeded bf16 weights on the card; a VLM's cross gates at
    VLM_GATE."""
    from repro_torch.models.model import build_model
    params = build_model(cfg).init_params(0, device="cuda")
    if "cross" in params:
        params["cross"]["gate"].fill_(VLM_GATE)
    return params


def cross_batch(torch, gen, cfg, n, batch=1):
    """Seeded prompt tokens [batch, n] and the memory beside them:
    patches [batch, n_patches, D] or frames [batch, enc_len, D], bf16
    N(0, 1) (the frontends are stubs)."""
    key = "patches" if cfg.n_patches else "frames"
    mem = torch.randn((batch, cfg.n_patches or cfg.enc_len, cfg.d_model),
                      generator=gen, device="cuda").to(torch.bfloat16)
    return {"tokens": torch.randint(0, cfg.vocab_size, (batch, n),
                                    generator=gen, device="cuda")
            .to(torch.int32), key: mem}


def phase_cross_generate(torch, kernel_fns, card, cfg, params, prompts,
                         max_len, steps, phase):
    """Greedy generation of a cross-attention model: each prompt is
    prefilled alone with its memory (the flash prefill kernel in every
    self layer) and its k / v / xk / xv copied into row b of
    ``init_decode_state(len(prompts), max_len)``, then ``steps`` greedy
    decode steps (the paged decode kernel over the slots seen as pages).
    Every count is zeroed just before and read just after.  Checks:
    finite logits, lengths prompt + steps, both kernels launched, the
    state's bytes equal to ``sizing.decode_state_bytes`` exactly, and
    the shortest row's first logits moved by zeroing its memory."""
    from repro_torch.core import sizing
    from repro_torch.models.model import build_model

    model = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(31)
    batches = [cross_batch(torch, gen, cfg, n) for n in prompts]
    key = "patches" if cfg.n_patches else "frames"
    for fn in kernel_fns.values():
        fn.launches = 0
    held = check_held(torch, params, phase)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = model.init_decode_state(len(prompts), max_len, device="cuda")
    first = []
    for b, batch in enumerate(batches):
        logits, st1 = model.prefill(params, batch)
        n = batch["tokens"].shape[1]
        for k in ("k", "v"):
            state[k][:, b, :n] = st1[k][:, 0]
        for k in ("xk", "xv"):
            state[k][:, b] = st1[k][:, 0]
        state["lengths"][b] = n
        first.append(logits)
    del st1
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    first = torch.cat(first)
    finite = [bool(torch.isfinite(first).all())]
    tok = first.argmax(dim=-1).to(torch.int32)
    step_s = []
    for _ in range(steps):
        t = time.perf_counter()
        logits, state = model.decode_step(params, state, tok)
        tok = logits.argmax(dim=-1).to(torch.int32)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        finite.append(bool(torch.isfinite(logits).all()))
    launches = {name: fn.launches for name, fn in kernel_fns.items()}
    peak = torch.cuda.max_memory_allocated()
    state_bytes = sum(t.nbytes for k, t in state.items() if k != "lengths")
    sizing_bytes = sizing.decode_state_bytes(cfg, max_len, len(prompts))
    # the cross path is live: the shortest row with its memory zeroed
    b = min(range(len(prompts)), key=prompts.__getitem__)
    zeroed = dict(batches[b], **{key: torch.zeros_like(batches[b][key])})
    moved = float((model.prefill(params, zeroed)[0] - first[b:b + 1])
                  .float().abs().max())
    lengths = state["lengths"].tolist()
    want = [n + steps for n in prompts]
    emit({"phase": phase, "card": card, "model": cfg.name,
          "layers": cfg.n_layers, "d_model": cfg.d_model,
          "memory": {key: cfg.n_patches or cfg.enc_len},
          "params_gb": tree_bytes(params) / 1e9,
          "rows": len(prompts), "prompt_lens": list(prompts),
          "max_len": max_len, "decode_steps": steps, "prefill_s": prefill_s,
          "decode_step_ms_median": 1e3 * sorted(step_s)[steps // 2],
          "decode_step_ms_mean": 1e3 * sum(step_s) / steps,
          "decode_tok_per_s": len(prompts) * steps / sum(step_s),
          "peak_mem_gb": peak / 1e9, "held_at_start_gb": held,
          "launches": launches, "state_bytes": state_bytes,
          "sizing_bytes": sizing_bytes,
          "zeroed_memory_row": b, "zeroed_memory_logit_moved": moved})
    if not all(finite):
        raise AssertionError(f"{phase}: non-finite logits")
    if lengths != want:
        raise AssertionError(f"{phase}: lengths {lengths} != {want}")
    for name in DENSE_PATH:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"{phase} path")
    if state_bytes != sizing_bytes:
        raise AssertionError(f"{phase}: state {state_bytes} bytes, sizing "
                             f"says {sizing_bytes}")
    if not moved > 0:
        raise AssertionError(f"{phase}: zeroing row {b}'s {key} left its "
                             f"logits unchanged")
    return launches


# what an earlier phase may still hold on the card when a generate phase
# starts, its own weights taken off
HELD_LIMIT_GB = 0.2


def tree_leaves(tree, path=()):
    """(path, tensor) of every leaf of a nested dict."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_leaves(v, path + (k,))
    else:
        yield path, tree


def tree_apply(fn, tree):
    """The same nested dict with ``fn`` applied to every leaf."""
    if isinstance(tree, dict):
        return {k: tree_apply(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_bytes(tree) -> int:
    return sum(t.nbytes for _, t in tree_leaves(tree))


def check_held(torch, params, phase) -> float:
    """The bytes on the card beside ``params`` at a phase's start: what
    earlier phases still hold.  Raises past HELD_LIMIT_GB."""
    torch.cuda.synchronize()
    held = (torch.cuda.memory_allocated() - tree_bytes(params)) / 1e9
    if not held < HELD_LIMIT_GB:
        raise AssertionError(f"{phase}: {held:.3f} GB held at the start "
                             f"beside the phase's weights (limit "
                             f"{HELD_LIMIT_GB} GB)")
    return held


def phase_cross_parity(torch, params, cfg, card, prompt, rows, max_len,
                       phase):
    """One monolithic prefill of ``prompt`` tokens with its memory and
    one decode step over ``rows`` slots of ``max_len`` (random K/V and
    memory keys and values, slots past each row's new token 8x larger)
    with the kernels, with their plain versions, and with plain versions
    that each get one mask wrong by one token, on the same weights.

    The first self layer's prefill attention output is compared too
    (``prefill_attention_layer0``): both runs give that layer the same
    q, k and v, so its gap is the kernel's own rounding, while a
    one-ahead mask error moves its early queries by O(1).  The seeded
    weights' attention adds little to the residual stream (whisper's
    sinusoids dominate it), so that mask error reaches the prompt's K/V
    and last logits only diluted (on whisper at full width 0.25x the
    limit), and the memory's keys and values (projections and plain
    full attention) not at all: those are held to the limit and exempt
    from the mask check (``parity_only``)."""
    from repro_torch.models import attention as attn
    from repro_torch.models.model import build_model

    model = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(97)
    batch = cross_batch(torch, gen, cfg, prompt)
    specs = model.decode_state_specs(rows, max_len)
    lengths = torch.randint(1, max_len - 1, (rows,), generator=gen,
                            device="cuda").to(torch.int32)
    tokens = torch.randint(0, cfg.vocab_size, (rows,), generator=gen,
                           device="cuda").to(torch.int32)
    stale = (torch.arange(max_len, device="cuda")[None, :]
             > lengths.long()[:, None])                       # [B, S]
    state = {"lengths": lengths}
    for k in ("k", "v", "xk", "xv"):
        x = torch.randn(specs[k].shape, generator=gen, device="cuda")
        if k in ("k", "v"):
            x[:, stale] *= STALE_SCALE
        state[k] = x.to(torch.bfloat16)
    at = torch.arange(rows, device="cuda"), lengths.long()

    def run(be):
        outs = []           # the self layers' attention outputs, in order
        causal = attn.causal_attention

        def recorded(*a, **kw):
            outs.append(causal(*a, **kw))
            return outs[-1]
        attn.causal_attention = recorded
        try:
            logits, st = model.prefill(params, batch, backend=be)
        finally:
            attn.causal_attention = causal
        out = {"prefill_logits": logits, "prefill_attention_layer0": outs[0],
               **{"prefill_" + k: st[k] for k in ("k", "v", "xk", "xv")}}
        logits, new = model.decode_step(
            params, {k: t.clone() for k, t in state.items()}, tokens,
            backend=be)
        out.update(decode_logits=logits, decode_new_k=new["k"][:, at[0],
                                                                at[1]],
                   decode_new_v=new["v"][:, at[0], at[1]])
        return out

    runs = {"cuda": run("cuda"), "torch": run("torch")}
    with one_token_mask_errors(torch):
        runs["mutant"] = run("torch")
    parity_report(runs, PARITY_RTOL, card, phase,
                  {"model": cfg.name, "prompt": prompt, "rows": rows},
                  parity_only=("prefill_logits", "prefill_k", "prefill_v",
                               "prefill_xk", "prefill_xv"))


@contextlib.contextmanager
def one_token_mask_errors(torch):
    """Swap in plain versions that each get one mask wrong, the errors a
    kernel's masking could make: decode attends one pool token past the
    row's length, prefill the pool token at the offset (the slot the
    chunk's first token will fill), segment prefill does not exclude the
    slots the chunk will fill; the same three for the MLA versions (the
    MLA chunk prefill of a whole prompt at offset 0, which reads no pool
    token, admits chunk key i + 1 for query i instead); the flash prefill
    admits key i + 1 for query i, and the int8 decode attends one pool
    token past the row's length.  The parity limit must see each of
    them."""
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
        if not bool((offsets > 0).any()):
            b, c = q_lat.shape[:2]
            mask = ref.causal_mask(c, c, 1, q_lat.device).expand(b, c, c)
            return ref._mla_attend(q_lat, q_rope, lat_chunk.float(), mask,
                                   d_latent, scale)
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


# ---------------------------------------------------------------------------
# the recurrent families: the Mamba2 hybrid and RWKV6
# ---------------------------------------------------------------------------
# zamba2-1.2b and rwkv6-1.6b at full width and depth: four prompts (200
# and 100 ragged for SSD's 64-token chunk, 200 for WKV's 16-token chunk
# and past the length where the JAX package's one-chunk fallback
# overflows), 32 greedy steps over 1024-token slots
RECURRENT_PROMPTS, RECURRENT_MAX_LEN, RECURRENT_STEPS = \
    (512, 384, 200, 100), 1024, 32
# the hybrid parity phase's prompt: 416 ends in a ragged 32-row tile of
# the flash kernel's 64-row tiles and a 32-token SSD remainder chunk
HYBRID_PARITY_PROMPT = 416
# teacher forcing at full width: prefill(t[:k]) then j decode steps
# against prefill(t[:k + j]) (k ragged for both chunk sizes), at the bar
# of tests/test_model_consistency.py
TEACHER_K, TEACHER_J = 100, 8
TEACHER_RTOL, TEACHER_ATOL = 0.05, 0.15
# a mixer in float32 on the card against the CPU: within this share of
# the output's largest magnitude
MIXER_RTOL = 1e-4


def spec_bytes(torch, specs) -> int:
    """Bytes of every leaf of a state spec tree but "lengths"."""
    return sum(math.prod(p.shape) * torch.empty(
        (), dtype=getattr(torch, p.dtype or "bfloat16")).element_size()
        for path, p in tree_leaves(specs) if path != ("lengths",))


def copy_row(state, row_state, b, n):
    """Row 0 of a one-prompt prefill state into row b of a batch state:
    K/V slots [:n], every recurrent leaf whole."""
    for path, leaf in tree_leaves(row_state):
        if path == ("lengths",):
            continue
        dst = state
        for k in path:
            dst = dst[k]
        if path in (("k",), ("v",)):
            dst[:, b, :n] = leaf[:, 0]
        else:
            dst[:, b] = leaf[:, 0]
    state["lengths"][b] = n


def step_profile(torch, fn) -> dict:
    """One call of ``fn`` under ``torch.profiler``: the device
    activities it queued (kernels, copies, fills) and their summed
    device time; None where the profiler sees no device activity."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        return {"device_activities": None, "device_busy_ms": None}
    return {"device_activities": len(dev),
            "device_busy_ms": sum(e.time_range.elapsed_us()
                                  for e in dev) / 1e3}


def phase_recurrent_generate(torch, kernel_fns, card, cfg, params, prompts,
                             max_len, steps, phase):
    """Greedy generation of a recurrent model: each prompt is prefilled
    alone and its state (the hybrid's K/V slots and every Mamba leaf;
    RWKV's wkv and token-shift state) copied into row b of
    ``init_decode_state(len(prompts), max_len)``, then ``steps`` greedy
    decode steps.  Every count is zeroed just before and read just
    after.  Checks: finite logits, lengths prompt + steps, the state's
    bytes, and the kernels: the hybrid's shared block launches the flash
    prefill kernel once per application and prompt and the paged decode
    kernel once per application and step; RWKV launches none.  The state
    is the port's own ``decode_state_specs`` (the JAX spec's shapes); for
    RWKV it equals ``sizing.decode_state_bytes``, for the hybrid it is
    smaller by exactly the conv tap the formula counts and the state
    does not keep (K against K-1)."""
    from repro_torch.core import sizing
    from repro_torch.models.model import build_model

    model = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(31)
    prompt_toks = [torch.randint(0, cfg.vocab_size, (1, n), generator=gen,
                                 device="cuda").to(torch.int32)
                   for n in prompts]
    for fn in kernel_fns.values():
        fn.launches = 0
    held = check_held(torch, params, phase)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = model.init_decode_state(len(prompts), max_len, device="cuda")
    first = []
    for b, toks in enumerate(prompt_toks):
        logits, st1 = model.prefill(params, {"tokens": toks})
        copy_row(state, st1, b, toks.shape[1])
        first.append(logits)
    del st1
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    first = torch.cat(first)
    finite = [bool(torch.isfinite(first).all())]
    tok = first.argmax(dim=-1).to(torch.int32)
    step_s, out = [], {}

    def step():
        out["logits"], out["state"] = model.decode_step(params, state, tok)
    for i in range(steps):
        t = time.perf_counter()
        if i == steps // 2:     # the middle step under the profiler
            prof = step_profile(torch, step)
        else:
            step()
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t)
        logits, state = out["logits"], out["state"]
        tok = logits.argmax(dim=-1).to(torch.int32)
        finite.append(bool(torch.isfinite(logits).all()))
    launches = {name: fn.launches for name, fn in kernel_fns.items()}
    peak = torch.cuda.max_memory_allocated()
    state_bytes = sum(t.nbytes for path, t in tree_leaves(state)
                      if path != ("lengths",))
    own_bytes = spec_bytes(torch, model.decode_state_specs(len(prompts),
                                                           max_len))
    sizing_bytes = int(sizing.decode_state_bytes(cfg, max_len,
                                                 len(prompts)))
    hybrid = bool(cfg.attn_layer_ids())
    # the conv tap the formula counts and the state does not keep
    tap_gap = (cfg.n_layers * len(prompts)
               * (cfg.d_inner + 2 * cfg.ssm_state) * 2 if hybrid else 0)
    n_apps = len(cfg.attn_layer_ids())
    want_launches = {"flash_prefill": n_apps * len(prompts),
                     "paged_decode": n_apps * steps}
    lengths = state["lengths"].tolist()
    want = [n + steps for n in prompts]
    emit({"phase": phase, "card": card, "model": cfg.name,
          "layers": cfg.n_layers, "d_model": cfg.d_model,
          "shared_attention_applications": n_apps,
          "params_gb": tree_bytes(params) / 1e9,
          "rows": len(prompts), "prompt_lens": list(prompts),
          "max_len": max_len, "decode_steps": steps, "prefill_s": prefill_s,
          # host clock over the steps but the profiled one
          "decode_step_ms_median": 1e3 * sorted(step_s)[len(step_s) // 2],
          "decode_step_ms_mean": 1e3 * sum(step_s) / len(step_s),
          "decode_tok_per_s": len(prompts) * len(step_s) / sum(step_s),
          "profiled_step": {"step": steps // 2, **prof},
          "peak_mem_gb": peak / 1e9, "held_at_start_gb": held,
          "launches": launches, "state_bytes": state_bytes,
          "spec_bytes": own_bytes, "sizing_bytes": sizing_bytes,
          "sizing_gap_bytes": sizing_bytes - state_bytes})
    if not all(finite):
        raise AssertionError(f"{phase}: non-finite logits")
    if lengths != want:
        raise AssertionError(f"{phase}: lengths {lengths} != {want}")
    for name, n in launches.items():
        if n != want_launches.get(name, 0) * hybrid:
            raise AssertionError(f"{phase}: kernel {name} launched {n} "
                                 f"times")
    if state_bytes != own_bytes or sizing_bytes - state_bytes != tap_gap:
        raise AssertionError(f"{phase}: state {state_bytes} bytes, specs "
                             f"{own_bytes}, sizing {sizing_bytes} (gap "
                             f"expected {tap_gap})")
    return launches


def phase_hybrid_parity(torch, params, cfg, card, prompt, rows, max_len,
                        phase="hybrid_parity"):
    """One monolithic prefill of ``prompt`` tokens and one decode step
    over ``rows`` slots of ``max_len`` (random K/V, slots past each
    row's new token 8x larger, random Mamba state) with the kernels,
    with their plain versions, and with plain versions that each get one
    mask wrong by one token, on the same weights.  Held to the limit: the
    logits, the first shared application's prefill attention output
    (both runs give it the same q, k and v), every application's K/V,
    the decode's new K/V, and the Mamba state after the prompt and after
    the step.  A one-ahead prompt mask error reaches the last position's
    logits and the Mamba state only diluted through the residual stream
    (the last query has no key ahead of it; on the card 0.46x and 0.43x
    the limit), so those are exempt from the mask check
    (``parity_only``); the first application's output, the later
    applications' K/V and the decode's tensors see it (on the card
    7.9x-16x)."""
    from repro_torch.models import attention as attn
    from repro_torch.models.model import build_model

    model = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(97)
    tokens = torch.randint(0, cfg.vocab_size, (1, prompt), generator=gen,
                           device="cuda").to(torch.int32)
    specs = model.decode_state_specs(rows, max_len)
    lengths = torch.randint(1, max_len - 1, (rows,), generator=gen,
                            device="cuda").to(torch.int32)
    dtokens = torch.randint(0, cfg.vocab_size, (rows,), generator=gen,
                            device="cuda").to(torch.int32)
    stale = (torch.arange(max_len, device="cuda")[None, :]
             > lengths.long()[:, None])                       # [B, S]
    state = {"lengths": lengths,
             "mamba": {k: torch.randn(p.shape, generator=gen,
                                      device="cuda").to(torch.bfloat16)
                       for k, p in specs["mamba"].items()}}
    for k in ("k", "v"):
        x = torch.randn(specs[k].shape, generator=gen, device="cuda")
        x[:, stale] *= STALE_SCALE
        state[k] = x.to(torch.bfloat16)
    at = torch.arange(rows, device="cuda"), lengths.long()

    def run(be):
        outs = []           # the shared applications' attention outputs
        causal = attn.causal_attention

        def recorded(*a, **kw):
            outs.append(causal(*a, **kw))
            return outs[-1]
        attn.causal_attention = recorded
        try:
            logits, st = model.prefill(params, {"tokens": tokens},
                                       backend=be)
        finally:
            attn.causal_attention = causal
        out = {"prefill_logits": logits, "prefill_attention_app0": outs[0],
               "prefill_k": st["k"], "prefill_v": st["v"],
               **{"prefill_mamba_" + k: t for k, t in st["mamba"].items()}}
        fresh = {"lengths": lengths,
                 **{k: state[k].clone() for k in ("k", "v")},
                 "mamba": {k: t.clone() for k, t in state["mamba"].items()}}
        logits, new = model.decode_step(params, fresh, dtokens, backend=be)
        out.update(decode_logits=logits,
                   decode_new_k=new["k"][:, at[0], at[1]],
                   decode_new_v=new["v"][:, at[0], at[1]],
                   decode_mamba_ssm=new["mamba"]["ssm"])
        return out

    runs = {"cuda": run("cuda"), "torch": run("torch")}
    with one_token_mask_errors(torch):
        runs["mutant"] = run("torch")
    parity_report(runs, PARITY_RTOL, card, phase,
                  {"model": cfg.name, "prompt": prompt, "rows": rows},
                  parity_only=("prefill_logits",)
                  + tuple(k for k in runs["torch"] if "_mamba_" in k))


def teacher_gap(torch, model, params, toks):
    """prefill(toks[:, :k]) then TEACHER_J decode steps of the next
    tokens, against prefill(toks) (k = TEACHER_K): (largest gap, largest
    reference magnitude, within the bar)."""
    ref, _ = model.prefill(params, {"tokens": toks})
    lg, state = model.prefill(params, {"tokens": toks[:, :TEACHER_K]})
    # the hybrid's K/V slots, grown to hold j more tokens in whole
    # 64-token pages
    grow = TEACHER_J + (-(TEACHER_K + TEACHER_J)) % 64
    for k in ("k", "v"):
        if k in state:
            x = state[k]
            state[k] = torch.cat([x, x.new_zeros(
                x.shape[:2] + (grow,) + x.shape[3:])], dim=2)
    for j in range(TEACHER_J):
        lg, state = model.decode_step(params, state,
                                      toks[:, TEACHER_K + j].contiguous())
    a, b = lg.float(), ref.float()
    ok = bool(((a - b).abs() <= TEACHER_ATOL + TEACHER_RTOL * b.abs()).all())
    return float((a - b).abs().max()), float(b.abs().max()), ok


def mixer_layer0(params, cfg):
    """Layer 0's sequence mixer of the model (``mamba_block`` or
    ``time_mix``) and its params, float32 on the CPU."""
    from repro_torch.models import rwkv, ssm
    lp = tree_apply(lambda t: t[0].float().cpu(), params["layers"])
    if "mamba" in lp:
        return "mamba_block", lp["mamba"], \
            lambda p, x: ssm.mamba_block(p, x, cfg)
    return "time_mix", lp, lambda p, x: rwkv.time_mix(p, x, cfg)


def phase_recurrent_checks(torch, card, cfg, params, phase):
    """At full width: the port's decode against teacher forcing in
    float32 (held to the bar of tests/test_model_consistency.py) with
    the bf16 gap beside it (a finding, not held), and layer 0's mixer in
    float32 on the card against the CPU on the same input (held to
    MIXER_RTOL of the output's largest magnitude)."""
    from repro_torch.models.model import build_model

    model = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(41)
    toks = torch.randint(0, cfg.vocab_size, (1, TEACHER_K + TEACHER_J),
                         generator=gen, device="cuda").to(torch.int32)
    res = {"phase": phase, "card": card, "model": cfg.name,
           "teacher_k": TEACHER_K, "teacher_j": TEACHER_J,
           "rtol": TEACHER_RTOL, "atol": TEACHER_ATOL}
    res["bf16_gap"], res["bf16_max_abs"], res["bf16_within_bar"] = \
        teacher_gap(torch, model, params, toks)
    f32 = tree_apply(lambda t: t.float(), params)
    res["f32_gap"], res["f32_max_abs"], ok = teacher_gap(torch, model, f32,
                                                         toks)
    del f32
    torch.cuda.empty_cache()
    name, lp, mixer = mixer_layer0(params, cfg)
    x = torch.randn((1, 256, cfg.d_model),
                    generator=torch.Generator().manual_seed(43))
    want = mixer(lp, x)
    got = mixer({k: v.cuda() for k, v in lp.items()}, x.cuda()).cpu()
    scale = float(want.abs().max())
    res.update(mixer=name, mixer_max_abs_diff=float((got - want).abs()
                                                    .max()),
               mixer_max_abs=scale, mixer_tol=MIXER_RTOL * scale)
    emit(res)
    if not ok:
        raise AssertionError(f"{phase}: float32 decode misses teacher "
                             f"forcing: {res}")
    if not res["mixer_max_abs_diff"] <= res["mixer_tol"]:
        raise AssertionError(f"{phase}: layer 0's {name} on the card "
                             f"differs from the CPU's: {res}")


# ---------------------------------------------------------------------------
# training: the flash prefill backward, the train step, its parity,
# resume and the other families' train_loss
# ---------------------------------------------------------------------------
# Backward kernel vs plain version: both recompute the softmax and sum in
# float32 (another order), so a bf16 gradient may round to a neighbouring
# bf16 value: each of dq, dk, dv is held to two bf16 steps of its largest
# magnitude (2^-6 of it, which counts as at least 1: with one token dQ
# and dK are zero but for rounding); float32 to 1e-4 of it, the CPU
# parity bar.  The library's backward (SDPA, bf16 probabilities) is held
# to 2^-4 of it: it only guards against timing another function.
BWD_RTOL = {"bfloat16": 2.0 ** -6, "float32": 1e-4}
LIBRARY_BWD_RTOL = 2.0 ** -4
# (name, B, S, Hq, Hkv, dk, dv, dtype) of the backward rows: llama3.2-1b's
# training micro-step (4 sequences of 1024), the ragged 1000,
# llama-3.2-vision's 32 / 8 heads at hd 128 and whisper-tiny's 6 / 6
# (G 1) at the train_families phase's lengths, and a float32 case; then
# DeepSeek-V3's train_mla micro-step (2 x 1024, 128 / 128 heads, Q/K 192
# over V 128: the non-absorbed MLA form), the ragged 1000 and a float32
# case
BWD_CASES = (("flash_prefill_bwd", 4, 1024, 32, 8, 64, 64, "bfloat16"),
             ("flash_prefill_bwd_ragged", 4, 1000, 32, 8, 64, 64,
              "bfloat16"),
             ("flash_prefill_bwd_vlm", 1, 512, 32, 8, 128, 128, "bfloat16"),
             ("flash_prefill_bwd_whisper", 2, 448, 6, 6, 64, 64, "bfloat16"),
             ("flash_prefill_bwd_f32", 1, 512, 32, 8, 64, 64, "float32"),
             ("flash_prefill_bwd_mla", 2, 1024, 128, 128, 192, 128,
              "bfloat16"),
             ("flash_prefill_bwd_mla_ragged", 2, 1000, 128, 128, 192, 128,
              "bfloat16"),
             ("flash_prefill_bwd_mla_f32", 1, 256, 128, 128, 192, 128,
              "float32"),
             # the train demo's micro-step (reduced llama3.2-1b, the
             # examples phase)
             ("flash_prefill_bwd_demo", 4, 64, 4, 2, 16, 16, "bfloat16"))
# (name, B, S, Hq, Hkv, dk, dv) of the forward-with-lse rows: the train
# and train_mla phases' micro-steps
LSE_CASES = (("flash_prefill_lse", 4, 1024, 32, 8, 64, 64),
             ("flash_prefill_lse_mla", 2, 1024, 128, 128, 192, 128))
# the train phase: llama3.2-1b at full width and depth, 8 sequences of
# 1024 tokens a step in two micro-steps of 4, 6 AdamW steps under the
# optimizer's default schedule (AdamWConfig(): lr 3e-4, 100 warmup
# steps).  A 2-step warmup to 1e-3 makes the first update a sign step of
# 5e-4 on every weight, and at this width the loss then jumps (12.15 ->
# 18.25), with the kernels and with the plain versions alike
# (scripts/train_schedule_probe.py).
TRAIN_SEQ, TRAIN_BATCH, TRAIN_MICRO, TRAIN_STEPS = 1024, 8, 2, 6
# train_mla: DeepSeek-V3 at every published width, the depth cut to
# TRAIN_MLA_LAYERS of 61; 4 sequences of 1024 a step in TRAIN_MICRO
# micro-steps, TRAIN_STEPS steps at TRAIN_ADAMW.  One layer: the
# functional AdamW update holds the old and the new float32 master and
# moments (24 bytes a parameter) beside the float32 gradients and both
# bf16 trees; at two layers (2.35 B parameters) it ran out of the 80 GB
# card with 75.81 GB allocated, at one (1.64 B) the peak was 59.21 GB
# (``--mla-depth-probe``, NVIDIA H100 80GB HBM3, 700 W).
# train_mla_parity: one layer, 2 x 512 tokens in TRAIN_MICRO micro-steps
# (1 x 512 each)
TRAIN_MLA_LAYERS, TRAIN_MLA_BATCH = 1, 4
TRAIN_MLA_PARITY_SEQ, TRAIN_MLA_PARITY_BATCH = 512, 2
MLA_ATTN_LEAVES = ("wq", "w_dkv", "w_kr", "w_uk", "w_uv", "wo")
# the train phase's median step when the backward ran its bf16 inputs on
# the float32 CUDA-core body (NVIDIA H100 80GB HBM3, 700 W), printed
# beside this run's
CUDA_CORE_BWD_TRAIN = {"step_ms_median": 559.2,
                       "tokens_per_s_median": 14649}
TRAIN_ADAMW = dict(lr=3e-4, warmup_steps=100, total_steps=10_000)
# train_parity / train_resume: the same step with the depth cut to 2
TRAIN_SHORT_LAYERS = 2
# train_parity, kernels vs plain versions on the card (bf16 model): each
# gradient leaf within 2^-4 of its largest magnitude (the serving parity
# bar), the loss within 2^-8 of itself
TRAIN_PARITY_RTOL, TRAIN_LOSS_RTOL = 2.0 ** -4, 2.0 ** -8
# (name, layers kept, B, S) of train_families: full width, depth cut so
# that each family keeps every kind of block (zamba2: 6 Mamba2 layers and
# one application of the shared block; the VLM: two cross groups)
TRAIN_FAMILIES = (("zamba2-1.2b", 6, 2, 512), ("rwkv6-1.6b", 4, 2, 512),
                  ("whisper-tiny", None, 2, 448),
                  ("llama-3.2-vision-11b", 10, 1, 512))




def kernel_split_ms(torch, fn, calls: int = 5) -> dict:
    """Device ms a call of each kernel ``fn`` launches (``bwd_delta``,
    ``bwd_dkdv_tc``, ...), from ``torch.profiler`` over ``calls`` calls
    (L2 warm); None where the profiler sees no device activity."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        m = re.search(r"\b(bwd_\w+)", e.name)
        key = m.group(1) if m else e.name
        by_name[key] = by_name.get(key, 0.0) + e.time_range.elapsed_us()
    if not by_name:
        return None
    return {k: us / calls / 1e3 for k, us in sorted(by_name.items())}


def sdpa_backend(torch, q, k, v, do):
    """The first of PyTorch's SDPA backends (flash, cuDNN, efficient,
    math) that takes causal attention on these [B, H, S, d] inputs
    forward and backward (forward only when ``do`` is None; GQA where k
    has fewer heads than q), tried alone under ``sdpa_kernel``: for Q/K
    wider than V, where the flash backend refuses, and for the long
    cases.  Its name and a context that selects it."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    for be in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
               SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        qh, kh, vh = (t.detach().requires_grad_(do is not None)
                      for t in (q, k, v))
        try:
            with sdpa_kernel(be):
                out = F.scaled_dot_product_attention(
                    qh, kh, vh, is_causal=True,
                    enable_gqa=qh.shape[1] != kh.shape[1])
                if do is not None:
                    torch.autograd.grad(out, (qh, kh, vh), do)
            torch.cuda.synchronize()
        except RuntimeError:
            continue
        return be.name, (lambda be=be: sdpa_kernel(be))
    raise AssertionError("no SDPA backend takes these inputs")


def bwd_case(torch, gen, name, B, S, Hq, Hkv, dk, dv, dtype):
    """A backward's inputs: q, k, v, dO drawn N(0, 1), o and lse from the
    forward kernel; the library yardstick is the backward of
    F.scaled_dot_product_attention (causal, GQA) on the same values, its
    graph built once: by PyTorch's own choice of backend when dk == dv,
    else on ``sdpa_backend``'s (its name the fourth element, else
    None)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_prefill import flash_prefill
    dt = getattr(torch, dtype)
    q = torch.randn((B, S, Hq, dk), generator=gen, device="cuda").to(dt)
    do = torch.randn((B, S, Hq, dv), generator=gen, device="cuda").to(dt)
    k = torch.randn((B, S, Hkv, dk), generator=gen, device="cuda").to(dt)
    v = torch.randn((B, S, Hkv, dv), generator=gen, device="cuda").to(dt)
    o, lse = flash_prefill(q, k, v, backend="cuda", with_lse=True)
    a = dict(q=q, k=k, v=v, o=o, do=do, lse=lse)
    qh, kh, vh = (t.transpose(1, 2).contiguous().requires_grad_(True)
                  for t in (q, k, v))
    doh = do.transpose(1, 2).contiguous()
    backend, ctx = None, contextlib.nullcontext
    if dk != dv:
        backend, ctx = sdpa_backend(torch, qh, kh, vh, doh)
    with ctx():
        out = F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True, enable_gqa=dk == dv or Hq != Hkv)

    def sdpa_bwd():
        with ctx():
            return tuple(g.transpose(1, 2) for g in torch.autograd.grad(
                out, (qh, kh, vh), doh, retain_graph=True))
    return name, a, sdpa_bwd, backend


def lse_row(torch, gen, name, B, S, Hq, Hkv, dk, dv):
    """The forward kernel with its lse on bf16 N(0, 1) inputs: output
    within KERNEL_ATOL and lse within 1e-4 of its largest magnitude of
    the plain forward and ``ref.flash_prefill_lse``; timed with and
    without lse, beside the plain version and SDPA's forward (on
    ``sdpa_backend``'s backend when dk != dv)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_prefill import flash_prefill
    q = torch.randn((B, S, Hq, dk), generator=gen, device="cuda").bfloat16()
    k = torch.randn((B, S, Hkv, dk), generator=gen, device="cuda").bfloat16()
    v = torch.randn((B, S, Hkv, dv), generator=gen, device="cuda").bfloat16()
    out, lse = flash_prefill(q, k, v, backend="cuda", with_lse=True)
    torch.cuda.synchronize()
    plain_out = flash_prefill(q, k, v, backend="torch")
    plain_lse = ref.flash_prefill_lse(q, k)
    err = float((out.float() - plain_out.float()).abs().max())
    lse_err = float((lse - plain_lse).abs().max())
    lse_tol = 1e-4 * float(plain_lse.abs().max())
    if not (err <= KERNEL_ATOL and lse_err <= lse_tol):
        raise AssertionError(f"{name}: output gap {err} (tol "
                             f"{KERNEL_ATOL}), lse gap {lse_err} (tol "
                             f"{lse_tol})")
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    backend, ctx = None, contextlib.nullcontext
    if dk != dv:
        backend, ctx = sdpa_backend(torch, qh, kh, vh,
                                    plain_out.transpose(1, 2).contiguous())

    def sdpa():
        with ctx():
            return F.scaled_dot_product_attention(
                qh, kh, vh, is_causal=True, enable_gqa=dk == dv or Hq != Hkv)
    lib_err = float((sdpa().transpose(1, 2).float()
                     - plain_out.float()).abs().max())
    if not lib_err <= LIBRARY_ATOL:
        raise AssertionError(f"{name}: the library yardstick differs from "
                             f"the plain version by {lib_err}")
    nbytes, flops = cost.flash_cost({"q": q, "k": k, "v": v})
    nbytes += lse.numel() * 4
    bound_ms, bound_by = cost.bound(nbytes, flops)
    kt = time_ms(torch, lambda: flash_prefill(q, k, v, backend="cuda",
                                              with_lse=True))
    no_lse = time_ms(torch, lambda: flash_prefill(q, k, v, backend="cuda"))
    pt = time_ms(torch, lambda: flash_prefill(q, k, v, backend="torch",
                                              with_lse=True), iters=5)
    lt = time_ms(torch, sdpa)
    return {"body": kernel_body("flash_prefill", {"q": q, "v": v}),
            "shape": [B, S, Hq, Hkv, dk, dv], "max_abs_err": err,
            "lse_max_abs_err": lse_err, "tol": KERNEL_ATOL,
            "lse_tol": lse_tol, "ms": kt["ms"],
            "ms_without_lse": no_lse["ms"], "plain_ms": pt["ms"],
            "flush_ms": kt["flush_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "bytes": nbytes, "flops": flops,
            "tflops": flops / kt["ms"] / 1e9, "library_ms": lt["ms"],
            "library_backend": backend, "library_max_abs_err": lib_err}


def phase_train_kernels(torch, card):
    """The backward kernel at BWD_CASES against its plain version (each of
    dq, dk, dv within BWD_RTOL of its largest magnitude), both timed, the
    SDPA backward beside them; then the forward kernel with its lse at
    the train and train_mla steps' micro-steps (LSE_CASES:
    ``flash_prefill_lse``, ``flash_prefill_lse_mla``), SDPA's forward
    beside it.  One JSON line per row, in the kernels phase."""
    from repro_torch.kernels.flash_prefill import (bwd_kv_chunk,
                                                   bwd_kv_parts, bwd_kv_tile,
                                                   bwd_per_sm,
                                                   flash_prefill_bwd)
    from repro_torch.kernels.paged_attention import DTYPE_CODES
    gen = torch.Generator(device="cuda").manual_seed(2222)
    rows = {}
    for case in BWD_CASES:
        name, a, library, lib_backend = bwd_case(torch, gen, *case)
        got = flash_prefill_bwd(**a, backend="cuda")
        torch.cuda.synchronize()
        plain = flash_prefill_bwd(**a, backend="torch")
        rtol = BWD_RTOL[case[-1]]
        errs, scales = [], []
        for g, p in zip(got, plain):
            errs.append(float((g.float() - p.float()).abs().max()))
            scales.append(max(1.0, float(p.float().abs().max())))
            if not (bool(torch.isfinite(g).all())
                    and errs[-1] <= rtol * scales[-1]):
                raise AssertionError(f"{name}: kernel vs plain gap "
                                     f"{errs[-1]} (limit {rtol} x "
                                     f"{scales[-1]})")
        lib = library()
        lib_err = max(float((g.float() - p.float()).abs().max()) / s
                      for g, p, s in zip(lib, plain, scales))
        if not lib_err <= LIBRARY_BWD_RTOL:
            raise AssertionError(f"{name}: the library yardstick differs "
                                 f"from the plain version by {lib_err} of "
                                 f"the largest magnitude")
        del got, plain, lib
        nbytes, flops, peak = cost.bwd_cost(a)
        code = DTYPE_CODES[a["q"].dtype]
        plan = (*case[1:5], bwd_kv_tile(case[5], case[6], code),
                bwd_per_sm(case[5], case[6], code))
        kt = time_ms(torch, lambda: flash_prefill_bwd(**a, backend="cuda"))
        pt = time_ms(torch, lambda: flash_prefill_bwd(**a, backend="torch"),
                     iters=5)
        lt = time_ms(torch, library)
        t_bytes, t_ops = nbytes / h100.HBM_BW, flops / peak
        rows[name] = {
            "body": kernel_body(name, a), "shape": list(case[1:7]),
            "dtype": case[-1], "kv_tile": plan[4], "per_sm": plan[5],
            "kv_chunk": bwd_kv_chunk(*plan),
            "kv_parts": bwd_kv_parts(*plan),
            "max_abs_err": max(errs), "max_abs_err_dq_dk_dv": errs,
            "tol": [rtol * s for s in scales], "ms": kt["ms"],
            "plain_ms": pt["ms"], "flush_ms": kt["flush_ms"],
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops, "peak_flops": peak,
            "tflops": flops / kt["ms"] / 1e9, "library_ms": lt["ms"],
            "library_backend": lib_backend,
            "library_max_rel_err": lib_err}
        if name in ("flash_prefill_bwd", "flash_prefill_bwd_mla"):
            rows[name]["kernel_split_ms"] = kernel_split_ms(
                torch, lambda: flash_prefill_bwd(**a, backend="cuda"))
        emit({"phase": "kernels", "card": card, "kernel": name,
              **rows[name]})
        del a, library

    # the forward with its lse at one micro-step of each train phase
    for name, *shape in LSE_CASES:
        rows[name] = lse_row(torch, gen, name, *shape)
        emit({"phase": "kernels", "card": card, "kernel": name,
              **rows[name]})
    return rows


# kernels 7 and 7b where they set the pace on the card, (name, B, S, Hq,
# Hkv, hd, backward): dryrun_card's prefill (8 x 32768, kernel 7 with its
# lse, 16 launches a step) and its train cell's micro-batch (4 x 4096:
# 256 launches of 7 and 128 of 7b a step)
LONG_CASES = (("flash_prefill_32k", 8, 32768, 32, 8, 64, False),
              ("flash_prefill_4k", 4, 4096, 32, 8, 64, False),
              ("flash_prefill_bwd_4k", 4, 4096, 32, 8, 64, True))
# the plain version's share: the last LONG_SLICE queries of sequence 0
LONG_SLICE = 512
LONG_ITERS = 3
FLASH_PAIRS = ((16, 16), (32, 32), (64, 64), (128, 128), (192, 128),
               (256, 256))


def plain_slice(torch, q, k, v, do=None):
    """The plain version on the last LONG_SLICE queries of sequence 0
    against all its keys, in float32: ``ref._attend`` with the causal
    mask at offset S - LONG_SLICE -> (output [1, C, Hq, dv], lse [1, Hq,
    C] in natural-log units, and with ``do`` the gradients by autograd
    through it, else None: the rows' dQ [1, C, Hq, dk] and dK, dV of the
    last C keys [1, C, Hkv, d], whole, since only these rows attend
    them)."""
    from repro_torch.kernels import ref
    S, hq, hd = q.shape[1], q.shape[2], q.shape[3]
    hkv, off = k.shape[2], S - LONG_SLICE
    grad = do is not None
    qs = q[:1, off:].float().requires_grad_(grad)
    kf, vf = (t[:1].float().requires_grad_(grad) for t in (k, v))
    mask = (torch.arange(S, device=q.device)[None, :]
            <= torch.arange(off, S, device=q.device)[:, None])[None]
    out = ref._attend(qs, kf, vf, mask)
    sc = torch.einsum("bchgd,bthd->bchgt",
                      qs.detach().reshape(1, LONG_SLICE, hkv, hq // hkv, hd),
                      kf.detach()) / math.sqrt(hd)
    sc = sc.masked_fill(~mask[:, :, None, None, :], float("-inf"))
    lse = torch.logsumexp(sc, dim=-1).reshape(1, LONG_SLICE, hq)
    del sc
    grads = None
    if grad:
        dq, dk, dv = torch.autograd.grad(out, (qs, kf, vf),
                                         do[:1, off:].float())
        grads = (dq, dk[:, off:], dv[:, off:])
    return out.detach(), lse.transpose(1, 2), grads


def phase_flash_long(torch, card):
    """LONG_CASES: each kernel held on the whole to SDPA (on
    ``sdpa_backend``'s backend; forward within LIBRARY_ATOL, each
    gradient within LIBRARY_BWD_RTOL of its own largest magnitude) and on
    the slice to the plain version (``plain_slice``; lse within 1e-4 of
    its largest magnitude, the output and dQ, dK, dV each within
    BWD_RTOL of its own largest magnitude there: two bf16 steps, where
    KERNEL_ATOL's |o| < 4 would be loose, since a row that averages 32k
    keys has outputs of a few hundredths); timed over LONG_ITERS launches
    beside SDPA, with bound and TFLOP/s.  First the body each C entry runs at FLASH_PAIRS: bf16
    at (64, 64), (128, 128) and (192, 128) must be "wgmma"."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_prefill import (body, bwd_body,
                                                   check_widths,
                                                   flash_prefill,
                                                   flash_prefill_bwd)
    from repro_torch.kernels.paged_attention import DTYPE_CODES
    bodies = {}
    for dk, dv in FLASH_PAIRS:
        for dt in ("bfloat16", "float32"):
            code = DTYPE_CODES[getattr(torch, dt)]
            entry = {"forward": body(dk, dv, code)}
            try:
                check_widths("", dk, dv, backward=True)
                entry["backward"] = bwd_body(dk, dv, code)
            except ValueError:
                pass
            bodies[f"{dk}/{dv} {dt}"] = entry
    emit({"phase": "flash_long", "card": card, "bodies": bodies})
    for dk, dv in ((64, 64), (128, 128), (192, 128)):
        if set(bodies[f"{dk}/{dv} bfloat16"].values()) != {"wgmma"}:
            raise AssertionError(f"flash_long: bf16 ({dk}, {dv}) runs "
                                 f"{bodies[f'{dk}/{dv} bfloat16']}")
    gen = torch.Generator(device="cuda").manual_seed(3333)
    rows = {}
    for name, B, S, Hq, Hkv, hd, backward in LONG_CASES:
        def rn(*shape):
            return torch.randn(shape, generator=gen,
                               device="cuda").bfloat16()
        q, k, v = rn(B, S, Hq, hd), rn(B, S, Hkv, hd), rn(B, S, Hkv, hd)
        out, lse = flash_prefill(q, k, v, backend="cuda", with_lse=True)
        do = rn(B, S, Hq, hd) if backward else None
        torch.cuda.synchronize()
        qh, kh, vh = (t.transpose(1, 2).contiguous().requires_grad_(backward)
                      for t in (q, k, v))
        doh = (do if backward else out).transpose(1, 2).contiguous()
        lib_backend, ctx = sdpa_backend(torch, qh, kh, vh, doh)
        with ctx():
            lib_out = F.scaled_dot_product_attention(qh, kh, vh,
                                                     is_causal=True,
                                                     enable_gqa=Hq != Hkv)
        po, pl, pgrads = plain_slice(torch, q, k, v, do)
        off = S - LONG_SLICE
        rtol = BWD_RTOL["bfloat16"]
        row = {"body": None, "shape": [B, S, Hq, Hkv, hd, hd],
               "slice": [0, off, S], "library_backend": lib_backend}
        if backward:
            grads = flash_prefill_bwd(q, k, v, out, do, lse, backend="cuda")

            def sdpa_bwd():
                with ctx():
                    return torch.autograd.grad(lib_out, (qh, kh, vh), doh,
                                               retain_graph=True)
            lib_err = max(
                float((g.float() - lg.transpose(1, 2).float()).abs().max())
                / float(lg.float().abs().max())
                for g, lg in zip(grads, sdpa_bwd()))
            errs = [float((g[:1, off:].float() - p).abs().max())
                    for g, p in zip(grads, pgrads)]
            tols = [rtol * float(p.abs().max()) for p in pgrads]
            ok = (all(e <= t for e, t in zip(errs, tols))
                  and lib_err <= LIBRARY_BWD_RTOL)
            row.update(body=kernel_body("flash_prefill_bwd", {"q": q, "v": v}),
                       max_abs_err=max(errs), max_abs_err_dq_dk_dv=errs,
                       tol=tols, err_of="dq, dk, dv on the slice",
                       library_max_rel_err=lib_err)
            nbytes, flops, peak = cost.bwd_cost(
                {"q": q, "k": k, "v": v, "o": out, "lse": lse})
            del grads
            fn = (lambda: flash_prefill_bwd(q, k, v, out, do, lse,
                                            backend="cuda"))
            lib_fn = sdpa_bwd
        else:
            lib_err = float((lib_out.transpose(1, 2).float()
                             - out.float()).abs().max())
            err = float((out[:1, off:].float() - po).abs().max())
            tol = rtol * float(po.abs().max())
            lse_err = float((lse[:1, :, off:] - pl).abs().max())
            lse_tol = 1e-4 * float(pl.abs().max())
            ok = (err <= tol and lse_err <= lse_tol
                  and lib_err <= LIBRARY_ATOL)
            row.update(body=kernel_body("flash_prefill", {"q": q, "v": v}),
                       max_abs_err=err, tol=tol,
                       err_of="output on the slice", lse_max_abs_err=lse_err,
                       lse_tol=lse_tol, library_max_abs_err=lib_err)
            nbytes, flops = cost.flash_cost({"q": q, "k": k, "v": v})
            nbytes += lse.numel() * 4
            peak = h100.PEAK_FLOPS_BF16
            fn = (lambda: flash_prefill(q, k, v, backend="cuda",
                                        with_lse=True))

            def lib_fn():
                with ctx():
                    return F.scaled_dot_product_attention(
                        qh, kh, vh, is_causal=True, enable_gqa=Hq != Hkv)
        del po, pl, pgrads
        if not ok or row["body"] != "wgmma":
            raise AssertionError(f"{name}: {row}")
        kt = time_ms(torch, fn, iters=LONG_ITERS, warmup=1)
        lt = time_ms(torch, lib_fn, iters=LONG_ITERS, warmup=1)
        t_bytes, t_ops = nbytes / h100.HBM_BW, flops / peak
        row.update(ms=kt["ms"], flush_ms=kt["flush_ms"],
                   bound_ms=max(t_bytes, t_ops) * 1e3,
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   bytes=nbytes, flops=flops,
                   tflops=flops / kt["ms"] / 1e9, library_ms=lt["ms"],
                   plain_ms=None)
        emit({"phase": "kernels", "card": card, "kernel": name, **row})
        rows[name] = row
        del q, k, v, out, lse, do, qh, kh, vh, doh, lib_out, fn, lib_fn
        torch.cuda.empty_cache()
    return rows


def train_setup(torch, cfg, seed=0, batch=TRAIN_BATCH, seq=TRAIN_SEQ):
    """(model, seeded bf16 params on the card, the seekable data stream)
    of a training phase."""
    from repro_torch.models.model import build_model
    from repro_torch.training import data as data_mod
    model = build_model(cfg)
    params = model.init_params(seed, device="cuda")
    data = data_mod.SyntheticLM(data_mod.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch))
    return model, params, data


def train_batch(torch, data, cfg, step, batch=TRAIN_BATCH):
    from repro_torch.launch.train import make_batch
    return make_batch(data, cfg, step, batch, "cuda")


def phase_train(torch, kernel_fns, card, cfg, phase="train",
                batch=TRAIN_BATCH, reference=CUDA_CORE_BWD_TRAIN):
    """TRAIN_STEPS AdamW steps of ``cfg`` (llama3.2-1b at full width and
    depth; ``train_mla``: DeepSeek-V3 at TRAIN_MLA_LAYERS layers) through
    ``make_train_step`` (``n_micro`` TRAIN_MICRO, ``batch`` sequences of
    TRAIN_SEQ a step), every count zeroed just before and read just
    after; then one more step under the profiler.  Each step's loss, host
    time (ending in a synchronise) and the host's time until the step
    returned, tokens/s; the peak memory.  Checks: every loss finite, the
    last below the first, and the launches: under remat each layer's
    forward runs twice a micro-step (the forward, then its recompute in
    the backward), so kernel 7 launches 2 x layers x micro-steps a step
    and the backward kernel layers x micro-steps."""
    from repro_torch.training import optimizer as opt_mod
    from repro_torch.training import train as train_mod
    model, params, data = train_setup(torch, cfg, batch=batch)
    held = check_held(torch, params, phase)
    opt_state = opt_mod.init_state(params)
    step_fn = train_mod.make_train_step(
        model, adamw=opt_mod.AdamWConfig(**TRAIN_ADAMW), n_micro=TRAIN_MICRO)
    state_gb = sum(tree_bytes(t) for t in (opt_state.master, opt_state.m,
                                           opt_state.v)) / 1e9
    for fn in kernel_fns.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for s in range(TRAIN_STEPS):
        b_s = train_batch(torch, data, cfg, s, batch)
        t0 = time.perf_counter()
        params, opt_state, m = step_fn(params, opt_state, b_s)
        queued = time.perf_counter() - t0
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        steps.append({"step": s, "loss": float(m["loss"]),
                      "lr": float(m["lr"]), "grad_norm": float(m["grad_norm"]),
                      "ms": dt * 1e3, "host_queue_ms": queued * 1e3,
                      "tokens_per_s": batch * TRAIN_SEQ / dt})
        emit({"phase": phase, "card": card, **steps[-1]})
    launches = {name: fn.launches for name, fn in kernel_fns.items()}
    peak = torch.cuda.max_memory_allocated()
    b_s = train_batch(torch, data, cfg, TRAIN_STEPS, batch)
    out = {}

    def one_step():
        out["r"] = step_fn(params, opt_state, b_s)
    t0 = time.perf_counter()
    prof = step_profile(torch, one_step)
    wall_ms = (time.perf_counter() - t0) * 1e3
    del out
    per_step = {"flash_prefill": 2 * cfg.n_layers * TRAIN_MICRO,
                "flash_prefill_bwd": cfg.n_layers * TRAIN_MICRO}
    want = {name: per_step.get(name, 0) * TRAIN_STEPS for name in launches}
    losses = [r["loss"] for r in steps]
    ms = sorted(r["ms"] for r in steps[1:])     # step 0 builds caches
    emit({"phase": phase, "card": card, "model": cfg.name,
          "layers": cfg.n_layers, "d_model": cfg.d_model,
          "seq_len": TRAIN_SEQ, "global_batch": batch,
          "n_micro": TRAIN_MICRO, "steps": TRAIN_STEPS, "adamw": TRAIN_ADAMW,
          "params_gb": tree_bytes(params) / 1e9, "adamw_state_gb": state_gb,
          "held_at_start_gb": held, "losses": losses,
          "step_ms_median": ms[len(ms) // 2],
          "host_queue_ms_median": sorted(
              r["host_queue_ms"] for r in steps[1:])[len(ms) // 2],
          "tokens_per_s_median": batch * TRAIN_SEQ * 1e3
          / ms[len(ms) // 2],
          "cuda_core_backward": reference,
          "peak_mem_gb": peak / 1e9, "launches": launches,
          "launches_expected": want,
          "launches_note": "kernel 7 runs twice a layer and micro-step "
                           "(forward, then its recompute under remat)",
          # the profiler slows the host: its step's device time is read
          # against the median unprofiled step
          "profiled_step": {**prof, "profiled_wall_ms": wall_ms,
                            "device_idle_share": (
                                None if prof["device_busy_ms"] is None
                                else 1 - prof["device_busy_ms"]
                                / ms[len(ms) // 2])}})
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{phase}: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{phase}: the loss did not fall: {losses}")
    if launches != want:
        raise AssertionError(f"{phase}: launches {launches} != {want}")
    del params, opt_state
    torch.cuda.empty_cache()
    return launches


# train_launch: the launcher at the train phase's llama3.2-1b (full width
# and depth, TRAIN_BATCH x TRAIN_SEQ a step in TRAIN_MICRO micro-steps),
# TRAIN_LAUNCH_STEPS steps; the crash run stops at step 1
TRAIN_LAUNCH_STEPS = 2
TRAIN_LAUNCH_TIMEOUT_S = 240


def launcher_argv(ckpt: Path, extra=()) -> list:
    """The launcher's arguments: llama3.2-1b at the train phase's shape,
    its checkpoints in ``ckpt``."""
    return ["--arch", "llama3.2-1b", "--steps", str(TRAIN_LAUNCH_STEPS),
            "--seq-len", str(TRAIN_SEQ), "--global-batch", str(TRAIN_BATCH),
            "--n-micro", str(TRAIN_MICRO), "--log-every", "1",
            "--ckpt-dir", str(ckpt), *extra]


def run_launcher(ckpt: Path, port, extra=()):
    """``python -m repro_torch.launch.train`` in a process of its own
    under a one-rank process group (the variables ``torchrun`` sets, on
    ``port``).  Returns (exit code, output, wall seconds)."""
    env = dict(os.environ, PYTHONPATH=str(SRC), RANK="0", LOCAL_RANK="0",
               WORLD_SIZE="1", MASTER_ADDR="localhost",
               MASTER_PORT=str(port))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                        *launcher_argv(ckpt, extra)], env=env,
                       capture_output=True, text=True,
                       timeout=TRAIN_LAUNCH_TIMEOUT_S, cwd=ROOT)
    return r.returncode, r.stdout + r.stderr[-3000:], \
        time.perf_counter() - t0


def run_launcher_here(torch, ckpt: Path):
    """The same command with no process group, in this process (its
    ``main``), its output captured.  Returns (exit code, output, wall
    seconds)."""
    import io
    from repro_torch.launch import train as launch_train
    if "WORLD_SIZE" in os.environ:
        raise AssertionError("train_launch: WORLD_SIZE is set here")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = launch_train.main(launcher_argv(ckpt))
    torch.cuda.empty_cache()
    return rc, buf.getvalue(), time.perf_counter() - t0


def launcher_report(out: str) -> dict:
    """The numbers a launcher run printed: its process group line, each
    step's loss and time since the loop began, checkpoint save and
    restore seconds, its kernels' launches."""
    rep = {"group": None, "steps": [], "save_s": [], "restore_s": None,
           "launches": None}
    for line in out.splitlines():
        if line.startswith("process group:"):
            rep["group"] = line
        m = re.match(r"step\s+(\d+) loss (\S+) .*\((\S+)s\)$", line)
        if m:
            rep["steps"].append({"step": int(m.group(1)),
                                 "loss": float(m.group(2)),
                                 "since_start_s": float(m.group(3))})
        m = re.search(r"\(save (\S+)s\)", line)
        if m:
            rep["save_s"].append(float(m.group(1)))
        m = re.search(r"resumed from step \d+ \(restore (\S+)s\)", line)
        if m:
            rep["restore_s"] = float(m.group(1))
        if line.startswith("kernel launches:"):
            rep["launches"] = json.loads(line.split(":", 1)[1])
    return rep


def phase_train_launch(torch, kernel_fns, card, cfg):
    """The train launcher under a one-rank ``nccl`` group on the card at
    llama3.2-1b's full width, each run a process of its own:
    TRAIN_LAUNCH_STEPS steps with a checkpoint every step and
    ``--crash-at 1`` (exit 17 after the step-1 checkpoint), the relaunch
    resuming from it; then the same command with no group, in this
    process (every count zeroed just before it).  The resumed run's final
    checkpoint must equal the no-group run's leaf for leaf (hash, dtype,
    shape: bit for bit).  The grouped runs must say they formed an nccl
    group over a (1, 1) mesh (a group that cannot form exits non-zero);
    each run's kernels must launch 2 x layers x micro-steps (kernel 7)
    and layers x micro-steps (its backward) a step (the grouped runs
    print their own processes' counts).  The crash run's checkpoints are
    cut to the latest before the no-group run writes its own (disk);
    everything under build/ is removed afterwards."""
    import shutil
    from repro_torch.training import checkpoint as ckpt_mod
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 1e9
    if held >= HELD_LIMIT_GB:
        raise AssertionError(f"train_launch: {held:.2f} GB held before the "
                             f"launcher needs the card")
    root = ROOT / "build" / "train_launch"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    runs = {}
    try:
        with socket_port() as port:
            crash = run_launcher(root / "group", port,
                                 ("--ckpt-every", "1", "--crash-at", "1"))
        with socket_port() as port:
            resume = run_launcher(root / "group", port,
                                  ("--ckpt-every", "1"))
        ckpt_mod.CheckpointManager(str(root / "group"), keep=1)._gc()
        for fn in kernel_fns.values():
            fn.launches = 0
        plain = run_launcher_here(torch, root / "none")
        counted = {name: fn.launches for name, fn in kernel_fns.items()}
        for name, (rc, out, wall) in (("crash", crash), ("resume", resume),
                                      ("no_group", plain)):
            runs[name] = {"rc": rc, "wall_s": wall, **launcher_report(out)}
            runs[name]["tail"] = out[-1500:] if rc not in (0, 17) else None
        last = f"ckpt_{TRAIN_LAUNCH_STEPS:08d}.json"
        got, want = ({} if not (root / d / last).exists() else
                     json.loads((root / d / last).read_text())["leaves"]
                     for d in ("group", "none"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    differ = sorted(k for k in set(got) | set(want)
                    if got.get(k) != want.get(k))
    per_step = {"flash_prefill": 2 * cfg.n_layers * TRAIN_MICRO,
                "flash_prefill_bwd": cfg.n_layers * TRAIN_MICRO}
    steps_run = {"crash": 1, "resume": TRAIN_LAUNCH_STEPS - 1,
                 "no_group": TRAIN_LAUNCH_STEPS}
    emit({"phase": "train_launch", "card": card, "model": cfg.name,
          "layers": cfg.n_layers, "d_model": cfg.d_model,
          "seq_len": TRAIN_SEQ, "global_batch": TRAIN_BATCH,
          "n_micro": TRAIN_MICRO, "steps": TRAIN_LAUNCH_STEPS,
          "runs": runs, "leaves": len(want),
          "leaves_differing": differ[:10],
          "n_differing": len(differ)})
    want_rc = {"crash": 17, "resume": 0, "no_group": 0}
    for name, r in runs.items():
        if r["rc"] != want_rc[name]:
            raise AssertionError(f"train_launch: the {name} run exited "
                                 f"{r['rc']}: {r['tail']}")
        grouped = name != "no_group"
        if grouped != bool(r["group"] and "nccl" in r["group"]
                           and "{'data': 1, 'model': 1}" in r["group"]):
            raise AssertionError(f"train_launch: the {name} run's group: "
                                 f"{r['group']}")
        want_l = {k: v * steps_run[name] for k, v in per_step.items()}
        if name == "no_group" and counted != {
                k: want_l.get(k, 0) for k in kernel_fns}:
            raise AssertionError(f"train_launch: the no-group run launched "
                                 f"{counted}, not {want_l}")
        if r["launches"] != want_l:
            raise AssertionError(f"train_launch: the {name} run launched "
                                 f"{r['launches']}, not {want_l}")
        if not all(math.isfinite(x["loss"]) for x in r["steps"]):
            raise AssertionError(f"train_launch: {name} losses "
                                 f"{r['steps']}")
    if runs["resume"]["restore_s"] is None:
        raise AssertionError("train_launch: the relaunch did not resume")
    if not want or differ:
        raise AssertionError(f"train_launch: {len(differ)} of {len(want)} "
                             f"leaves differ from the no-group run: "
                             f"{differ[:10]}")
    return runs


def probe_mla_depth(torch, layers: int) -> int:
    """Two train_mla steps of DeepSeek-V3 at ``layers`` layers (as
    phase_train builds them) and one JSON line: the parameter count, the
    AdamW state's bytes and the peak memory, or the out-of-memory error
    with the bytes allocated when it struck."""
    from repro_torch.training import optimizer as opt_mod
    from repro_torch.training import train as train_mod
    cfg = dataclasses.replace(mla_config(), n_layers=layers)
    model, params, data = train_setup(torch, cfg, batch=TRAIN_MLA_BATCH)
    n_params = sum(t.numel() for _, t in tree_leaves(params))
    opt_state = opt_mod.init_state(params)
    step_fn = train_mod.make_train_step(
        model, adamw=opt_mod.AdamWConfig(**TRAIN_ADAMW), n_micro=TRAIN_MICRO)
    out = {"phase": "mla_depth_probe", "card": nvidia_smi(),
           "model": cfg.name, "layers": layers, "params": n_params,
           "adamw_state_gb": sum(tree_bytes(t) for t in (
               opt_state.master, opt_state.m, opt_state.v)) / 1e9,
           "card_total_gb":
               torch.cuda.get_device_properties(0).total_memory / 1e9,
           "losses": []}
    torch.cuda.reset_peak_memory_stats()
    try:
        for s in range(2):
            params, opt_state, m = step_fn(
                params, opt_state,
                train_batch(torch, data, cfg, s, TRAIN_MLA_BATCH))
            out["losses"].append(float(m["loss"]))
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    except torch.cuda.OutOfMemoryError as e:
        out["out_of_memory"] = str(e).splitlines()[0]
        out["peak_gb_before_oom"] = torch.cuda.max_memory_allocated() / 1e9
    emit(out)
    return 0


def short_config(cfg):
    return dataclasses.replace(cfg, n_layers=TRAIN_SHORT_LAYERS)


def phase_train_parity(torch, card, cfg, phase="train_parity",
                       layers=TRAIN_SHORT_LAYERS, batch=TRAIN_BATCH,
                       seq=TRAIN_SEQ, attn_leaves=("wq", "wk", "wv")):
    """One train step's loss and gradients (``compute_grads``, TRAIN_MICRO
    micro-steps) of ``cfg`` at full width and ``layers`` layers
    (llama3.2-1b at TRAIN_SHORT_LAYERS; ``train_mla_parity``: DeepSeek-V3
    at one layer, 1 x 512 tokens a micro-step) with the kernels and with
    the plain versions on the card (``backend="torch"``), on the same
    params and batch.  Every leaf gets a gradient in both
    (``compute_grads`` raises otherwise); each leaf within
    TRAIN_PARITY_RTOL of its largest magnitude, the loss within
    TRAIN_LOSS_RTOL.  The ``attn_leaves`` gradients are nonzero."""
    from repro_torch.training import train as train_mod
    from repro_torch.kernels.flash_prefill import (flash_prefill,
                                                   flash_prefill_bwd)
    cfg = dataclasses.replace(cfg, n_layers=layers)
    model, params, data = train_setup(torch, cfg, seed=1, batch=batch,
                                      seq=seq)
    batch = train_batch(torch, data, cfg, 0, batch)
    runs = {}
    for backend in ("cuda", "torch"):
        before = flash_prefill_bwd.launches, flash_prefill.launches
        grads, metrics = train_mod.compute_grads(
            model, params, batch, n_micro=TRAIN_MICRO, backend=backend)
        torch.cuda.synchronize()
        runs[backend] = (grads, float(metrics["loss"]),
                         (flash_prefill_bwd.launches - before[0],
                          flash_prefill.launches - before[1]))
    (gk, lk, nk), (gp, lp, np_) = runs["cuda"], runs["torch"]
    worst, leaves = 0.0, {}
    for (path, a), (_, b) in zip(tree_leaves(gk), tree_leaves(gp)):
        scale = float(b.abs().max())
        gap = float((a - b).abs().max())
        rel = gap / scale if scale > 0 else gap
        leaves["/".join(path)] = {"max_abs": scale, "gap_over_max": rel}
        worst = max(worst, rel)
    attn_scale = min(leaves[f"layers/attn/{w}"]["max_abs"]
                     for w in attn_leaves)
    emit({"phase": phase, "card": card, "model": cfg.name,
          "layers": cfg.n_layers, "tokens_a_micro_step": [
              batch["tokens"].shape[0] // TRAIN_MICRO,
              batch["tokens"].shape[1]],
          "loss_kernels": lk, "loss_plain": lp,
          "loss_rel_gap": abs(lk - lp) / abs(lp), "loss_rtol": TRAIN_LOSS_RTOL,
          "grad_rtol": TRAIN_PARITY_RTOL, "worst_gap_over_max": worst,
          "launches_kernels_run": {"flash_prefill_bwd": nk[0],
                                   "flash_prefill": nk[1]},
          "launches_plain_run": {"flash_prefill_bwd": np_[0],
                                 "flash_prefill": np_[1]},
          "leaves": leaves})
    if not abs(lk - lp) <= TRAIN_LOSS_RTOL * abs(lp):
        raise AssertionError(f"{phase}: loss {lk} vs {lp}")
    if not worst <= TRAIN_PARITY_RTOL:
        raise AssertionError(f"{phase}: a gradient leaf is "
                             f"{worst} of its magnitude apart")
    if not (attn_scale > 0 and nk[0] > 0 and np_ == (0, 0)):
        raise AssertionError(f"{phase}: attention grads {attn_scale}, "
                             f"launches {nk} / {np_}")
    del params, runs, gk, gp
    torch.cuda.empty_cache()


def phase_train_resume(torch, card, cfg):
    """At TRAIN_SHORT_LAYERS layers: 4 steps straight against 2 steps, a
    checkpoint saved to and restored from a temporary directory under
    build/ (removed afterwards), then 2 more; every param and AdamW state
    leaf equal bit for bit (``torch.equal``)."""
    import shutil
    import tempfile
    from repro_torch.training import checkpoint as ckpt_mod
    from repro_torch.training import optimizer as opt_mod
    from repro_torch.training import train as train_mod
    cfg = short_config(cfg)
    model, params0, data = train_setup(torch, cfg, seed=2)
    state0 = opt_mod.init_state(params0)
    step_fn = train_mod.make_train_step(
        model, adamw=opt_mod.AdamWConfig(**TRAIN_ADAMW), n_micro=TRAIN_MICRO)

    def run(params, state, start, n):
        for s in range(start, start + n):
            params, state, _ = step_fn(params, state,
                                       train_batch(torch, data, cfg, s))
        return params, state
    straight = run(params0, state0, 0, 4)
    half = run(params0, state0, 0, 2)
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="train_resume_", dir=ROOT / "build")
    try:
        mgr = ckpt_mod.CheckpointManager(tmp)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        manifest = mgr.save(2, half)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        restored, _ = mgr.restore(half)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp)
    resumed = run(*restored, 2, 2)
    a = ckpt_mod._leaf_paths(straight)
    b = ckpt_mod._leaf_paths(resumed)
    differ = [ka for (ka, x), (kb, y) in zip(a, b)
              if ka != kb or x.dtype != y.dtype or not torch.equal(x, y)]
    emit({"phase": "train_resume", "card": card, "model": cfg.name,
          "layers": cfg.n_layers, "leaves": len(a),
          "checkpoint_bytes": manifest["delta"]["new_bytes"],
          "save_s": save_s, "restore_s": restore_s,
          "leaves_differing": differ[:10], "n_differing": len(differ)})
    if differ or len(a) != len(b):
        raise AssertionError(f"train_resume: {len(differ)} leaves differ "
                             f"from the straight run: {differ[:10]}")


def phase_train_families(torch, kernel_fns, card):
    """One ``train_loss`` and backward at full width for each of
    TRAIN_FAMILIES (depth cut as listed; the VLM's cross gates at
    VLM_GATE and N(0, 1) patches, whisper's frames N(0, 1)): the loss
    finite, every param leaf's gradient present and finite; the flash
    kernels' launches printed (RWKV runs none)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    gen = torch.Generator(device="cuda").manual_seed(77)
    by_family = {}
    for name, layers, B, S in TRAIN_FAMILIES:
        cfg = get_config(name)
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        model = build_model(cfg)
        params = model.init_params(0, device="cuda")
        if "cross" in params:
            params["cross"]["gate"].fill_(VLM_GATE)
        leaves = [t.requires_grad_(True) for _, t in tree_leaves(params)]
        batch = {k: torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                                  device="cuda").to(torch.int32)
                 for k in ("tokens", "labels")}
        if cfg.family == "vlm":
            batch["patches"] = torch.randn(
                (B, cfg.n_patches, cfg.d_model), generator=gen,
                device="cuda").bfloat16()
        if cfg.family == "encdec":
            batch["frames"] = torch.randn(
                (B, cfg.enc_len, cfg.d_model), generator=gen,
                device="cuda").bfloat16()
        for fn in kernel_fns.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss, _ = model.train_loss(params, batch)
        loss.backward()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: fn.launches for k, fn in kernel_fns.items()}
        launches = {k: n for k, n in counts.items() if n}
        bad = [("/".join(p)) for (p, _), t in zip(tree_leaves(params), leaves)
               if t.grad is None or not bool(torch.isfinite(t.grad).all())]
        by_family[name] = counts
        emit({"phase": "train_families", "card": card, "model": name,
              "layers": cfg.n_layers, "batch": B, "seq_len": S,
              "loss": float(loss.detach()), "step_s": wall,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
              "param_leaves": len(leaves), "bad_grads": bad,
              "launches": launches})
        attends = cfg.family != "rwkv"
        if not (math.isfinite(float(loss.detach())) and not bad):
            raise AssertionError(f"train_families {name}: loss "
                                 f"{float(loss.detach())}, bad grads {bad}")
        if attends != bool(launches.get("flash_prefill_bwd")):
            raise AssertionError(f"train_families {name}: launches "
                                 f"{launches}")
        del params, leaves, loss, batch
        torch.cuda.empty_cache()
    return by_family


# ---------------------------------------------------------------------------
# the trace-replay, cluster and front-end drivers
# ---------------------------------------------------------------------------
# llama3.2-1b at full width with the replay's 32-token blocks
REPLAY_BLOCK_TOKENS = 32


def cell_name(workload, segments) -> str:
    return workload + ("_segments" if segments else "")


def replay_full_config():
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("llama3.2-1b"),
                               kv_block_tokens=REPLAY_BLOCK_TOKENS)


@contextlib.contextmanager
def checked_sampling(torch, record):
    """Keep, for every fused decode step, whether its logits are finite
    and the range of the tokens it sampled (device tensors, read once
    the run is over)."""
    from repro_torch.serving import sampler
    orig = sampler.sample_batched

    def sample_batched(logits, *a, **kw):
        toks = orig(logits, *a, **kw)
        record.append(torch.stack([torch.isfinite(logits).all().long(),
                                   toks.min().long(), toks.max().long()]))
        return toks
    sampler.sample_batched = sample_batched
    try:
        yield
    finally:
        sampler.sample_batched = orig


def sampling_ok(torch, record, vocab) -> bool:
    if not record:
        return False
    finite, lo, hi = torch.stack(record).cpu().T.tolist()
    return all(finite) and min(lo) >= 0 and max(hi) < vocab


@contextlib.contextmanager
def host_link(torch, out):
    """Count the tier payloads that cross the host link: each block
    payload copied device->host (``payload_from_tensor``) or host->device
    (``tensor_from_payload``), its bytes and the host-clock seconds of
    the copy alone (the device is synchronized before it, and after a
    host->device copy)."""
    from repro_torch.serving import kvcache
    d2h, h2d = kvcache.payload_from_tensor, kvcache.tensor_from_payload
    for key in ("d2h", "h2d"):
        out.update({key + "_copies": 0, key + "_bytes": 0, key + "_s": 0.0})

    def count(key, nbytes, t0):
        out[key + "_copies"] += 1
        out[key + "_bytes"] += nbytes
        out[key + "_s"] += time.perf_counter() - t0

    def payload_from_tensor(t):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a = d2h(t)
        count("d2h", a.nbytes, t0)
        return a

    def tensor_from_payload(a, device):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t = h2d(a, device)
        torch.cuda.synchronize()
        count("h2d", a.nbytes, t0)
        return t
    kvcache.payload_from_tensor = payload_from_tensor
    kvcache.tensor_from_payload = tensor_from_payload
    try:
        yield
    finally:
        kvcache.payload_from_tensor, kvcache.tensor_from_payload = d2h, h2d


@contextlib.contextmanager
def checked_kernel_calls(torch, record):
    """Hold calls 1, 2, 4, 8, ... of each of kernels 1-6 and 8 on the
    driven path against the plain version on the very tensors the path
    gave the kernel, right after the path's own launch (so the pool holds
    what that launch read): per checked call its page size and, as
    device tensors read once the run is over, the kernel's max_abs_err,
    the plain output's largest magnitude and whether the output is
    finite (of the output alone where it comes with its log-sum-exp).
    The plain calls launch no kernel."""
    from repro_torch.kernels import ops
    # kernel -> (ops global it is reached through, position of its pages)
    where = {"paged_decode": ("paged_decode_attention", 1),
             "paged_prefill": ("paged_prefill_attention", 3),
             "paged_prefill_seg": ("paged_prefill_segments", 3),
             "mla_paged_decode": ("mla_paged_decode", 2),
             "mla_paged_prefill": ("mla_paged_prefill", 3),
             "mla_paged_prefill_seg": ("mla_paged_prefill_segments", 3),
             "paged_decode_int8": ("paged_decode_attention_int8", 1)}
    saved = {attr: getattr(ops, attr) for attr, _ in where.values()}
    calls = dict.fromkeys(where, 0)

    def wrap(name, fn, k_arg):
        def call(*a, **kw):
            out = fn(*a, **kw)
            calls[name] += 1
            if calls[name] & (calls[name] - 1) == 0:
                got = out[0] if isinstance(out, tuple) else out
                plain = fn(*a, **dict(kw, backend="torch"))
                plain = (plain[0] if isinstance(plain, tuple)
                         else plain).float()
                record.append((name, a[k_arg].shape[1], torch.stack([
                    (got.float() - plain).abs().max(), plain.abs().max(),
                    torch.isfinite(got).all().float()])))
            return out
        return call
    for name, (attr, k_arg) in where.items():
        setattr(ops, attr, wrap(name, saved[attr], k_arg))
    try:
        yield
    finally:
        for attr, fn in saved.items():
            setattr(ops, attr, fn)


def kernel_check_report(torch, record) -> dict:
    """Per kernel: the calls checked, their page sizes and the worst
    error beside its limit: one bf16 step at the plain output's largest
    magnitude, 2^(floor(log2 |o|) - 7), and at least KERNEL_ATOL (the
    step below magnitude 4, as in the kernels phase).  Both sides round
    a float32 value to bf16 once, so while their float32 values lie
    within one step the outputs differ by at most one."""
    report = {}
    vals = torch.stack([v for _, _, v in record]).cpu().tolist() \
        if record else []
    for (name, page, _), (err, scale, finite) in zip(record, vals):
        row = report.setdefault(name, {"calls": 0, "pages": [],
                                       "max_abs_err": 0.0, "max_abs": 0.0,
                                       "tol": 0.0,
                                       "worst_err_over_tol": 0.0,
                                       "finite": True})
        tol = max(KERNEL_ATOL, 2.0 ** (math.floor(math.log2(scale)) - 7)
                  if 0 < scale < math.inf else 0.0)
        row["calls"] += 1
        row["pages"] = sorted(set(row["pages"]) | {page})
        row["finite"] = row["finite"] and finite == 1.0
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["max_abs"] = max(row["max_abs"], scale)
        row["tol"] = max(row["tol"], tol)
        row["worst_err_over_tol"] = max(row["worst_err_over_tol"],
                                        err / tol)
    return report


def held_to_plain(phase, report, launches, names=None):
    """Raise unless every kernel of ``names`` (CHECKED: kernels 1-6) that
    launched on the path was held to its plain version on the path's own
    calls (``kernel_check_report``) with finite outputs within the
    limit."""
    for name in names or CHECKED:
        if launches[name] <= 0:
            continue
        row = report.get(name)
        if not row or not row["finite"] or row["worst_err_over_tol"] > 1.0:
            raise AssertionError(f"{phase}: kernel {name} vs its plain "
                                 f"version on the path's own calls: {row}")


@contextlib.contextmanager
def checked_injects(torch, record):
    """After every block inject into a paged pool (a tier fetch, a
    shared-tier import, a restored preemption), read the block back
    from the pool and keep whether its bits equal the payload's (device
    tensors, read once the run is over).  Enter it before ``host_link``:
    its own copies are not counted there."""
    from repro_torch.serving import kvcache
    orig = kvcache.PagedKVCache.inject_block
    h2d = kvcache.tensor_from_payload

    def inject_block(self, slot, payload, start):
        n = orig(self, slot, payload, start)
        got = torch.stack([self._gather(pool, slot, start, n)
                           for pool, _ in self.kinds])
        want = h2d(payload, self.device)
        if got.dtype != want.dtype or got.shape != want.shape:
            raise AssertionError(f"inject: pool block {got.dtype} "
                                 f"{tuple(got.shape)} vs payload "
                                 f"{want.dtype} {tuple(want.shape)}")
        record.append((got.contiguous().view(torch.uint8)
                       == want.contiguous().view(torch.uint8)).all())
        return n
    kvcache.PagedKVCache.inject_block = inject_block
    try:
        yield
    finally:
        kvcache.PagedKVCache.inject_block = orig


def injects_exact(torch, record) -> bool:
    return bool(torch.stack(record).all()) if record else True


def replay_cell(res, turns) -> dict:
    row = {key: getattr(res, key) for key in (
        "engine_hit_rate", "reuse_rate", "seen_blocks", "hot_hits_t0",
        "hot_hits_t1", "cow_share_hits", "inject_hits", "segment_hit_blocks",
        "segment_share_hits", "segment_inject_hits", "promotions",
        "demotions", "requests_done", "turns_submitted", "generated_tokens",
        "ttft_p50", "ttft_p95", "ttft_p99", "tbt_p50", "tbt_p95",
        "virtual_time_s", "steps", "wall_s")}
    row["turns"] = turns
    return row


def run_replays(torch, kernel_fns, cfg, params, vocab) -> dict:
    """The four replay cells on the card; every kernel count zeroed just
    before them and read just after; sampled tokens, injected blocks and
    kernels 1-3 checked along the way."""
    from repro_torch.traces import serving_replay as sr
    cells, sampled, link, calls, injects = {}, [], {}, [], []
    for fn in kernel_fns.values():
        fn.launches = 0
    with checked_injects(torch, injects), host_link(torch, link), \
            checked_sampling(torch, sampled), \
            checked_kernel_calls(torch, calls):
        for workload, seg in REPLAY_PINS:
            log = []
            res = sr.run_serving_replay(
                sr.ServingReplayConfig(workload=workload, segment_reuse=seg,
                                       async_transfers=False),
                log, cfg=cfg, device="cuda", params=params)
            cells[cell_name(workload, seg)] = replay_cell(res, len(log))
    launches = {name: fn.launches for name, fn in kernel_fns.items()}
    return {"cells": cells, "launches": launches, "host_link": link,
            "sampled_ok": sampling_ok(torch, sampled, vocab),
            "kernel_checks": kernel_check_report(torch, calls),
            "injects_checked": len(injects),
            "injects_bit_exact": injects_exact(torch, injects)}


def page_tokens(run) -> list:
    """The page sizes kernels 1-3 were given on the run (their checked
    calls)."""
    return sorted({p for row in run["kernel_checks"].values()
                   for p in row["pages"]})


def check_replay_run(phase, run):
    for name, row in run["cells"].items():
        if not row["requests_done"] == row["turns_submitted"] == row["turns"]:
            raise AssertionError(f"{phase} {name}: {row['requests_done']} of "
                                 f"{row['turns']} turns completed")
    if not run["sampled_ok"]:
        raise AssertionError(f"{phase}: non-finite logits or a sampled "
                             f"token outside the vocabulary")
    if not (run["injects_checked"] > 0 and run["injects_bit_exact"]):
        raise AssertionError(f"{phase}: an injected block reads back from "
                             f"the pool with other bits than its payload")
    for name in GQA_PATH:
        if run["launches"][name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"{phase} path")
    held_to_plain(phase, run["kernel_checks"], run["launches"])
    if page_tokens(run) != [REPLAY_BLOCK_TOKENS]:
        raise AssertionError(f"{phase}: kernels 1-3 ran at pages "
                             f"{page_tokens(run)}, not "
                             f"{REPLAY_BLOCK_TOKENS}")


def run_fields(run) -> dict:
    return {"page_tokens": page_tokens(run), "cells": run["cells"],
            **{k: run[k] for k in ("launches", "host_link", "kernel_checks",
                                   "injects_checked", "injects_bit_exact")}}


def phase_replay(torch, kernel_fns, card):
    """The reduced replay model on the card: every pinned counter equal
    to the CPU run's."""
    from repro_torch.traces.serving_replay import replay_model_config
    cfg = replay_model_config(REPLAY_BLOCK_TOKENS)
    run = run_replays(torch, kernel_fns, cfg, None, cfg.vocab_size)
    mismatch = {}
    for cell, want in REPLAY_PINS.items():
        got = run["cells"][cell_name(*cell)]
        bad = {k: (got[k], v) for k, v in want.items() if got[k] != v}
        if bad:
            mismatch[cell_name(*cell)] = bad
    emit({"phase": "replay", "card": card, "model": cfg.name,
          "layers": cfg.n_layers, "d_model": cfg.d_model, **run_fields(run),
          "pins_equal": not mismatch})
    check_replay_run("replay", run)
    if mismatch:
        raise AssertionError(f"replay: counters differ from the CPU pins "
                             f"(got, pinned): {mismatch}")
    return run["launches"]


def phase_replay_full(torch, kernel_fns, card, cfg, params):
    """The four cells at full llama3.2-1b width: tier traffic across the
    host link, kernels 1-3 at 32-token pages held to their plain
    versions on the path's own calls."""
    t0 = time.perf_counter()
    run = run_replays(torch, kernel_fns, cfg, params, cfg.vocab_size)
    wall = time.perf_counter() - t0
    cells = run["cells"]
    for cell, pin in REPLAY_PINS.items():
        row = cells[cell_name(*cell)]
        row["hit_rate_minus_reduced"] = (row["engine_hit_rate"]
                                         - pin["engine_hit_rate"])
    totals = {key: sum(row[key] for row in cells.values())
              for key in ("demotions", "promotions", "inject_hits",
                          "steps")}
    link = run["host_link"]
    emit({"phase": "replay_full", "card": card, "model": cfg.name,
          "layers": cfg.n_layers, "d_model": cfg.d_model,
          "vocab": cfg.vocab_size, "wall_s": wall, "totals": totals,
          **run_fields(run)})
    check_replay_run("replay_full", run)
    missed = [key for key in ("demotions", "promotions", "inject_hits")
              if totals[key] <= 0]
    if missed or link["d2h_bytes"] <= 0 or link["h2d_bytes"] <= 0:
        raise AssertionError(f"replay_full: no tier traffic in {missed} "
                             f"or across the host link ({link})")
    return run["launches"]


@contextlib.contextmanager
def failover_memory(torch, out):
    """Read the device memory around each ``fail_replica``, beside the
    failed replica's KV pool bytes."""
    from repro_torch.serving.cluster import ReplicaCluster
    orig = ReplicaCluster.fail_replica

    def fail_replica(self, name):
        out["failed_pool_bytes"] = sum(
            t.numel() * t.element_size()
            for t in self.engines[name].kv.pools.values())
        torch.cuda.synchronize()
        out["allocated_before"] = torch.cuda.memory_allocated()
        n = orig(self, name)
        torch.cuda.synchronize()
        out["allocated_after"] = torch.cuda.memory_allocated()
        out["released_bytes"] = (out["allocated_before"]
                                 - out["allocated_after"])
        return n
    ReplicaCluster.fail_replica = fail_replica
    try:
        yield
    finally:
        ReplicaCluster.fail_replica = orig


def phase_cluster(torch, kernel_fns, card, cfg, params):
    """Two full-width replicas on one params tree, the fleet-shared tier
    4, one replica failed once 10 turns have completed; then the serve
    CLI at full width with two replicas and a failure."""
    import io
    from repro_torch.launch import serve
    from repro_torch.traces import serving_replay as sr
    ccfg = sr.ClusterReplayConfig(workload="lmsys", n_replicas=2,
                                  routing="round_robin", shared_tier=True,
                                  fail_replica_after_turns=10)
    for fn in kernel_fns.values():
        fn.launches = 0
    log, mem, injects = [], {}, []
    t0 = time.perf_counter()
    with failover_memory(torch, mem), checked_injects(torch, injects):
        res = sr.run_cluster_replay(ccfg, log, cfg=cfg, device="cuda",
                                    params=params)
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernel_fns.items()}
    cli_out = io.StringIO()
    t1 = time.perf_counter()
    with contextlib.redirect_stdout(cli_out):
        rc = serve.main(["--arch", "llama3.2-1b", "--replicas", "2",
                         "--fail-replica", "--device", "cuda"])
    cli_s = time.perf_counter() - t1
    survivors = [r for r in res.per_replica if not r.failed]
    emit({"phase": "cluster", "card": card, "model": cfg.name,
          "layers": cfg.n_layers, "routing": res.routing,
          "async_transfers": ccfg.async_transfers, "turns": len(log),
          "requests_done": res.requests_done,
          "redispatched": res.redispatched,
          "reprefill_tokens": res.reprefill_tokens,
          "failed_replicas": res.failed_replicas,
          "fleet_hit_rate": res.fleet_hit_rate,
          "fleet_hit_rate_incl_shared": res.fleet_hit_rate_incl_shared,
          "shared_hit_blocks": res.shared_hit_blocks,
          "per_replica": [dataclasses.asdict(r) for r in res.per_replica],
          "ttft_p50": res.ttft_p50, "ttft_p95": res.ttft_p95,
          "steps": res.steps, "wall_s": wall, "memory": mem,
          "injects_checked": len(injects),
          "injects_bit_exact": injects_exact(torch, injects),
          "launches": launches, "cli_rc": rc, "cli_s": cli_s,
          "cli_output": cli_out.getvalue().splitlines()})
    if res.shared_hit_blocks <= 0:
        raise AssertionError("cluster: no block imported from the "
                             "fleet-shared tier")
    if not injects_exact(torch, injects):
        raise AssertionError("cluster: an injected block reads back from "
                             "the pool with other bits than its payload")
    if not (res.failed_replicas and res.redispatched > 0 and survivors
            and res.requests_done == len(log)):
        raise AssertionError(f"cluster: {res.requests_done} of {len(log)} "
                             f"turns completed after failing "
                             f"{res.failed_replicas} ({res.redispatched} "
                             f"redispatched)")
    if not mem.get("released_bytes", -1) >= mem.get("failed_pool_bytes", 0) \
            > 0:
        raise AssertionError(f"cluster: the failed replica's KV pool was "
                             f"not freed: {mem}")
    for name in GQA_PATH[:2]:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"cluster path")
    if rc != 0:
        raise AssertionError(f"cluster: the serve CLI returned {rc}")


def phase_frontend(torch, kernel_fns, card, cfg, params, duration_s=5.0,
                   qps=8.0):
    """``launch/serve.py --frontend`` on the full-width replay engine:
    the pump thread steps the card while the main thread submits an
    open-loop lmsys schedule in real time; drain, then the ledger."""
    import threading
    from repro_torch.launch.serve import run_open_loop
    from repro_torch.serving import ServingFrontend
    from repro_torch.traces.loadgen import offered_summary, trace_load
    from repro_torch.traces.serving_replay import (ServingReplayConfig,
                                                   build_engine)
    engine = build_engine(ServingReplayConfig(workload="lmsys", seed=0,
                                              async_transfers=False),
                          cfg, device="cuda", params=params)
    streams, main = set(), threading.get_ident()
    step = engine.step

    def pumped_step():
        streams.add((threading.get_ident() != main,
                     torch.cuda.current_stream().cuda_stream
                     == torch.cuda.default_stream().cuda_stream))
        return step()
    engine.step = pumped_step
    fe = ServingFrontend(engine)
    arrivals = trace_load("lmsys", qps, duration_s=duration_s, seed=0)
    for fn in kernel_fns.values():
        fn.launches = 0
    wall = run_open_loop(fe, arrivals)
    launches = {name: fn.launches for name, fn in kernel_fns.items()}
    st = fe.stats()
    engine.shutdown()
    # the wrapper holds the engine's bound step: a reference cycle that
    # would keep the engine, its pool and the params until a collection
    del engine.step
    emit({"phase": "frontend", "card": card, "model": cfg.name,
          "layers": cfg.n_layers, "qps": qps, "duration_s": duration_s,
          "offered_summary": offered_summary(arrivals), "wall_s": wall,
          "ledger_ok": True, "launches": launches,
          "pump_on_other_thread_default_stream": sorted(streams),
          **{k: (None if v == float("inf") else v) for k, v in st.items()}})
    if streams != {(True, True)}:
        raise AssertionError(f"frontend: steps ran on (other thread, "
                             f"default stream) = {streams}")
    if not (st["offered"] == len(arrivals) and st["done"] > 0
            and st["done"] + st["shed"] == st["offered"]
            and st["in_flight"] == 0):
        raise AssertionError(f"frontend: ledger {st}")
    for name in GQA_PATH[:2]:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"frontend path")


# ---------------------------------------------------------------------------
# the README's examples and the replay smoke's chaos phase on the card
# ---------------------------------------------------------------------------
# the port's chaos replay counters on the CPU at its H100 recompute
# constant; the same dict as tests/test_torch_examples.py, which holds the
# CPU run to it and this copy to its own
CHAOS_PINS = {
    "requests_done": 3, "turns_submitted": 3, "seen_blocks": 24,
    "hot_hits_t0": 4, "hot_hits_t1": 4, "cow_share_hits": 1,
    "inject_hits": 8, "segment_hit_blocks": 11, "segment_inject_hits": 11,
    "promotions": 12, "demotions": 80, "generated_tokens": 12, "steps": 20,
    "retries": 22, "io_errors": 0, "integrity_failures": 10,
    "fetch_recomputes": 6, "ttft_p99": 0.03542752153656406,
    "injected": {"injected_read_errors": 13, "injected_write_errors": 9,
                 "injected_corruptions": 10, "injected_brownouts": 0,
                 "injected_stalls": 0, "injected_flaps": 0},
}
SERVING_EXAMPLES = ("quickstart", "serve_multi_tier", "agentic_serving")
# the train demo on the card: a straight run of DEMO_STEPS (the JAX
# demo's default), and one cut at DEMO_CUT (exit 17 after the demo's
# step-DEMO_CUT checkpoint: it saves every 50) and relaunched
DEMO_STEPS, DEMO_CUT = 200, 100
# its card and CPU runs print the same lines once the wall-clock readings
# and the launch report are masked, but for the losses and gradient norms:
# bf16 weights and activations, the kernels' and the plain versions'
# rounding carried through 200 steps of the same batches (printed to 4
# decimals; the worst relative gap reads 2^-9.5 on an H100)
DEMO_LOSS_RTOL = 2.0 ** -6
# (completed requests, prefix-hit blocks) as each serving example prints
# them
EXAMPLE_COUNTS = re.compile(r"(?:served|done:|all completed:) (\d+)"
                            r"|prefix-hit blocks[^\d]*(\d+)")
DEMO_WALL = re.compile(r"\((?:save |restore )?\d+\.\d+s\)")
DEMO_STEP = re.compile(r"step +(\d+) loss (\S+) lr (\S+) gnorm (\S+)")


def load_script(rel: str):
    """A script of the repo (``examples/*.py``, ``scripts/*.py``) as a
    module, by path."""
    import importlib.util
    path = ROOT / rel
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def quiet():
    """Keep a script's own printing out of this run's output (its run()
    returns what it printed)."""
    import io
    with contextlib.redirect_stdout(io.StringIO()):
        yield


@contextlib.contextmanager
def engine_runs(out):
    """Record, for every ``ServingEngine.run``, whether work was left."""
    from repro_torch.serving.engine import ServingEngine
    orig = ServingEngine.run

    def run(self, *a, **k):
        stats = orig(self, *a, **k)
        out.append(self.scheduler.has_work())
        return stats
    ServingEngine.run = run
    try:
        yield
    finally:
        ServingEngine.run = orig


def demo_lines(text):
    """The train demo's lines with wall-clock readings and the launch
    report masked, and its step lines' (step, lr, loss, gnorm)."""
    lines, steps = [], []
    for line in text.splitlines()[1:]:
        if line.startswith("kernel launches:"):
            continue
        m = DEMO_STEP.match(line)
        if m:
            steps.append((int(m.group(1)), m.group(3), float(m.group(2)),
                          float(m.group(4))))
            continue
        if line.startswith("final loss:"):
            steps.append(("final", None, float(line.split()[-1]), None))
            continue
        lines.append(DEMO_WALL.sub("(s)", line))
    return lines, steps


def seed_demo_checkpoints(cfg, dirs) -> None:
    """A step-0 checkpoint of ``cfg``'s seeded weights on the card and
    their fresh AdamW state in each of ``dirs``, which the train demo
    resumes from."""
    from repro_torch.models.model import build_model
    from repro_torch.training import checkpoint as ckpt_mod
    from repro_torch.training import optimizer as opt_mod
    params = build_model(cfg).init_params(0, device="cuda")
    tree = (params, opt_mod.init_state(params))
    for d in dirs:
        ckpt_mod.CheckpointManager(str(d)).save(0, tree)


def phase_examples(torch, kernel_fns, card) -> dict:
    """The README's examples on the card (``examples/torch_*.py``):
    the three serving examples and the train demo at their reduced sizes
    on the card and on the CPU in this process, every line equal but the
    device line (the demo's: wall-clock readings and its launch report
    masked, losses and gradient norms within DEMO_LOSS_RTOL); the serving
    examples at full width, every run finished, their completion and
    prefix-hit counts the reduced runs'; the train demo cut at DEMO_CUT
    and relaunched, its final checkpoint equal to the straight run's leaf
    for leaf; the replay example at 2 sessions x 2 turns.  Every count is
    zeroed just before each card run and read just after, and its peak
    memory read as the gain over what was allocated when it started."""
    import shutil
    import tempfile
    from repro_torch.config import reduce_config
    from repro_torch.configs import get_config
    from repro_torch.models.common import tree_map
    from repro_torch.models.model import build_model
    from repro_torch.serving import EngineConfig
    t_phase = time.perf_counter()
    reduced = reduce_config(get_config("llama3.2-1b"))
    card_params = build_model(reduced).init_params(EngineConfig().seed,
                                                   device="cuda")
    cpu_params = tree_map(lambda t: t.cpu(), card_params)
    by_path, rows, differ = {}, {}, []

    def on_card(name, fn):
        for k in kernel_fns.values():
            k.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        calls = []
        with quiet(), checked_kernel_calls(torch, calls):
            text = fn()
        torch.cuda.synchronize()
        by_path[f"examples:{name}"] = {k: f.launches
                                       for k, f in kernel_fns.items()}
        checks[name] = kernel_check_report(torch, calls)
        peak = torch.cuda.max_memory_allocated()
        # the example's own peak is the gain over what was held before
        # it started (the shared reduced params, for the reduced runs)
        return text, {"wall_s": time.perf_counter() - t0,
                      "allocated_before_gb": before / 1e9,
                      "max_memory_allocated_gb": peak / 1e9,
                      "peak_gain_gb": (peak - before) / 1e9,
                      "launches": {k: v for k, v in
                                   by_path[f"examples:{name}"].items()
                                   if v},
                      "kernel_checks": checks[name]}

    finished, checks = [], {}
    with engine_runs(finished):
        for name in SERVING_EXAMPLES:
            ex = load_script(f"examples/torch_{name}.py")
            on, row = on_card(name, lambda: ex.run(device="cuda",
                                                   params=card_params))
            t0 = time.perf_counter()
            with quiet():
                off = ex.run(device="cpu", params=cpu_params)
            row["cpu_wall_s"] = time.perf_counter() - t0
            full, row["full_width"] = on_card(
                name + "_full", lambda: ex.run(full_width=True,
                                               device="cuda"))
            torch.cuda.empty_cache()
            row.update(lines=on.splitlines(),
                       counts=EXAMPLE_COUNTS.findall(on),
                       full_width_counts=EXAMPLE_COUNTS.findall(full))
            if on.splitlines()[1:] != off.splitlines()[1:]:
                differ.append((name, [(a, b) for a, b in zip(
                    on.splitlines()[1:], off.splitlines()[1:])
                    if a != b][:4]))
            if row["counts"] != row["full_width_counts"] or \
                    not row["counts"]:
                differ.append((name + "_full", row["full_width_counts"]))
            rows[name] = row
    del card_params, cpu_params
    torch.cuda.empty_cache()

    demo = load_script("examples/torch_train_demo.py")
    tmp = Path(tempfile.mkdtemp(prefix="train_demo_", dir=ROOT / "build"))
    try:
        # every run starts from one step-0 checkpoint of the card's seeded
        # weights (the launcher's own init draws from the device's
        # generator, so the CPU's weights would be others)
        seed_demo_checkpoints(reduced,
                              [tmp / d for d in ("straight", "cpu", "cut")])
        straight, row = on_card("train_demo", lambda: demo.run(
            DEMO_STEPS, str(tmp / "straight"), device="cuda"))
        t0 = time.perf_counter()
        with quiet():
            off = demo.run(DEMO_STEPS, str(tmp / "cpu"), device="cpu")
        row["cpu_wall_s"] = time.perf_counter() - t0
        cut_rc = None
        try:
            on_card("train_demo_cut", lambda: demo.run(
                DEMO_STEPS, str(tmp / "cut"), crash_at=DEMO_CUT,
                device="cuda"))
        except SystemExit as e:
            cut_rc = e.code
        resumed, row["resumed"] = on_card("train_demo_resumed", lambda:
                                          demo.run(DEMO_STEPS,
                                                   str(tmp / "cut"),
                                                   device="cuda"))
        last = f"ckpt_{DEMO_STEPS:08d}.json"
        want, got = (json.loads((tmp / d / last).read_text())["leaves"]
                     if (tmp / d / last).exists() else {}
                     for d in ("straight", "cut"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    (card_lines, card_steps), (cpu_lines, cpu_steps) = (
        demo_lines(straight), demo_lines(off))
    worst = max((abs(a[i] - b[i]) / abs(b[i])
                 for a, b in zip(card_steps, cpu_steps) for i in (2, 3)
                 if b[i]), default=math.inf)
    leaves_differ = sorted(k for k in set(want) | set(got)
                           if want.get(k) != got.get(k))
    row.update(lines=straight.splitlines(), cut_rc=cut_rc,
               resumed_from=[line for line in resumed.splitlines()
                             if line.startswith("resumed from")],
               leaves=len(want), leaves_differing=leaves_differ[:10],
               loss_gnorm_worst_rel=worst)
    rows["train_demo"] = row
    if card_lines != cpu_lines or [s[:2] for s in card_steps] != \
            [s[:2] for s in cpu_steps] or not worst <= DEMO_LOSS_RTOL:
        differ.append(("train_demo", [(a, b) for a, b in zip(
            card_lines, cpu_lines) if a != b][:4], worst))

    replay = load_script("examples/torch_trace_replay_serving.py")
    text, row = on_card("trace_replay_serving",
                        lambda: replay.run(2, 2, device="cuda"))
    row["lines"] = text.splitlines()
    rows["trace_replay_serving"] = row
    wall = time.perf_counter() - t_phase
    emit({"phase": "examples", "card": card, "wall_s": wall,
          "examples": rows, "engine_runs": len(finished),
          "engine_runs_left_work": sum(finished), "differ": differ})
    if differ:
        raise AssertionError(f"examples: card and CPU (or full-width and "
                             f"reduced) runs differ: {differ}")
    if not finished or any(finished):
        raise AssertionError(f"examples: {sum(finished)} of "
                             f"{len(finished)} engine runs left work")
    resumed_at = [line.split()[3] for line in
                  rows["train_demo"]["resumed_from"]]
    if not all(line.startswith("resumed from step 0 ") for line in
               (straight.splitlines()[1], off.splitlines()[1])):
        raise AssertionError("examples: the train demo did not start from "
                             "the seeded step-0 checkpoint")
    if cut_rc != 17 or resumed_at != [str(DEMO_CUT)] or not want \
            or leaves_differ:
        raise AssertionError(f"examples: the train demo cut at {DEMO_CUT} "
                             f"(exit {cut_rc}) and relaunched differs from "
                             f"the straight run in {len(leaves_differ)} of "
                             f"{len(want)} leaves, or did not resume")
    if sum("4 turns" in line for line in rows["trace_replay_serving"][
            "lines"]) != 2:
        raise AssertionError("examples: the replay example did not finish "
                             "its 4 turns under both policies")
    for name in SERVING_EXAMPLES:
        for path in (name, name + "_full"):
            for k in GQA_PATH[:2]:
                if by_path[f"examples:{path}"][k] <= 0:
                    raise AssertionError(f"kernel {k} never launched on "
                                         f"the examples:{path} path")
    if by_path["examples:train_demo"]["flash_prefill_bwd"] <= 0:
        raise AssertionError("the train demo launched no flash prefill "
                             "backward")
    for name, report in checks.items():
        held_to_plain(f"examples:{name}", report, by_path[f"examples:{name}"])
    return by_path


def phase_chaos(torch, kernel_fns, card) -> dict:
    """``scripts/torch_replay_smoke.py``'s chaos replay on the card (its
    fault profile: transient read / write errors and payload corruption
    on tiers 1-5, fault seed 3, 4 hot and 8 tier-1 blocks; the smoke's
    own checks: no request hung, a retry absorbed, every injected
    corruption caught by its crc32 check), every counter equal to the
    CPU run's (CHAOS_PINS); kernels 1-3's launches counted and held to
    their plain versions on the run's own calls."""
    smoke = load_script("scripts/torch_replay_smoke.py")
    for fn in kernel_fns.values():
        fn.launches = 0
    t0 = time.perf_counter()
    calls = []
    with quiet(), checked_kernel_calls(torch, calls):
        res = smoke.chaos_smoke(device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernel_fns.items()}
    checks = kernel_check_report(torch, calls)
    got = dataclasses.asdict(res)
    mismatch = {k: (got[k], v) for k, v in CHAOS_PINS.items()
                if got[k] != v}
    emit({"phase": "chaos", "card": card, "wall_s": wall,
          "launches": {k: launches[k] for k in GQA_PATH},
          **{k: got[k] for k in CHAOS_PINS},
          "ttft_p50": got["ttft_p50"], "retry_delay_s": got["retry_delay_s"],
          "tier_health": got["tier_health"], "kernel_checks": checks,
          "pins_equal": not mismatch})
    held_to_plain("chaos", checks, launches)
    if mismatch:
        raise AssertionError(f"chaos: counters differ from the CPU pins "
                             f"(got, pinned): {mismatch}")
    for name in GQA_PATH[:2]:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"chaos path")
    return launches


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
    "flash_prefill_bwd": ("src/repro_torch/csrc/flash_prefill_bwd.cu",
                          "src/repro/models/attention.py:121 "
                          "causal_attention under jax.grad (no Pallas "
                          "kernel)"),
}
GQA_PATH = ("paged_decode", "paged_prefill", "paged_prefill_seg")
MLA_PATH = ("mla_paged_decode", "mla_paged_prefill", "mla_paged_prefill_seg")
# the kernels `checked_kernel_calls` holds to their plain versions on a
# path's own calls
CHECKED = GQA_PATH + MLA_PATH
# the dense and monolithic paths: flash prefill for a prompt with no
# prefix hit, the paged decode kernel over slots or pages
DENSE_PATH = ("flash_prefill", "paged_decode")
# MLA on them: the MLA chunk prefill kernel at offset 0, the MLA decode
# kernel over latent slots (or pages)
MLA_DENSE_PATH = ("mla_paged_prefill", "mla_paged_decode")


# ---------------------------------------------------------------------------
# distribution and launch analysis: the dry run, and its estimates held to
# the card
# ---------------------------------------------------------------------------
# (label, arguments of ``python -m repro_torch.launch.dryrun``): llama's
# three shapes on 16x16, RWKV's 500k-token decode on 2x16x16 (the long-
# context rules), granite's train step with expert parallelism, llama's
# with sequence parallelism
DRYRUN_JOBS = (
    ("llama3.2-1b", ["--arch", "llama3.2-1b"]),
    ("rwkv6-1.6b_long", ["--arch", "rwkv6-1.6b", "--shape", "long_500k",
                         "--multi-pod"]),
    ("granite-moe-3b-a800m_ep", ["--arch", "granite-moe-3b-a800m",
                                 "--shape", "train_4k", "--ep"]),
    ("llama3.2-1b_sp", ["--arch", "llama3.2-1b", "--shape", "train_4k",
                        "--sp"]),
)
DRYRUN_TIMEOUT_S = 420
# dryrun_card: each shape's global batch cut to the largest power of
# two whose estimated peak (the dry run's peak_hint at --mesh 1x1) stays
# under 70 GB and whose step stays under about 5 s on the card.  The
# readings (H100 80GB HBM3, 700 W): train_4k's peak_hint is 57.21 GB at
# 8 and at 16 (2 and 4 micro-batches of 4 rows), its step 1.19 / 2.31 s,
# so 32 takes ~4.6 s and 64 ~9 s; prefill_32k 22.87 GB / 2.09 s at 4,
# 43.28 GB / 4.16 s at 8 (16 about twice that); decode_32k 36.84 GB at
# 32, whose K/V state alone doubles past 70 GB at 64.  The estimate of
# the peak must be within PEAK_BAND of max_memory_allocated.
CARD_BATCH = {"train_4k": 32, "prefill_32k": 8, "decode_32k": 32}
PEAK_BAND = 0.20
CARD_SHAPES = tuple(CARD_BATCH)


def run_dryruns(jobs, out_dir: Path) -> dict:
    """Each job's dry run in its own process, all at once, off the card
    (its fake process group never meets this process) -> {label: the
    results of its --out file}.  Raises if one exits non-zero."""
    out_dir.mkdir(parents=True, exist_ok=True)
    env = dict(__import__("os").environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(SRC))
    procs = {}
    try:
        for label, args in jobs:
            out = out_dir / f"{label}.json"
            log = open(out_dir / f"{label}.log", "w")
            procs[label] = (subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
                 "--out", str(out)], env=env, stdout=log,
                stderr=subprocess.STDOUT, cwd=str(ROOT)), out, log)
        results = {}
        for label, (proc, out, log) in procs.items():
            rc = proc.wait(timeout=DRYRUN_TIMEOUT_S)
            log.close()
            if rc != 0:
                tail = (out_dir / f"{label}.log").read_text()[-2000:]
                raise AssertionError(f"dry run {label} exited {rc}: {tail}")
            results[label] = json.loads(out.read_text())["results"]
        return results
    finally:
        for proc, _, log in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()


def phase_dryrun(card) -> None:
    """The dry run's cells (DRYRUN_JOBS) traced on meta tensors over a
    fake 256- or 512-rank process group, one line a cell: per-device
    flops, HBM bytes and wire bytes, the bottleneck, the step-time bound
    at the H100's rates, the roofline fraction and the peak estimate."""
    t0 = time.time()
    results = run_dryruns(DRYRUN_JOBS, ROOT / "build" / "dryrun")
    n = 0
    for label, cells in results.items():
        for r in cells:
            n += 1
            emit({"phase": "dryrun", "card": card, "job": label,
                  "cell": f"{r['arch']} x {r['shape']}", "mesh": r["mesh"],
                  "entry": r["entry"], "n_micro": r["n_micro"],
                  "flops_per_dev": r["flops_per_dev"],
                  "bytes_per_dev": r["bytes_per_dev"],
                  "wire_bytes_per_dev": r["wire_bytes_per_dev"],
                  "bottleneck": r["bottleneck"],
                  "step_time_bound_s": r["step_time_bound"],
                  "roofline_frac": r["roofline_frac"],
                  "peak_hint_bytes": r["mem"]["peak_hint"],
                  "kernels": {k: v["calls"] for k, v in r["kernels"].items()},
                  "trace_s": r["trace_s"]})
    if n != 6:
        raise AssertionError(f"dryrun: {n} cells, expected 6")
    emit({"phase": "dryrun", "card": card, "cells": n,
          "wall_s": time.time() - t0})


def card_inputs(torch, model, cfg, shape, batch):
    """The arguments of a dryrun_card cell's entry point on the card at
    ``batch`` rows: seeded tokens; the decode state at a full window
    (each row attends all ``seq_len`` slots, the dry run's decode)."""
    from repro_torch.training import optimizer as opt_mod
    gen = torch.Generator(device="cuda").manual_seed(1)
    tok = lambda *s: torch.randint(0, cfg.vocab_size, s, generator=gen,  # noqa: E731
                                   device="cuda", dtype=torch.int32)
    if shape.kind == "train":
        return {"tokens": tok(batch, shape.seq_len),
                "labels": tok(batch, shape.seq_len)}, opt_mod
    if shape.kind == "prefill":
        return {"tokens": tok(batch, shape.seq_len)}, None
    state = model.init_decode_state(batch, shape.seq_len, device="cuda")
    state["lengths"].fill_(shape.seq_len - 1)
    return {"state": state, "tokens": tok(batch)}, None


def phase_dryrun_card(torch, kernel_fns, card) -> dict:
    """llama3.2-1b at full width and depth on a (1, 1) mesh on the card:
    for train_4k, prefill_32k and decode_32k, the dry run's estimate at
    the cut batch (CARD_BATCH), then the entry point itself
    through the kernels (the train step: kernels 7 and 7b; prefill:
    kernel 7; decode over the dense slots: kernel 1), every count zeroed
    just before the timed call.  Printed side by side: the estimated
    peak (peak_hint, plus the bytes resident on the card beside the
    arguments, by name) and max_memory_allocated (reset just before the
    call), the step-time bound and the measured step, and the roofline
    fraction at the measured time.  Fails if an estimate of the peak is
    off the measured one by more than PEAK_BAND."""
    import torch.distributed as dist
    import torch.utils._pytree as pytree
    from repro_torch.config import SHAPES
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import MeshSharding
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import build_model
    from repro_torch.training import train as train_mod
    jobs = [(s, ["--arch", "llama3.2-1b", "--shape", s, "--mesh", "1x1",
                 "--global-batch", str(b)]) for s, b in CARD_BATCH.items()]
    est = {s: r[0] for s, r in run_dryruns(
        jobs, ROOT / "build" / "dryrun_card").items()}
    cfg = get_config("llama3.2-1b")
    with socket_port() as port:
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                world_size=1, rank=0)
    counts, rows = {}, []
    try:
        mesh = make_host_mesh(device_type="cuda")
        model = build_model(cfg, MeshSharding(mesh))
        params = model.init_params(0, device="cuda")
        check_held(torch, params, "dryrun_card")
        for sname in CARD_SHAPES:
            e = est[sname]
            shape = dataclasses.replace(SHAPES[sname],
                                        global_batch=e["global_batch"])
            args, opt_mod = card_inputs(torch, model, cfg, shape,
                                        shape.global_batch)
            if shape.kind == "train":
                opt_state = opt_mod.init_state(params)
                fn = train_mod.make_train_step(model, n_micro=e["n_micro"])
                call = (lambda: fn(params, opt_state, args))
                held = (params, opt_state, args)
            elif shape.kind == "prefill":
                call = (lambda: model.prefill(params, args))
                held = (params, args)
            else:
                call = (lambda: model.decode_step(params, args["state"],
                                                  args["tokens"]))
                held = (params, args)
            out = call()                       # warm-up
            del out
            torch.cuda.synchronize()
            for k in kernel_fns.values():
                k.launches = 0
            torch.cuda.reset_peak_memory_stats()
            arg_bytes = sum(t.nbytes for t in pytree.tree_leaves(held)
                            if isinstance(t, torch.Tensor))
            resident = torch.cuda.memory_allocated() - arg_bytes
            t0 = time.perf_counter()
            out = call()
            torch.cuda.synchronize()
            step_s = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            counts[sname] = {n: k.launches for n, k in kernel_fns.items()}
            del out
            estimate = e["mem"]["peak_hint"] + resident
            err = (estimate - peak) / peak
            row = {"phase": "dryrun_card", "card": card, "cell": sname,
                   "mesh": "1x1", "global_batch": shape.global_batch,
                   "cut_from": SHAPES[sname].global_batch,
                   "n_micro": e["n_micro"],
                   "argument_bytes_est": e["mem"]["argument_bytes"],
                   "argument_bytes_card": arg_bytes,
                   "peak_hint_bytes": e["mem"]["peak_hint"],
                   "resident_bytes": resident,
                   "peak_estimate_bytes": estimate,
                   "max_memory_allocated": peak, "peak_rel_err": err,
                   "step_time_bound_s": e["step_time_bound"],
                   "step_s": step_s,
                   "roofline_frac_est": e["roofline_frac"],
                   "roofline_frac_measured": e["model_flops_per_dev"]
                   / h100.PEAK_FLOPS_BF16 / step_s,
                   "launches": {n: c for n, c in counts[sname].items()
                                if c}}
            emit(row)
            rows.append(row)
            del args, held, call
            if shape.kind == "train":
                del opt_state, fn
            torch.cuda.empty_cache()
        del params
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    need = {"train_4k": ("flash_prefill", "flash_prefill_bwd"),
            "prefill_32k": ("flash_prefill",),
            "decode_32k": ("paged_decode",)}
    for sname, names in need.items():
        for n in names:
            if not counts[sname][n]:
                raise AssertionError(f"dryrun_card {sname}: kernel {n} was "
                                     f"not launched")
    for row in rows:
        if not abs(row["peak_rel_err"]) <= PEAK_BAND:
            raise AssertionError(
                f"dryrun_card {row['cell']}: estimated peak "
                f"{row['peak_estimate_bytes'] / 1e9:.3f} GB vs "
                f"max_memory_allocated {row['max_memory_allocated'] / 1e9:.3f}"
                f" GB ({row['peak_rel_err']:+.1%}, band {PEAK_BAND:.0%})")
    return counts


@contextlib.contextmanager
def socket_port():
    """A free localhost port, released on entry to the block."""
    import socket
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    yield port


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
    global cost, h100
    from repro_torch.kernels import cost
    from repro_torch.launch import mesh as h100
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if sys.argv[1:2] == ["--mla-depth-probe"]:
        return probe_mla_depth(torch, int(sys.argv[2]))
    from repro_torch.configs import get_config
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.flash_prefill import (flash_prefill,
                                                   flash_prefill_bwd)
    from repro_torch.kernels.mla_paged_decode import mla_paged_decode
    from repro_torch.kernels.paged_attention import (
        paged_decode_attention, paged_decode_attention_int8)
    from repro_torch.kernels.paged_prefill import (mla_paged_prefill,
                                                   mla_paged_prefill_segments,
                                                   paged_prefill_attention,
                                                   paged_prefill_segments)
    from repro_torch.models.model import build_model
    from repro_torch.serving import EngineConfig
    from repro_torch.serving.scheduler import Scheduler, SchedulerConfig
    kernel_fns = {"paged_decode": paged_decode_attention,
                  "paged_prefill": paged_prefill_attention,
                  "paged_prefill_seg": paged_prefill_segments,
                  "mla_paged_decode": mla_paged_decode,
                  "mla_paged_prefill": mla_paged_prefill,
                  "mla_paged_prefill_seg": mla_paged_prefill_segments,
                  "flash_prefill": flash_prefill,
                  "paged_decode_int8": paged_decode_attention_int8,
                  "flash_prefill_bwd": flash_prefill_bwd}

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
    rows.update(phase_train_kernels(torch, smi))
    rows.update(phase_flash_long(torch, smi))
    phase_decode_lse(torch, ops, smi)
    memory_left(torch, "kernels")

    # each path is driven with every count zeroed just before it; a
    # kernel's launches are those of its own path (``by_path``: every
    # path's counts)
    by_path = {}
    params, by_path["serve"] = phase_serve(
        torch, kernel_fns, GQA_PATH, smi, get_config("llama3.2-1b"),
        EngineConfig(), system_blocks=2, shared_tail=128, check_calls=True)
    launches = {name: by_path["serve"][name] for name in GQA_PATH}
    phase_parity(torch, params, smi)
    del params
    torch.cuda.empty_cache()
    memory_left(torch, "serve")
    granite = get_config("granite-moe-3b-a800m")
    params, by_path["moe_serve"] = phase_serve(
        torch, kernel_fns, GQA_PATH, smi, granite, EngineConfig(),
        system_blocks=2, shared_tail=128, phase="moe_serve",
        instrument=moe_drops(torch), check_calls=True)
    phase_moe_parity(torch, params, granite, smi,
                     rows=Scheduler(granite, SchedulerConfig(
                         kv_budget_bytes=EngineConfig().kv_budget_bytes,
                         max_len=EngineConfig().max_len)).n_slots)
    del params
    torch.cuda.empty_cache()
    memory_left(torch, "moe_serve")
    params, by_path["mla_serve"] = phase_serve(
        torch, kernel_fns, MLA_PATH, smi, mla_cfg,
        EngineConfig(max_len=MLA_MAX_LEN), system_blocks=1, shared_tail=588,
        phase="mla_serve",
        pool=(MLA_ROWS, MLA_TABLE_PAGES, MLA_POOL_PAGES), check_calls=True)
    launches.update({name: by_path["mla_serve"][name] for name in MLA_PATH})
    phase_mla_parity(torch, params, mla_cfg, smi)
    # MLA on the dense slots and with monolithic prefill, same weights
    # (the returned tree is that one: binding it would outlive `del`)
    by_path["mla_dense_serve"] = phase_serve(
        torch, kernel_fns, MLA_DENSE_PATH, smi, mla_cfg,
        EngineConfig(paged=False, max_len=MLA_MAX_LEN), system_blocks=1,
        shared_tail=588, phase="mla_dense_serve", params=params,
        expect=("inject_hits", "monolithic_prefills"), check_calls=True)[1]
    by_path["mla_monolithic_serve"] = phase_serve(
        torch, kernel_fns, MLA_DENSE_PATH, smi, mla_cfg,
        EngineConfig(chunked_prefill=False, fused_step=False,
                     max_len=MLA_MAX_LEN), system_blocks=1, shared_tail=588,
        phase="mla_monolithic_serve", params=params,
        expect=("cow_share_hits", "monolithic_prefills"),
        check_calls=True)[1]
    phase_mla_dense_parity(torch, params, mla_cfg, smi)
    del params
    torch.cuda.empty_cache()
    memory_left(torch, "mla")

    llama = get_config("llama3.2-1b")
    params, by_path["dense_serve"] = phase_serve(
        torch, kernel_fns, DENSE_PATH, smi, llama, EngineConfig(paged=False),
        system_blocks=2, shared_tail=128, phase="dense_serve",
        expect=("inject_hits", "monolithic_prefills"))
    launches["flash_prefill"] = by_path["dense_serve"]["flash_prefill"]
    by_path["monolithic_serve"] = phase_serve(
        torch, kernel_fns, DENSE_PATH, smi, llama,
        EngineConfig(chunked_prefill=False, fused_step=False),
        system_blocks=2, shared_tail=128, phase="monolithic_serve",
        expect=("cow_share_hits", "monolithic_prefills"),
        params=params)[1]
    by_path["int8_decode"] = phase_int8_decode(torch, kernel_fns, params,
                                               smi, llama)
    launches["paged_decode_int8"] = \
        by_path["int8_decode"]["paged_decode_int8"]
    phase_dense_parity(torch, params, llama, smi)
    del params
    torch.cuda.empty_cache()
    memory_left(torch, "dense")

    # the cross-attention families on the dense slot state
    for name, prompts, max_len, steps, prompt, phase in (
            ("llama-3.2-vision-11b", VLM_PROMPTS, VLM_MAX_LEN, VLM_STEPS,
             VLM_PARITY_PROMPT, "vlm"),
            ("whisper-tiny", ENCDEC_PROMPTS, ENCDEC_MAX_LEN, ENCDEC_STEPS,
             ENCDEC_PARITY_PROMPT, "encdec")):
        cfg = get_config(name)
        params = cross_params(torch, cfg)
        by_path[phase + "_generate"] = phase_cross_generate(
            torch, kernel_fns, smi, cfg, params, prompts, max_len, steps,
            phase + "_generate")
        phase_cross_parity(torch, params, cfg, smi, prompt, len(prompts),
                           max_len, phase + "_parity")
        del params
        torch.cuda.empty_cache()
        memory_left(torch, phase)

    # the recurrent families on their dense per-row state
    for name, phase in (("zamba2-1.2b", "hybrid"), ("rwkv6-1.6b", "rwkv")):
        cfg = get_config(name)
        params = build_model(cfg).init_params(0, device="cuda")
        by_path[phase + "_generate"] = phase_recurrent_generate(
            torch, kernel_fns, smi, cfg, params, RECURRENT_PROMPTS,
            RECURRENT_MAX_LEN, RECURRENT_STEPS, phase + "_generate")
        if phase == "hybrid":
            phase_hybrid_parity(torch, params, cfg, smi,
                                HYBRID_PARITY_PROMPT, len(RECURRENT_PROMPTS),
                                RECURRENT_MAX_LEN)
        phase_recurrent_checks(torch, smi, cfg, params, phase + "_checks")
        del params
        torch.cuda.empty_cache()
        memory_left(torch, phase)

    # training: llama3.2-1b at full width and depth, then the same step at
    # two layers against the plain versions and across a checkpoint, then
    # one step of the other families
    by_path["train"] = phase_train(torch, kernel_fns, smi, llama)
    launches["flash_prefill_bwd"] = by_path["train"]["flash_prefill_bwd"]
    memory_left(torch, "train")
    phase_train_parity(torch, smi, llama)
    memory_left(torch, "train_parity")
    phase_train_resume(torch, smi, llama)
    memory_left(torch, "train_resume")
    for name, counts in phase_train_families(torch, kernel_fns,
                                             smi).items():
        by_path[f"train_families:{name}"] = counts
    memory_left(torch, "train_families")
    # MLA trains in the non-absorbed form: kernel 7 and its backward at
    # Q/K 192 over V 128
    by_path["train_mla"] = phase_train(
        torch, kernel_fns, smi,
        dataclasses.replace(mla_cfg, n_layers=TRAIN_MLA_LAYERS),
        phase="train_mla", batch=TRAIN_MLA_BATCH, reference=None)
    phase_train_parity(torch, smi, mla_cfg, phase="train_mla_parity",
                       layers=1, batch=TRAIN_MLA_PARITY_BATCH,
                       seq=TRAIN_MLA_PARITY_SEQ, attn_leaves=MLA_ATTN_LEAVES)
    memory_left(torch, "train_mla")
    # the launcher under a one-rank nccl group, crash and resume included,
    # against the same command with no group (its own processes: their
    # launches are their own counts, printed by each run)
    for name, r in phase_train_launch(torch, kernel_fns, smi,
                                      llama).items():
        by_path[f"train_launch:{name}"] = {
            k: r["launches"].get(k, 0) for k in kernel_fns}
    memory_left(torch, "train_launch")

    # distribution and launch analysis: the dry run's cells, then its
    # estimates held to llama3.2-1b's entry points on the card
    phase_dryrun(smi)
    for sname, counts in phase_dryrun_card(torch, kernel_fns, smi).items():
        by_path[f"dryrun_card:{sname}"] = counts
    memory_left(torch, "dryrun_card")

    phase_replay(torch, kernel_fns, smi)
    full = replay_full_config()
    params = build_model(full).init_params(0, device="cuda")
    phase_replay_full(torch, kernel_fns, smi, full, params)
    phase_cluster(torch, kernel_fns, smi, full, params)
    phase_frontend(torch, kernel_fns, smi, full, params)
    del params
    torch.cuda.empty_cache()
    memory_left(torch, "frontend")
    by_path.update(phase_examples(torch, kernel_fns, smi))
    by_path["chaos"] = phase_chaos(torch, kernel_fns, smi)

    summary = []
    for name, row in rows.items():
        if name not in REPLACES:
            continue               # a second shape of a listed kernel
        source, replaces = REPLACES[name]
        summary.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "body": row["body"],
                        "launches": launches[name],
                        "launches_by_path": {
                            path: counts[name]
                            for path, counts in by_path.items()
                            if counts[name]},
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
