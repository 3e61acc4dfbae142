"""The serving engine: a unified token-budget step loop mixing chunked
prefill with decode in one batch per step, over the paged block-table
KV cache, with the paper's predictive multi-tier cache manager on the
prompt-block level and an async tier-transfer worker off the step loop.

Per step:
  1. poll the async transfer worker: completed demotions release their
     staging buffers, completed fetches un-park restoring requests;
  2. admit waiting requests into free slots — radix-tree prefix match
     maps pool-resident prefix pages straight into the new request's
     block table (copy-on-write sharing; lower-tier blocks are copied
     from their payloads), the content-segment index resumes resident
     blocks past a divergence, and the unmatched rest enters PREFILL;
  3. budget-select the mixed batch (``Scheduler.plan_step``): every
     decode stream gets one token, prefill chunks fill the rest of
     ``max_step_tokens``;
  4. granted prefill chunks run through the paged prefill kernels
     (gap chunks between resumed segments through the segment kernel)
     and scatter into the pool; a request whose cursor reaches the
     prompt end transitions PREFILL -> DECODE;
  5. one fused decode over the decoding slots: paged decode attention,
     logits and per-row sampling, with one device->host copy of the
     sampled tokens;
  6. finished requests release their slot's page references;
  7. RoPE prefetch promotions go to the transfer worker;
  8. stragglers are preempted: their KV payload is handed to the async
     worker for demotion and restored from the staging buffer or by an
     async fetch.

That is the default path of the JAX package's engine (``paged``,
``chunked_prefill``, ``fused_step`` and ``segment_reuse`` on).  Its A/B
paths are ported too:

  * ``paged=False`` serves from the dense ``SlotKVCache`` (no page
    sharing, so prefix hits are copied in from their payloads), and,
    having no pool to chunk into, prefills monolithically;
  * ``chunked_prefill=False`` prefills at admission, in one forward per
    request: the flash prefill kernel for a prompt with no prefix hit
    (``DecoderModel.prefill``), plain attention for the suffix after a
    cached prefix (``prefill_suffix``); suffixes are padded to a
    multiple of ``PREFILL_PAD`` tokens;
  * ``fused_step=False`` decodes, then samples each request on its own
    (``sampler.sample``, one device->host copy per request).

Segment reuse needs chunked prefill.  MLA and MoE models serve every
path (MLA's dense slots hold its latent).

The hooks of the cluster and the front-end are the JAX engine's:
``bind_fleet_store`` binds tier 4 to a fleet-shared store, which
admission probes past the local prefix match (``shared_fetch_hits``)
and registration publishes to; ``cancel_request`` drops one live
request; ``release_resources`` tears a failed replica down and, unlike
the JAX engine, also drops its KV pool from the device at once.  The
payloads crossing the fleet store are the tiers' numpy payloads (bf16
as ``uint16`` bits).  Entry points run on CUDA unless the caller passes
``device="cpu"``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.config import FAMILY_DECODER, FAMILY_MOE, ModelConfig
from repro_torch.core import sizing
from repro_torch.core.cache_manager import PredictiveCacheManager
from repro_torch.core.tiers import (PAPER_TIER_SPECS, AsyncTierTransferWorker,
                                    TierSpec, TransferRequest)
from repro_torch.models.common import resolve_device
from repro_torch.models.model import build_model
from repro_torch.serving import sampler as sampler_mod
from repro_torch.serving.kvcache import PagedKVCache, SlotKVCache
from repro_torch.serving.request import Phase, Request, SamplingParams
from repro_torch.serving.scheduler import Scheduler, SchedulerConfig
from repro_torch.serving.spans import RECORDER, to_device, to_host

# dense bf16 tensor-core peak of one H100 SXM (FLOP/s): prices the
# recompute of one prompt block for the cache manager
H100_BF16_PEAK_FLOPS = 989e12
# monolithic prefill pads a suffix to a multiple of this many tokens (the
# JAX engine's default bucket), so both engines fill the same slots and
# refuse the same requests
PREFILL_PAD = 32


@dataclass
class EngineConfig:
    max_len: int = 512
    kv_budget_bytes: float = float(1 << 30)
    policy: str = "bayesian"
    enable_dedup: bool = True
    enable_prefetch: bool = True
    enable_multi_tier: bool = True
    status_quo_sizing: bool = False
    deadline_s: float = 600.0
    seed: int = 0
    tier_specs: Tuple[TierSpec, ...] = PAPER_TIER_SPECS
    paged: bool = True                # block-table KV pool (False: dense
    #                                   slot layout A/B)
    page_tokens: int = 64             # physical page size (kernel tile)
    async_transfers: bool = True      # tier moves off the step loop
    chunked_prefill: bool = True      # mixed token-budget batches (False:
    #                                   monolithic prefill at admission)
    prefill_chunk_tokens: int = 64    # kernel chunk size
    max_step_tokens: int = 256        # per-step token budget
    tier0_from_budget: bool = True    # rescale tier-0 capacity to
    #                                   kv_budget_bytes (False: keep the
    #                                   supplied tier_specs verbatim)
    segment_reuse: bool = True        # content-segment index: resume
    #                                   pool-resident blocks mid-prompt
    fault_injector: Optional[object] = None   # core/faults.FaultInjector
    retry_policy: Optional[object] = None     # core/faults.RetryPolicy
    transfer_timeout_s: float = 30.0  # async transfer wall deadline
    fused_step: bool = True           # decode attention + logits +
    #                                   sampling in one call per step
    #                                   (False: per-request sampling)


class ServingEngine:
    def __init__(self, cfg: ModelConfig,
                 engine_cfg: Optional[EngineConfig] = None,
                 params=None, device=None):
        engine_cfg = EngineConfig() if engine_cfg is None else engine_cfg
        if cfg.family not in (FAMILY_DECODER, FAMILY_MOE):
            # the VLM and the encoder-decoder need their patches / frames
            # beside each prompt; the JAX slot cache drops a hybrid
            # model's Mamba state (it copies only K/V into a slot), so
            # there is no correct engine behaviour to copy for the
            # hybrid and RWKV6.  All four have model-level entry points.
            raise NotImplementedError(
                f"{cfg.name}: the engine serves decoder-only models, not "
                f"the {cfg.family!r} family (the JAX slot cache drops a "
                f"recurrent state; use the model's prefill / decode_step)")
        self.cfg = cfg
        self.ecfg = engine_cfg
        self.device = resolve_device(device)
        self.model = build_model(cfg)
        self.paged = engine_cfg.paged
        # the JAX rule: chunked prefill needs the paged pool, segment
        # reuse needs chunked prefill
        self.chunked = engine_cfg.chunked_prefill and self.paged
        self.seg_enabled = engine_cfg.segment_reuse and self.chunked
        self.fused = engine_cfg.fused_step
        self.params = params if params is not None else \
            self.model.init_params(engine_cfg.seed, device=self.device)
        self.scheduler = Scheduler(cfg, SchedulerConfig(
            kv_budget_bytes=engine_cfg.kv_budget_bytes,
            max_len=engine_cfg.max_len,
            deadline_s=engine_cfg.deadline_s,
            status_quo_sizing=engine_cfg.status_quo_sizing,
            max_step_tokens=engine_cfg.max_step_tokens))
        # the kernels follow the device: CUDA kernels on the card, their
        # plain versions on the CPU
        self.kernel_backend = "cuda" if self.device.type == "cuda" \
            else "torch"
        if self.paged:
            bt = sizing.block_tokens(cfg)
            if bt % engine_cfg.page_tokens != 0:
                raise ValueError(
                    f"page_tokens {engine_cfg.page_tokens} must divide the "
                    f"manager block size {bt}")
            self.kv = PagedKVCache(self.model, self.scheduler.n_slots,
                                   engine_cfg.max_len,
                                   page_tokens=engine_cfg.page_tokens,
                                   device=self.device)
        else:
            self.kv = SlotKVCache(self.model, self.scheduler.n_slots,
                                  engine_cfg.max_len, device=self.device)
        specs = list(engine_cfg.tier_specs)
        if engine_cfg.tier0_from_budget:
            specs[0] = TierSpec(0, specs[0].name, specs[0].bandwidth,
                                specs[0].latency, specs[0].cost_per_gb_hour,
                                engine_cfg.kv_budget_bytes)
        self.manager = PredictiveCacheManager(
            cfg, specs=tuple(specs), policy=engine_cfg.policy,
            enable_dedup=engine_cfg.enable_dedup,
            enable_prefetch=engine_cfg.enable_prefetch,
            enable_multi_tier=engine_cfg.enable_multi_tier,
            fault_injector=engine_cfg.fault_injector,
            retry_policy=engine_cfg.retry_policy)
        self.worker = (AsyncTierTransferWorker(
            self.manager.hierarchy,
            default_timeout_s=engine_cfg.transfer_timeout_s)
            if engine_cfg.async_transfers else None)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(engine_cfg.seed + 1)
        # request_id -> [payload | None, length]; payload is the staging
        # buffer — dropped once the async demotion write lands
        self._preempted_payloads: Dict[int, list] = {}
        # request_id -> ticket of the *latest* demote
        self._demote_tickets: Dict[int, int] = {}
        self._inflight_prefetch: set = set()
        self._session_tool: Dict[str, Optional[str]] = {}
        # block-registration epoch: _extend_prefix only re-walks the
        # radix tree when new blocks appeared since the request's last
        # match (request_id -> epoch seen)
        self._block_epoch = 0
        self._prefix_checked: Dict[int, int] = {}
        self._admit_transition: Dict[int, str] = {}
        self.steps = 0
        self.idle_transfer_waits = 0
        self.prefill_chunks = 0        # kernel chunk calls
        self.prefill_tokens_total = 0  # prompt tokens through the chunk path
        self.monolithic_prefills = 0   # requests prefilled at admission
        self.cow_share_hits = 0        # prefix blocks served by CoW page map
        self.inject_hits = 0           # ... by tier payload injection
        self.shared_fetch_hits = 0     # ... imported from the fleet-shared
        #                                tier (content another replica
        #                                published; charged as tier-4 fetch)
        self.segment_share_hits = 0    # mid-prompt blocks resumed by CoW
        self.segment_inject_hits = 0   # ... by tier payload injection
        self.segment_chunks = 0        # position-explicit kernel chunks
        self.last_step_prefill_tokens = 0
        self.max_step_prefill_tokens = 0
        # host spans while a profiler records (``serving/spans.py``);
        # request_id -> its open ``sched.wait`` span
        self.spans = RECORDER
        self._slot_waits: Dict[int, int] = {}

    # ------------------------------------------------------------------
    def _tokens(self, rows) -> torch.Tensor:
        return to_device(rows, torch.int32, self.device)

    def bind_fleet_store(self, store, owner: str) -> bool:
        """Bind this replica's tier 4 to the cluster's fleet-shared KV
        store (see ``core/tiers.FleetKVStore``); call before traffic."""
        return self.manager.bind_fleet_store(store, owner)

    # ------------------------------------------------------------------
    def submit(self, prompt: Sequence[int], *, params: SamplingParams = None,
               session_id: str = None, block_type: str = "user_context",
               tool: str = None, retain_blocks: bool = False,
               block_types: Sequence[str] = None) -> Request:
        req = Request(prompt=list(prompt),
                      params=params or SamplingParams(),
                      session_id=session_id, block_type=block_type,
                      tool=tool, retain_blocks=retain_blocks,
                      block_types=list(block_types) if block_types else None)
        if self.chunked:
            # chunked prefill writes only valid tokens (no pad rounding)
            need = req.prompt_len + req.params.max_new_tokens + 1
        else:
            need = (-(-req.prompt_len // PREFILL_PAD) * PREFILL_PAD
                    + req.params.max_new_tokens + 1)
        if need > self.ecfg.max_len:
            raise ValueError(
                f"request needs {need} cache slots > max_len "
                f"{self.ecfg.max_len} (prompt {req.prompt_len} + "
                f"max_new {req.params.max_new_tokens})")
        self.scheduler.submit(req)
        if self.spans.poll():
            self._slot_waits[req.request_id] = self.spans.begin(
                "sched.wait", req.request_id, nest=False)
        return req

    def _acquire_slot(self, req: Request) -> int:
        """A free slot for ``req``; the first ends its ``sched.wait``."""
        slot = self.kv.acquire(req.request_id, req.prompt_len)
        sid = self._slot_waits.pop(req.request_id, 0)
        if sid:
            self.spans.end(sid)
        return slot

    # ------------------------------------------------------------------
    # admission: prefix reuse + segment reuse
    # ------------------------------------------------------------------
    def _admit(self, req: Request, slot: int) -> None:
        mgr = self.manager
        bt = mgr.block_tokens
        transition = "reasoning_step"
        if req.tool is not None:
            prev = self._session_tool.get(req.session_id)
            transition = mgr.on_tool_switch(prev, req.tool,
                                            kv_bytes=sizing.decode_state_bytes(
                                                self.cfg, req.prompt_len))
            self._session_tool[req.session_id] = req.tool

        # restore a preempted request wholesale
        if req.request_id in self._preempted_payloads:
            payload, length = self._preempted_payloads.pop(req.request_id)
            self.kv.restore_slot(slot, payload, length)
            self._drop_tier_copy(req.request_id)
            if req.prefill_left > 0:
                self.scheduler.start_prefill(req, slot)
            else:
                self.scheduler.start(req, slot)
            return

        # prefill covers tokens[:-1]; the first decode step consumes the
        # final token.  ``generated`` is non-empty only on lost-payload
        # recovery, where the whole context is re-prefilled.
        tokens_all = list(req.prompt) + list(req.generated)
        effective = tokens_all[:-1]
        req.prefill_tokens, req.prefill_pos = None, 0
        matched = mgr.match_prefix(effective)
        prefix_len, n_hit = 0, 0
        for bid in matched:
            res = mgr.access(bid, transition=transition)
            if res.recomputed:
                break                      # payload lost -> recompute rest
            if res.hit:
                req.hot_hit_blocks += 1
            if self.paged and self.kv.can_share(bid):
                self.kv.share_block(slot, bid, prefix_len)
                self.cow_share_hits += 1
            else:
                pl = mgr._payloads.get(bid)
                if pl is None:
                    break
                self.kv.inject_block(slot, pl, prefix_len)
                self.inject_hits += 1
            prefix_len += bt
            n_hit += 1
        # fleet-shared tier probe: past the local radix match, content
        # another replica published extends the prefix by a tier-4
        # fetch and a payload injection
        if mgr.fleet_bound:
            while prefix_len + bt <= len(effective):
                blk = effective[prefix_len:prefix_len + bt]
                btype = req.block_type
                if req.block_types is not None and \
                        prefix_len // bt < len(req.block_types):
                    btype = req.block_types[prefix_len // bt]
                got = mgr.import_shared_block(
                    blk, block_type=btype,
                    recompute_cost=self._block_recompute_cost(),
                    positions=(prefix_len, prefix_len + bt))
                if got is None:
                    break
                _, pl = got
                self.kv.inject_block(slot, pl, prefix_len)
                self.shared_fetch_hits += 1
                req.shared_hit_blocks += 1
                prefix_len += bt
                n_hit += 1
        req.prefix_hit_blocks = n_hit

        # segment reuse: resident runs of full blocks at matching
        # positions mid-prompt, materialized as CoW page maps or payload
        # injections; the gaps prefill through the segment kernel
        if self.seg_enabled:
            seg_spans = []
            req.segment_hit_blocks = 0
            for seg in mgr.match_segments(effective, start_block=n_hit):
                run_start, run_len = seg.start_block, 0
                for j, bid in enumerate(seg.block_ids):
                    res = mgr.access(bid, transition=transition)
                    ok = not res.recomputed
                    if ok:
                        start = (seg.start_block + j) * bt
                        if self.paged and self.kv.can_share(bid):
                            self.kv.share_block(slot, bid, start)
                            self.segment_share_hits += 1
                        else:
                            pl = mgr._payloads.get(bid)
                            if pl is None:
                                ok = False
                            else:
                                self.kv.inject_block(slot, pl, start)
                                self.segment_inject_hits += 1
                    if ok:
                        if res.hit:
                            req.hot_hit_blocks += 1
                        if run_len == 0:
                            run_start = seg.start_block + j
                        run_len += 1
                        req.segment_hit_blocks += 1
                    else:
                        if run_len:
                            seg_spans.append((run_start, run_len))
                        run_len = 0
                if run_len:
                    seg_spans.append((run_start, run_len))
            req.seg_spans = seg_spans

        if self.chunked:
            # prefix-hit blocks advance the chunk cursor for free; the
            # rest streams through plan_step()
            req.prefill_tokens = effective
            req.prefill_pos = prefix_len
            self._prefix_checked[req.request_id] = self._block_epoch
            self._admit_transition[req.request_id] = transition
            self.kv.set_length(slot, prefix_len)
            self.scheduler.start_prefill(req, slot)
            if req.seg_spans:
                self._skip_resumed(req)
            if req.prefill_left == 0:
                self._finish_prefill(req)
            return

        # monolithic prefill (dense layout / chunked_prefill=False): the
        # whole unmatched suffix in one forward, padded to PREFILL_PAD
        suffix = list(effective[prefix_len:])
        padded_len = max(PREFILL_PAD,
                         -(-len(suffix) // PREFILL_PAD) * PREFILL_PAD)
        batch = {"tokens": self._tokens(
            [suffix + [0] * (padded_len - len(suffix))])}
        rec = self.spans
        if prefix_len == 0:
            sid = rec.begin("model.forward") if rec.on else 0
            _, state1 = self.model.prefill(self.params, batch,
                                           backend=self.kernel_backend)
            if sid:
                rec.end(sid)
            self.kv.write_prefill(slot, state1, padded_len)
        else:
            prefix = self.kv.prefix_kv(slot, prefix_len)
            sid = rec.begin("model.forward") if rec.on else 0
            _, cache = self.model.prefill_suffix(
                self.params, batch, prefix, prefix_len,
                backend=self.kernel_backend)
            if sid:
                rec.end(sid)
            self.kv.write_range(
                slot, {src: c for (_, src), c in zip(self.kv.kinds, cache)},
                prefix_len, padded_len)
        self.monolithic_prefills += 1
        # the true length: pad positions lie past it, masked by length
        self.kv.set_length(slot, len(effective))
        self._register_prompt_blocks(req, slot, effective)
        self.scheduler.start(req, slot)

    def _register_prompt_blocks(self, req: Request, slot: int,
                                effective: Sequence[int]) -> None:
        """Register the prompt's full blocks with the cache manager and
        pin their pool pages for cross-request reuse."""
        mgr = self.manager
        bt = mgr.block_tokens
        n_full = (len(effective) // bt) * bt
        new_ids = mgr.register_sequence(
            list(effective[:n_full]), block_type=req.block_type,
            block_types=req.block_types,
            recompute_cost_per_block=self._block_recompute_cost())
        for i, bid in enumerate(new_ids):
            if bid not in mgr._payloads:
                pl = self.kv.extract_block(slot, i * bt, bt)
                mgr._payloads[bid] = pl
                mgr.hierarchy.attach_payload(bid, pl)
            if self.paged:
                self.kv.register_block_pages(bid, slot, i * bt, bt)
            if mgr.fleet_bound:
                # publish on registration: sibling replicas may import it
                mgr.publish_block(bid)
        req.block_ids = new_ids
        if new_ids:
            self._block_epoch += 1

    # ------------------------------------------------------------------
    # chunked prefill (token-budget mixed batches)
    # ------------------------------------------------------------------
    def _finish_prefill(self, req: Request) -> None:
        self._register_prompt_blocks(req, req.slot, req.prefill_tokens)
        self._prefix_checked.pop(req.request_id, None)
        self._admit_transition.pop(req.request_id, None)
        self.scheduler.begin_decode(req)

    def _extend_prefix(self, req: Request) -> int:
        """Mid-prefill prefix extension: blocks registered since this
        request was admitted advance the chunk cursor for free."""
        mgr, bt = self.manager, self.manager.block_tokens
        if req.prefill_pos % bt != 0:
            return 0
        if self._prefix_checked.get(req.request_id) == self._block_epoch:
            return 0
        self._prefix_checked[req.request_id] = self._block_epoch
        transition = self._admit_transition.get(req.request_id,
                                                "reasoning_step")
        matched = mgr.match_prefix(req.prefill_tokens)
        covered = set()
        for (s, n) in req.seg_spans:
            covered.update(range(s, s + n))
        advanced = 0
        for i in range(req.prefill_pos // bt, len(matched)):
            if i in covered:
                req.prefill_pos += bt
                self.kv.set_length(req.slot, req.prefill_pos)
                continue
            bid = matched[i]
            res = mgr.access(bid, transition=transition)
            if res.recomputed:
                break
            if res.hit:
                req.hot_hit_blocks += 1
            if self.kv.can_share(bid):
                self.kv.share_block(req.slot, bid, i * bt)
                self.cow_share_hits += 1
            else:
                pl = mgr._payloads.get(bid)
                if pl is None:
                    break
                if req.seg_spans:
                    pg = self.kv.page
                    self.kv.ensure_pages_at(
                        req.slot,
                        list(range(i * bt // pg, (i * bt + bt) // pg)))
                self.kv.inject_block(req.slot, pl, i * bt)
                self.inject_hits += 1
            req.prefill_pos += bt
            req.prefix_hit_blocks += 1
            advanced += bt
            self.kv.set_length(req.slot, req.prefill_pos)
        return advanced

    def _skip_resumed(self, req: Request) -> None:
        """Jump the chunk cursor over resumed segments that touch it."""
        bt = self.manager.block_tokens
        for (s, n) in req.seg_spans:
            if s * bt == req.prefill_pos:
                req.prefill_pos = (s + n) * bt
                self.kv.set_length(req.slot, req.prefill_pos)

    def _gap_positions(self, req: Request, n: int) -> list:
        """The next <= ``n`` unfilled prompt positions at/after the
        chunk cursor, skipping resumed spans (ascending)."""
        bt = self.manager.block_tokens
        spans = [(s * bt, (s + k) * bt) for (s, k) in req.seg_spans]
        out = []
        p = req.prefill_pos
        L = len(req.prefill_tokens)
        while len(out) < n and p < L:
            inside = next((e for (s, e) in spans if s <= p < e), None)
            if inside is not None:
                p = inside
                continue
            out.append(p)
            p += 1
        return out

    def _run_seg_chunk(self, req: Request, n_tokens: int) -> int:
        """One position-explicit prefill chunk over the next gap tokens
        (may span several gaps).  Pad positions are -1."""
        C = self.ecfg.prefill_chunk_tokens
        positions = self._gap_positions(req, min(C, n_tokens))
        n = len(positions)
        if n == 0:
            return 0
        toks = req.prefill_tokens
        chunk = [toks[p] for p in positions]
        arr = self._tokens([chunk + [0] * (C - n)])
        cpos = self._tokens([positions + [-1] * (C - n)])
        state = self.kv.chunk_state(req.slot)
        rec = self.spans
        sid = rec.begin("model.forward") if rec.on else 0
        state1 = self.model.prefill_chunk_seg(
            self.params, state, arr, cpos, backend=self.kernel_backend)
        if sid:
            rec.end(sid)
        self.kv.write_chunk_positions(req.slot, state1, positions)
        req.prefill_pos = positions[-1] + 1
        self.kv.set_length(req.slot, req.prefill_pos)
        self._skip_resumed(req)
        self.prefill_chunks += 1
        self.segment_chunks += 1
        return n

    def _run_prefill_chunks(self, req: Request, n_tokens: int) -> int:
        """Advance ``req``'s chunk cursor by up to ``n_tokens`` prompt
        tokens in fixed-size kernel chunks; returns budget tokens used."""
        C = self.ecfg.prefill_chunk_tokens
        toks = req.prefill_tokens
        done = 0
        self._extend_prefix(req)
        self._skip_resumed(req)
        while done < n_tokens and req.prefill_pos < len(toks):
            if req.seg_spans:
                n = self._run_seg_chunk(req, n_tokens - done)
                if n == 0:
                    break
                done += n
            else:
                n = min(C, n_tokens - done, len(toks) - req.prefill_pos)
                chunk = list(toks[req.prefill_pos:req.prefill_pos + n])
                arr = self._tokens([chunk + [0] * (C - n)])
                off = self._tokens([req.prefill_pos])
                state = self.kv.chunk_state(req.slot)
                rec = self.spans
                sid = rec.begin("model.forward") if rec.on else 0
                state1 = self.model.prefill_chunk(
                    self.params, state, arr, off,
                    backend=self.kernel_backend)
                if sid:
                    rec.end(sid)
                self.kv.write_chunk(req.slot, state1, req.prefill_pos, n)
                req.prefill_pos += n
                done += n
                self.prefill_chunks += 1
            self._extend_prefix(req)
            self._skip_resumed(req)
        if req.prefill_left == 0:
            self._finish_prefill(req)
        return done

    def _block_recompute_cost(self) -> float:
        """Seconds to re-prefill one block on the target card."""
        flops = 2 * self.cfg.active_param_count() * self.manager.block_tokens
        return flops / H100_BF16_PEAK_FLOPS

    # ------------------------------------------------------------------
    # async transfer bookkeeping
    # ------------------------------------------------------------------
    def _drop_tier_copy(self, request_id: int) -> None:
        bid = f"preempt-{request_id}"
        loc = self.manager.hierarchy.locate(bid)
        if loc is not None:
            self.manager.hierarchy[loc].evict(bid)

    def _poll_transfers(self) -> None:
        for ev in self.scheduler.poll_transfers(self.worker):
            req = ev.request
            if req.kind == "demote" and req.tag:
                rid = int(req.tag)
                if self._demote_tickets.get(rid) != req.ticket:
                    continue           # stale epoch
                self._demote_tickets.pop(rid, None)
                ent = self._preempted_payloads.get(rid)
                if ent is not None and ev.ok:
                    ent[0] = None          # staging buffer released
                elif ent is None:
                    self._drop_tier_copy(rid)
            elif req.kind == "fetch" and req.tag:
                rid = int(req.tag)
                ent = self._preempted_payloads.get(rid)
                if ev.ok and ev.payload is not None and ent is not None:
                    ent[0] = ev.payload
                else:
                    if ent is not None and not ev.ok:
                        self.manager.stats.fetch_recomputes += 1
                    self._preempted_payloads.pop(rid, None)
                self.scheduler.on_transfer_complete(rid)
            elif req.tag == "prefetch":
                self._inflight_prefetch.discard(req.block_id)

    def _begin_async_restore(self, req: Request) -> None:
        bid = f"preempt-{req.request_id}"
        loc = self.manager.hierarchy.locate(bid)
        if loc is None:
            self._preempted_payloads.pop(req.request_id, None)
            self._admit(req, self._acquire_slot(req))
            return
        self.scheduler.block_on_transfer(req)
        self.worker.submit(TransferRequest(
            bid, loc, 0, kind="fetch", evict_src=True,
            tag=str(req.request_id)))

    def _submit_prefetch_many(self, items) -> None:
        """Plan every decoding request's prefetch window under one
        manager lock, then submit."""
        if not items:
            return
        if self.worker is None:
            for block_ids, position in items:
                self.manager.prefetch_for_position(block_ids, position)
            return
        for bid, loc in self.manager.plan_prefetch_many(items):
            if bid in self._inflight_prefetch:
                continue
            self._inflight_prefetch.add(bid)
            self.worker.submit(TransferRequest(
                bid, loc, 0, kind="custom", tag="prefetch",
                execute=(lambda h, b=bid, l=loc:
                         (self.manager.promote_async(b, l), None))))

    # ------------------------------------------------------------------
    # batched decode: fused (default) and per-request-sampling A/B paths
    # ------------------------------------------------------------------
    def _decode_fused(self, decode_reqs) -> int:
        """One decode step for the whole batch — attention, logits and
        per-row sampling — with ONE device->host copy of the sampled
        tokens.  Paged: in steady-state decode the device state from the
        previous step is reused verbatim (``PagedKVCache.state_version``
        forces a rebuild after any host-side mutation).  Dense: every
        slot row decodes and advances, as in the JAX package."""
        sa = self.scheduler.step_arrays(decode_reqs, self.kv.n_slots)
        dev = self.device
        rec = self.spans
        tokens = to_device(sa["tokens"], None, dev)
        if self.paged:
            slots = [r.slot for r in decode_reqs]
            state = self.kv.decode_state(slots, reuse=True)
        sid = rec.begin("model.forward") if rec.on else 0
        if self.paged:
            logits, new_state = self.model.decode_step_paged(
                self.params, state, tokens, backend=self.kernel_backend)
            # rows outside the decode set keep their length (the model
            # advances every row), so the state is next step's input as is
            new_state["lengths"] = state["lengths"] + to_device(
                sa["active"], None, dev)
        else:
            logits, self.kv.state = self.model.decode_step(
                self.params, self.kv.state, tokens,
                backend=self.kernel_backend)
        toks = sampler_mod.sample_batched(
            logits, self._gen, to_device(sa["temperature"], None, dev),
            to_device(sa["top_k"], None, dev),
            to_device(sa["top_p"], None, dev),
            stochastic=bool((sa["temperature"] > 0).any()))
        if sid:
            rec.end(sid)
        if self.paged:
            self.kv.absorb(new_state, decode_slots=slots)
        # not the step's only wait for the card: every to_device above
        # copies from pageable memory and waits for the stream to drain
        out = to_host(toks)
        now = time.monotonic()
        produced = 0
        prefetch = []
        for req in sorted(decode_reqs, key=lambda r: r.slot):
            req.generated.append(int(out[req.slot]))
            if req.t_first_token is None:
                req.t_first_token = now
            produced += 1
            self.kv.advance(req.slot)
            if req.block_ids:
                prefetch.append((req.block_ids,
                                 self.kv.slots[req.slot].length))
        self._submit_prefetch_many(prefetch)
        return produced

    def _decode_unfused(self, decode_reqs) -> int:
        """One decode call, then one sampling call and device->host copy
        per request."""
        tokens = [0] * self.kv.n_slots
        for req in decode_reqs:
            tokens[req.slot] = (req.generated[-1] if req.generated
                                else req.prompt[-1])
        tokens = to_device(tokens, torch.int32, self.device)
        rec = self.spans
        if self.paged:
            state = self.kv.decode_state([r.slot for r in decode_reqs])
            sid = rec.begin("model.forward") if rec.on else 0
            logits, new_state = self.model.decode_step_paged(
                self.params, state, tokens, backend=self.kernel_backend)
            if sid:
                rec.end(sid)
            self.kv.absorb(new_state)
        else:
            sid = rec.begin("model.forward") if rec.on else 0
            logits, self.kv.state = self.model.decode_step(
                self.params, self.kv.state, tokens,
                backend=self.kernel_backend)
            if sid:
                rec.end(sid)
        now = time.monotonic()
        produced = 0
        for req in sorted(decode_reqs, key=lambda r: r.slot):
            slot = req.slot
            sid = rec.begin("model.forward") if rec.on else 0
            tok = sampler_mod.sample(
                logits[slot:slot + 1], self._gen,
                temperature=req.params.temperature,
                top_k=req.params.top_k, top_p=req.params.top_p)
            if sid:
                rec.end(sid)
            req.generated.append(int(to_host(tok)[0]))
            if req.t_first_token is None:
                req.t_first_token = now
            produced += 1
            self.kv.advance(slot)
            if req.block_ids:
                self._submit_prefetch_many(
                    [(req.block_ids, self.kv.slots[slot].length)])
        return produced

    # ------------------------------------------------------------------
    def step(self) -> int:
        """One engine iteration (poll transfers -> admit -> budget-select
        -> prefill chunks -> batched decode -> sample/finish); returns
        #tokens generated.  While a profiler records, each phase is a
        span (``serving/spans.py``)."""
        rec = self.spans
        sid = rec.begin("engine.step") if rec.poll() else 0
        produced = 0
        try:
            produced = self._step(rec)
        finally:
            if sid:
                rec.end(sid, produced)
        return produced

    def _step(self, rec) -> int:
        sch = self.scheduler
        sid = rec.begin("engine.admit") if rec.on else 0
        self._poll_transfers()
        for req in sch.check_stragglers():
            self.preempt(req)
        for req in sch.admissible(len(self.kv.free_slots())):
            ent = self._preempted_payloads.get(req.request_id)
            if ent is not None and ent[0] is None:
                self._begin_async_restore(req)
                continue
            self._admit(req, self._acquire_slot(req))
        if sid:
            rec.end(sid)
        if not sch.running:
            return 0
        sid = rec.begin("engine.plan") if rec.on else 0
        decode_reqs, grants = sch.plan_step()
        if sid:
            rec.end(sid)
        prefill_tokens = 0
        for req, n in grants:
            sid = rec.begin("engine.prefill", req.request_id) if rec.on else 0
            done = self._run_prefill_chunks(req, n)
            if sid:
                rec.end(sid, done)
            prefill_tokens += done
        self.last_step_prefill_tokens = prefill_tokens
        self.max_step_prefill_tokens = max(self.max_step_prefill_tokens,
                                           prefill_tokens)
        self.prefill_tokens_total += prefill_tokens
        produced = 0
        if decode_reqs:
            sid = rec.begin("engine.decode") if rec.on else 0
            produced = (self._decode_fused(decode_reqs) if self.fused
                        else self._decode_unfused(decode_reqs))
            if sid:
                rec.end(sid, len(decode_reqs))
            sid = rec.begin("engine.finish") if rec.on else 0
            for req in decode_reqs:
                if (req.finished()
                        or req.total_len >= self.ecfg.max_len - 1):
                    self.manager.release_sequence(
                        req.block_ids, retain=req.retain_blocks)
                    sch.finish(req)
                    self.kv.release(req.slot)
            if sid:
                rec.end(sid)
        if self.paged:
            # unpin pages of blocks the manager demoted or dropped
            sid = rec.begin("engine.gc") if rec.on else 0
            self.kv.gc_blocks(self.manager)
            if sid:
                rec.end(sid)
        sid = rec.begin("cache.tick") if rec.on else 0
        self.manager.tick()
        self.manager.age_all()
        if sid:
            rec.end(sid)
        self.steps += 1
        return produced

    def preempt(self, req: Request) -> None:
        """Demote a running request's KV into the tier hierarchy —
        asynchronously when the transfer worker is on."""
        if req.phase is Phase.PREFILL and req.prefill_pos <= 0:
            req.prefill_tokens, req.prefill_pos = None, 0
            req.seg_spans = []
            self.kv.release(req.slot)
            self.scheduler.preempt(req)
            return
        if req.seg_spans and req.prefill_left > 0:
            # the demoted payload covers [0, frontier) only
            bt = self.manager.block_tokens
            req.seg_spans = [sp for sp in req.seg_spans
                             if (sp[0] + sp[1]) * bt <= req.prefill_pos]
        payload, length = self.kv.evict_slot_to_payload(req.slot)
        self._preempted_payloads[req.request_id] = [payload, length]
        bid = f"preempt-{req.request_id}"
        self._drop_tier_copy(req.request_id)
        if self.worker is not None:
            ticket = self.worker.submit(TransferRequest(
                bid, 0, 1, kind="demote", payload=payload,
                nbytes=float(payload.nbytes), tag=str(req.request_id)))
            self._demote_tickets[req.request_id] = ticket
        else:
            self.manager.hierarchy[1].write(bid, payload,
                                            nbytes=float(payload.nbytes))
        self.kv.release(req.slot)
        self.scheduler.preempt(req)

    # ------------------------------------------------------------------
    def run(self, max_steps: int = 10_000) -> dict:
        while self.scheduler.has_work() and self.steps < max_steps:
            produced = self.step()
            if (produced == 0 and not self.scheduler.running
                    and self.scheduler.blocked):
                self.idle_transfer_waits += 1
                time.sleep(1e-3)       # idle: only fetches in flight
        return self.stats()

    def stats(self) -> dict:
        out = {"scheduler": self.scheduler.stats(),
               "cache": self.manager.metrics(),
               "kernel_backend": self.kernel_backend,
               "device": str(self.device),
               "steps": self.steps,
               "idle_transfer_waits": self.idle_transfer_waits,
               "paged": self.paged,
               "chunked": self.chunked,
               "fused": self.fused,
               "prefill_chunks": self.prefill_chunks,
               "prefill_tokens": self.prefill_tokens_total,
               "monolithic_prefills": self.monolithic_prefills,
               "max_step_prefill_tokens": self.max_step_prefill_tokens,
               "cow_share_hits": self.cow_share_hits,
               "inject_hits": self.inject_hits,
               "shared_fetch_hits": self.shared_fetch_hits,
               "segment_reuse": self.seg_enabled,
               "segment_share_hits": self.segment_share_hits,
               "segment_inject_hits": self.segment_inject_hits,
               "segment_chunks": self.segment_chunks}
        if self.paged:
            out["allocator"] = self.kv.allocator.stats_dict()
            out["decode_state_reuses"] = self.kv.state_reuses
            out["decode_state_rebuilds"] = self.kv.state_rebuilds
        if self.worker is not None:
            out["async_transfers"] = self.worker.stats()
        out["faults"] = self.manager.hierarchy.fault_stats()
        return out

    def cancel_request(self, req: Request) -> bool:
        """Drop one live request from every scheduler queue and release
        its slot's pages, its dedup refs and its staged preempt payload
        (the front-end's drain-deadline shed path).  False when the
        request is not live on this engine."""
        sch = self.scheduler
        rid = req.request_id
        if rid in sch.running:
            sch.running.pop(rid)
            if req.slot is not None and req.slot >= 0:
                self.kv.release(req.slot)
        elif rid in sch.blocked:
            sch.blocked.pop(rid)
        elif req in sch.waiting:
            sch.waiting.remove(req)
        elif req in sch.preempted:
            sch.preempted.remove(req)
        else:
            return False
        self.manager.release_sequence(req.block_ids,
                                      retain=req.retain_blocks)
        self._preempted_payloads.pop(rid, None)
        self._demote_tickets.pop(rid, None)
        self._slot_waits.pop(rid, None)
        self._drop_tier_copy(rid)
        req.phase = Phase.DONE
        if self.paged:
            self.kv.gc_blocks(self.manager)
        return True

    def shutdown(self) -> None:
        if self.worker is not None:
            self.worker.drain(timeout=5.0, escalate=True)
            self.worker.close()
            self.worker = None

    def release_resources(self) -> None:
        """Failover teardown: close the transfer worker, release the
        cache manager's block and tier registrations (its
        ``ManagerStats`` survive for the fleet rollup) and drop the KV
        pool from the device.  The weights stay: replicas may share
        them."""
        self.shutdown()
        self._preempted_payloads.clear()
        self._demote_tickets.clear()
        self._inflight_prefetch.clear()
        self._slot_waits.clear()
        self.manager.release_all()
        self.kv.release_storage()
