"""The predictive multi-tier KV cache manager — the paper's contribution
wired together (Fig. 1).

Orchestrates:
  * architecture-variant-aware sizing          (core/sizing.py,   §III-A)
  * the six-tier hierarchy                     (core/tiers.py,    §III-B)
  * Bayesian reuse prediction                  (core/bayesian.py, §III-C)
  * head-granular EMA eviction                 (core/eviction.py, §III-D)
  * RoPE-aware prefetching                     (core/prefetch.py, §III-E)
  * content-addressable dedup + radix tree     (core/dedup.py,    §III-F)
  * agentic task-transition prediction         (core/agentic.py,  §III-G)

The manager is model-compute-agnostic: it tracks block *metadata* and tier
residency, so the same object drives both the live serving engine
(serving/engine.py, payload = real KV arrays) and the trace-replay
evaluation (traces/replay.py, metadata only) — matching the paper's §V
methodology.
"""
from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.config import ModelConfig
from repro_torch.core import sizing
from repro_torch.core.agentic import MarkovToolPredictor, SessionFeatures, classify_session
from repro_torch.core.bayesian import BayesianReusePredictor
from repro_torch.core.dedup import (ContentStore, RadixTree, SegmentIndex,
                              SegmentMatch, content_hash)
from repro_torch.core.eviction import (BayesianPolicy, BlockMeta, EMAPolicy,
                                 EvictionPolicy, HeadImportanceTracker,
                                 LRUPolicy)
from repro_torch.core.faults import (FaultInjector, HealthConfig, RetryPolicy,
                               TierIOError)
from repro_torch.core.policy import PlacementPolicy
from repro_torch.core.prefetch import RoPEPrefetcher
from repro_torch.core.tiers import (PAPER_TIER_SPECS, CapacityError, FleetKVStore,
                              SharedTierView, TierHierarchy, TierSpec)


@dataclass
class AccessResult:
    block_id: str
    hit: bool                    # resident in the hot set (tiers 0-1)?
    tier: Optional[int]          # tier found in (None = cold miss)
    fetch_time: float            # modelled transfer seconds (0 for t0 hit)
    recomputed: bool = False


@dataclass
class ManagerStats:
    accesses: int = 0
    hot_hits: int = 0            # tier 0+1 (paper Table V definition)
    hot_hits_t0: int = 0         # ... served straight from the tier-0 pool
    hot_hits_t1: int = 0         # ... resident in tier 1 (DRAM payload copy)
    tier_hits: Dict[int, int] = field(default_factory=dict)
    cold_misses: int = 0
    promotions: int = 0
    demotions: int = 0
    prefetch_issued: int = 0
    dedup_hits: int = 0
    reregistrations: int = 0     # known content re-registered after a drop
    #                              (a cold miss the radix path cannot see)
    shared_tier_hits: int = 0    # blocks imported from the fleet-shared
    #                              tier (content another replica published)
    shared_publishes: int = 0    # blocks this replica published fleet-wide
    segment_lookups: int = 0     # match_segments calls (one scan per admit)
    segment_hits: int = 0        # live blocks matched past a divergence
    segment_lookup_time: float = 0.0   # wall seconds spent in segment scans
    fetch_time: float = 0.0
    recompute_time: float = 0.0
    # fault tolerance (core/faults.py): all zero without an injector
    retries: int = 0             # transient tier I/O errors absorbed
    io_errors: int = 0           # ops that exhausted the retry budget
    integrity_failures: int = 0  # corrupt payloads caught by checksum
    fetch_recomputes: int = 0    # fetches degraded to recompute
    tier_health: Dict[int, str] = field(default_factory=dict)

    @property
    def hit_rate(self) -> float:
        return self.hot_hits / self.accesses if self.accesses else 0.0

    @property
    def replay_hit_rate(self) -> float:
        """Table-V hit rate with dropped-then-reregistered blocks counted
        as cold misses (the live engine never issues a lookup for them —
        the radix prefix is gone — so plain ``hit_rate`` overstates)."""
        denom = self.accesses + self.reregistrations
        return self.hot_hits / denom if denom else 0.0


class PredictiveCacheManager:
    """Paper Fig. 1: the unified system."""

    def __init__(self, cfg: ModelConfig, *,
                 specs: Sequence[TierSpec] = PAPER_TIER_SPECS,
                 policy: str = "bayesian",
                 enable_dedup: bool = True,
                 enable_prefetch: bool = True,
                 enable_head_eviction: bool = True,
                 enable_multi_tier: bool = True,
                 hot_tiers: Tuple[int, ...] = (0, 1),
                 backing_root: Optional[str] = None,
                 fault_injector: Optional[FaultInjector] = None,
                 retry_policy: Optional[RetryPolicy] = None,
                 health_config: Optional[HealthConfig] = None):
        self.cfg = cfg
        self.block_tokens = sizing.block_tokens(cfg)
        self.block_bytes = sizing.block_bytes(cfg)
        self.hierarchy = TierHierarchy(
            specs if enable_multi_tier else specs[:2],
            backing_root=backing_root,
            fault_injector=fault_injector,
            retry_policy=retry_policy,
            health_config=health_config)
        self.predictor = BayesianReusePredictor()
        self.head_tracker = (HeadImportanceTracker(cfg)
                             if enable_head_eviction else None)
        self.policy_name = policy
        if policy == "lru":
            self.evictor: EvictionPolicy = LRUPolicy()
        elif policy == "ema":
            self.evictor = EMAPolicy()
        else:
            self.evictor = BayesianPolicy(self.head_tracker)
        self.placement = PlacementPolicy(self.hierarchy)
        self.store = ContentStore() if enable_dedup else None
        self.radix = RadixTree(self.block_tokens)
        self.segments = SegmentIndex(self.block_tokens, salt=cfg.name)
        self.prefetcher = (RoPEPrefetcher(self.block_tokens, cfg.n_layers)
                           if enable_prefetch else None)
        self.agentic = MarkovToolPredictor()
        self.hot_tiers = hot_tiers
        self.metas: Dict[str, BlockMeta] = {}
        self.stats = ManagerStats()
        self._clock = 0.0
        self._ids = itertools.count()
        self._lock = threading.RLock()
        self._payloads: Dict[str, np.ndarray] = {}
        # fleet-shared tier 4 (bound post-construction by the cluster)
        self._fleet: Optional[FleetKVStore] = None
        self._fleet_owner = ""
        self._fleet_view: Optional[SharedTierView] = None

    # ------------------------------------------------------------------
    # fleet-shared tier binding (cluster-owned tier-4 namespace)
    # ------------------------------------------------------------------
    @property
    def fleet_bound(self) -> bool:
        return self._fleet is not None

    def bind_fleet_store(self, store: FleetKVStore, owner: str) -> bool:
        """Swap this hierarchy's tier 4 for a ``SharedTierView`` over the
        cluster's fleet store.  Must happen before traffic — blocks
        already resident in the private tier 4 do not migrate.  Returns
        False when the hierarchy has no tier 4 (reduced hierarchies)."""
        with self._lock:
            for i, t in enumerate(self.hierarchy.tiers):
                if t.spec.tier_id == 4:
                    view = SharedTierView(store, owner,
                                          resolve_key=self._content_key)
                    view.available = t.available
                    view.fault_injector = self.hierarchy.fault_injector
                    if store.tier.fault_injector is None:
                        # shared store inherits the first bound replica's
                        # fault model (crc written at publish time)
                        store.tier.fault_injector = \
                            self.hierarchy.fault_injector
                    self.hierarchy.tiers[i] = view
                    self._fleet, self._fleet_owner = store, owner
                    self._fleet_view = view
                    return True
            return False

    def _content_key(self, block_id: str) -> Optional[str]:
        """Local block id -> fleet content key (None when the content
        hash is unknown, e.g. preempt payload blobs — those fall back to
        an owner-scoped key and never dedup across replicas)."""
        meta = self.metas.get(block_id)
        h = getattr(meta, "content_hash", None) if meta is not None else None
        return f"c:{h}" if h else None

    def publish_block(self, block_id: str) -> bool:
        """Push one registered block into the fleet-shared tier (content
        key + payload), acquiring this owner's reference.  Idempotent
        per block; a no-op without a bound fleet store."""
        view = self._fleet_view
        if view is None or not view.available:
            return False
        with self._lock:
            meta = self.metas.get(block_id)
            if meta is None:
                return False
            try:
                new_mapping = block_id not in view._map
                self.hierarchy.run_io(
                    view.spec.tier_id,
                    lambda: view.write(block_id,
                                       self._payloads.get(block_id),
                                       nbytes=meta.nbytes))
            except CapacityError:
                return False           # fleet pool full of live refs
            except TierIOError:
                return False           # fabric sick: publish skipped
            if new_mapping:
                self.stats.shared_publishes += 1
            return True

    def import_shared_block(self, tokens: Sequence[int], *,
                            block_type: str = "user_context",
                            recompute_cost: float = 0.05,
                            positions: Tuple[int, int] = (0, 0)
                            ) -> Optional[Tuple[str, np.ndarray]]:
        """Probe the fleet-shared tier for a block of identical content
        published by ANOTHER replica.  On hit: fetch the payload, charge
        a tier-4 demand fetch (the replay stall model prices it from the
        ``tier_hits`` delta, same as a local lower-tier hit), register
        the block locally and publish this owner's reference.  Returns
        (block_id, payload), or None when the content is locally known
        already (not a cross-replica import) or not in the fleet."""
        if self._fleet is None:
            return None
        with self._lock:
            h = content_hash(tokens, salt=self.cfg.name)
            if self.store is not None:
                canonical = self.store.lookup(h)
                if canonical is not None and canonical in self.metas:
                    return None        # local content: not an import
            key = f"c:{h}"
            if not self._fleet.has_payload(key):
                return None
            tid = self._fleet.tier.spec.tier_id
            try:
                payload, _ = self.hierarchy.run_io(
                    tid, lambda: self._fleet.fetch(key))
            except TierIOError:
                # exhausted retries or corrupt shared copy: the caller
                # recomputes the block instead of importing garbage
                self.stats.fetch_recomputes += 1
                return None
            if payload is None:
                return None
            self.stats.shared_tier_hits += 1
            self.stats.tier_hits[tid] = self.stats.tier_hits.get(tid, 0) + 1
            self.stats.fetch_time += \
                self._fleet.tier.spec.transfer_time(self.block_bytes)
            # a fleet fetch is NOT a local recompute: keep the
            # reregistration counter (replay's cold-miss proxy) flat
            rereg = self.stats.reregistrations
            bid, _ = self.register_block(
                tokens, block_type=block_type, payload=payload,
                recompute_cost=recompute_cost, positions=positions)
            self.stats.reregistrations = rereg
            self.publish_block(bid)
            return bid, payload

    def adopt_sequence(self, tokens: Sequence[int],
                       payloads: Sequence[Optional[np.ndarray]], *,
                       block_type: str = "user_context") -> List[str]:
        """Scale-out warm-up: register a remapped session's prefix blocks
        (payloads pushed from the previous owner) and index the prefix,
        so the joining replica's first turn hits hot instead of
        re-prefilling."""
        bt = self.block_tokens
        ids: List[str] = []
        n = (len(tokens) // bt) * bt
        with self._lock:
            for j, i in enumerate(range(0, n, bt)):
                pl = payloads[j] if j < len(payloads) else None
                bid, _ = self.register_block(
                    list(tokens[i:i + bt]), block_type=block_type,
                    payload=pl, positions=(i, i + bt))
                if pl is not None and bid not in self._payloads:
                    self._payloads[bid] = pl
                ids.append(bid)
            if ids:
                self.radix.insert(list(tokens[:n]), ids)
        return ids

    # ------------------------------------------------------------------
    # time base (trace replay advances a virtual clock)
    # ------------------------------------------------------------------
    def tick(self, dt: float = 1.0) -> float:
        self._clock += dt
        self.hierarchy.tick(dt)      # drives health probes under faults
        if self.hierarchy.fault_injector is not None:
            self.sync_fault_stats()
        return self._clock

    def sync_fault_stats(self) -> None:
        """Copy the hierarchy's fault-tolerance counters into
        ``ManagerStats`` (absolute values, idempotent) so replay results
        and fleet aggregation see them without reaching into the
        hierarchy."""
        c = self.hierarchy.counters
        self.stats.retries = c.retries
        self.stats.io_errors = c.io_errors
        self.stats.integrity_failures = c.integrity_failures
        self.stats.tier_health = self.hierarchy.health.as_dict()

    @property
    def now(self) -> float:
        return self._clock

    # ------------------------------------------------------------------
    # block registration (prefill path)
    # ------------------------------------------------------------------
    def _new_block_id(self) -> str:
        return f"blk{next(self._ids)}"

    def register_block(self, tokens: Sequence[int], *,
                       block_type: str = "user_context",
                       payload: Optional[np.ndarray] = None,
                       recompute_cost: float = 0.05,
                       positions: Tuple[int, int] = (0, 0)) -> Tuple[str, bool]:
        """Allocate (or dedup) one KV block; returns (block_id, was_dedup).

        Dedup (§III-F): identical content -> refcount bump, no new bytes.
        """
        with self._lock:
            h = content_hash(tokens, salt=self.cfg.name)
            if self.store is not None:
                canonical, dup = self.store.intern(h, self._new_block_id())
                if dup and canonical in self.metas:
                    self.stats.dedup_hits += 1
                    return canonical, True
                if dup:
                    # content seen before but its block was evicted from
                    # every tier: the caller recomputes — a cold miss
                    self.stats.reregistrations += 1
                bid = canonical
            else:
                bid = self._new_block_id()
            meta = BlockMeta(block_id=bid, nbytes=self.block_bytes,
                             block_type=block_type, last_access=self._clock,
                             access_count=1, recompute_cost=recompute_cost,
                             positions=positions)
            meta.content_hash = h          # type: ignore[attr-defined]
            meta.reuse_prob = self.predictor.reuse_probability(
                block_type, "reasoning_step")
            self.metas[bid] = meta
            if payload is not None:
                self._payloads[bid] = payload
            if len(tokens) == self.block_tokens:
                # position-independent content key: a later prompt can
                # resume on this block after a divergent span
                self.segments.insert_block(tokens, bid, digest=h)
            self._admit(meta, payload)
            return bid, False

    def register_sequence(self, tokens: Sequence[int], *,
                          block_type: str = "user_context",
                          block_types: Optional[Sequence[str]] = None,
                          recompute_cost_per_block: float = 0.05) -> List[str]:
        """Split a token sequence into blocks, dedup each, register the
        prefix in the radix tree, return the block ids.  ``block_types``
        optionally gives a per-block semantic type (index = block number;
        a multi-turn prompt mixes system/context/input blocks, and the
        Bayesian posteriors are keyed on the type)."""
        bt = self.block_tokens
        ids: List[str] = []
        n = (len(tokens) // bt) * bt
        for i in range(0, n, bt):
            btype = block_type
            if block_types is not None and i // bt < len(block_types):
                btype = block_types[i // bt]
            bid, _ = self.register_block(
                tokens[i:i + bt], block_type=btype,
                recompute_cost=recompute_cost_per_block,
                positions=(i, i + bt))
            ids.append(bid)
        if ids:
            self.radix.insert(tokens[:n], ids)
        return ids

    def match_prefix(self, tokens: Sequence[int]) -> List[str]:
        """Radix longest-prefix match -> reusable block ids (skipped
        prefill compute for the caller)."""
        return [bid for bid in self.radix.match(tokens) if bid in self.metas]

    def peek_prefix_blocks(self, tokens: Sequence[int]) -> int:
        """Number of live radix-matched prefix blocks, WITHOUT bumping
        hit counters — the prefix-aware router probes every replica per
        routed request, and probing must not skew the hotness signal."""
        depth = 0
        for bid in self.radix.probe(tokens):
            if bid not in self.metas:
                break
            depth += 1
        return depth

    def match_segments(self, tokens: Sequence[int],
                       start_block: int = 0) -> List[SegmentMatch]:
        """Content-segment matches past a radix divergence: maximal runs
        of live registered blocks among the full blocks of ``tokens``
        from block index ``start_block``.  The scan cost is metered into
        ``stats.segment_lookup_time`` so the benchmark can price lookup
        overhead against the reuse it recovers."""
        t0 = time.perf_counter()
        raw = self.segments.match(tokens, start_block=start_block)
        out: List[SegmentMatch] = []
        with self._lock:
            for seg in raw:
                # split runs at blocks dropped from every tier since
                # they were indexed (meta gone -> nothing to resume on)
                s, ids = seg.start_block, []
                for j, bid in enumerate(seg.block_ids):
                    if bid in self.metas:
                        if not ids:
                            s = seg.start_block + j
                        ids.append(bid)
                    else:
                        if len(ids) >= self.segments.min_blocks:
                            out.append(SegmentMatch(s, ids))
                        ids = []
                if len(ids) >= self.segments.min_blocks:
                    out.append(SegmentMatch(s, ids))
            self.stats.segment_lookups += 1
            self.stats.segment_hits += sum(m.n_blocks for m in out)
            self.stats.segment_lookup_time += time.perf_counter() - t0
        return out

    # ------------------------------------------------------------------
    # admission & eviction
    # ------------------------------------------------------------------
    def _admit(self, meta: BlockMeta, payload: Optional[np.ndarray],
               tier_id: int = 0) -> None:
        self._make_room(tier_id, meta.nbytes)
        try:
            self.hierarchy.write_tier(tier_id, meta.block_id, payload,
                                      nbytes=meta.nbytes)
        except (CapacityError, TierIOError):
            # tier saturated with unevictable blocks (or sick despite
            # retries) -> place lower; skip tiers that fail too
            for t in self.hierarchy.active_tiers():
                if t.spec.tier_id > tier_id and t.free >= meta.nbytes:
                    try:
                        self.hierarchy.write_tier(
                            t.spec.tier_id, meta.block_id, payload,
                            nbytes=meta.nbytes)
                        return
                    except (CapacityError, TierIOError):
                        continue

    def _make_room(self, tier_id: int, nbytes: float,
                   _depth: int = 0) -> None:
        """Recursive demotion cascade: tier t's victims demote INTO tier
        t+1, which first makes room by pushing its own victims further
        down.  Without the cascade a full lower tier freezes forever and
        the hierarchy degenerates to a single hot tier.  Victim selection
        is batched (one policy scan frees several blocks) so replay stays
        O(accesses)."""
        if _depth >= self.hierarchy.n_tiers:
            return
        tier = self.hierarchy[tier_id]
        if not tier.available or tier.free >= nbytes:
            return
        need = int((nbytes - tier.free) // max(1.0, self.block_bytes)) + 2
        metas = [self.metas[b] for b in tier.blocks() if b in self.metas]
        victims = self.evictor.select_victims(metas, self._clock, need)
        nxt = None
        for t in self.hierarchy.tiers[tier_id + 1:]:
            if t.available:
                nxt = t.spec.tier_id
                break
        hot_exit = (tier_id in self.hot_tiers
                    and (nxt is None or nxt not in self.hot_tiers))
        for victim in victims:
            if hot_exit:
                self._observe_drop(victim)
            if nxt is None:
                self._drop_block(victim.block_id)
            else:
                self._make_room(nxt, victim.nbytes, _depth + 1)
                try:
                    self.hierarchy.move(victim.block_id, tier_id, nxt)
                    self.stats.demotions += 1
                except (CapacityError, TierIOError):
                    # destination full, or demotion I/O exhausted its
                    # retries — the victim was leaving anyway: drop it
                    self._drop_block(victim.block_id)

    def _drop_block(self, block_id: str) -> None:
        """Fully unregister one block: evicted from EVERY tier (a block
        published to the fleet-shared tier 4 is dual-resident, and an
        evict of only its fastest copy would strand the shared-tier
        reference), plus radix/payload/meta teardown."""
        for t in self.hierarchy.tiers:
            t.evict(block_id)
        self.radix.remove_block(block_id)
        self.segments.remove_block(block_id)
        self._payloads.pop(block_id, None)
        self.metas.pop(block_id, None)

    def _evict_one(self, tier_id: int) -> bool:
        free_before = self.hierarchy[tier_id].free
        self._make_room(tier_id, free_before + self.block_bytes)
        return self.hierarchy[tier_id].free > free_before

    def _observe_drop(self, meta: BlockMeta) -> None:
        """Bayesian miss signal: a block leaving the hot set that was
        never re-looked-up since registration counts one miss for its
        (type, transition) pair (observed once per block)."""
        if meta.access_count <= 1 and \
                not getattr(meta, "miss_observed", False):
            self.predictor.observe(meta.block_type, "reasoning_step", False)
            meta.miss_observed = True          # type: ignore[attr-defined]

    def _next_tier(self, tier_id: int, nbytes: float) -> Optional[int]:
        for t in self.hierarchy.tiers[tier_id + 1:]:
            if t.available and t.free >= nbytes:
                return t.spec.tier_id
        return None

    # ------------------------------------------------------------------
    # the access path (decode / lookup)
    # ------------------------------------------------------------------
    def access(self, block_id: str, *, transition: str = "reasoning_step",
               update_predictor: bool = True) -> AccessResult:
        """One cache lookup.  Hit definition follows the paper's Table V:
        resident in tiers 0-1.  Lower-tier residency counts as a miss but
        costs a (modelled) fetch instead of a full recompute."""
        with self._lock:
            self.stats.accesses += 1
            meta = self.metas.get(block_id)
            loc = self.hierarchy.locate(block_id)
            hit = loc is not None and loc in self.hot_tiers
            fetch_time = 0.0
            recomputed = False
            if meta is None:
                # unknown block: cold path, caller recomputes
                self.stats.cold_misses += 1
                return AccessResult(block_id, False, None, 0.0, True)
            if update_predictor:
                # a re-lookup IS a reuse event for this (type, transition)
                # pair, regardless of which tier currently holds the block
                self.predictor.observe(meta.block_type, transition, True)
                meta.miss_observed = True      # type: ignore[attr-defined]
            meta.reuse_prob = self.predictor.reuse_probability(
                meta.block_type, transition)
            meta.last_access = self._clock
            meta.access_count += 1
            if isinstance(self.evictor, EMAPolicy):
                self.evictor.touch(meta)
            if loc is None:
                # dropped entirely -> recompute
                self.stats.cold_misses += 1
                self.stats.recompute_time += meta.recompute_cost
                recomputed = True
                self._admit(meta, self._payloads.get(block_id))
            elif not hit:
                try:
                    # promote into the hot set
                    self._promote(block_id, loc, 0)
                except TierIOError:
                    # exhausted retries or a corrupt copy: the fetch
                    # degrades to a recompute — evict the suspect copy,
                    # count a miss, and rebuild into the hot set so the
                    # caller re-prefills instead of hanging or decoding
                    # garbage
                    self.hierarchy[loc].evict(block_id)
                    self.stats.fetch_recomputes += 1
                    self.stats.cold_misses += 1
                    self.stats.recompute_time += meta.recompute_cost
                    recomputed = True
                    loc = None
                    self._admit(meta, self._payloads.get(block_id))
                else:
                    self.stats.tier_hits[loc] = \
                        self.stats.tier_hits.get(loc, 0) + 1
                    fetch_time = \
                        self.hierarchy[loc].spec.transfer_time(meta.nbytes)
                    self.stats.fetch_time += fetch_time
            else:
                self.stats.hot_hits += 1
                if loc == 0:
                    self.stats.hot_hits_t0 += 1
                else:
                    self.stats.hot_hits_t1 += 1
                self.stats.tier_hits[loc] = self.stats.tier_hits.get(loc, 0) + 1
            return AccessResult(block_id, hit, loc, fetch_time, recomputed)

    def _promote(self, block_id: str, src: int, dst: int) -> None:
        meta = self.metas[block_id]
        tier = self.hierarchy[dst]
        while tier.free < meta.nbytes:
            if not self._evict_one(dst):
                return
        self.hierarchy.move(block_id, src, dst)
        self.stats.promotions += 1

    # ------------------------------------------------------------------
    # prefetch + agentic hooks
    # ------------------------------------------------------------------
    def prefetch_for_position(self, seq_blocks: Sequence[str],
                              position: int) -> int:
        if self.prefetcher is None:
            return 0
        reqs = self.prefetcher.plan(
            seq_blocks, position,
            resident=lambda b: (self.hierarchy.locate(b) in self.hot_tiers))
        for r in reqs:
            loc = self.hierarchy.locate(r.block_id)
            if loc is not None and loc not in self.hot_tiers:
                self._promote(r.block_id, loc, 0)
        self.stats.prefetch_issued += len(reqs)
        return len(reqs)

    def plan_prefetch(self, seq_blocks: Sequence[str],
                      position: int) -> List[Tuple[str, int]]:
        """RoPE-window prefetch candidates as (block_id, src_tier).

        The async serving path hands these to the tier transfer worker
        instead of promoting inline; ``prefetch_for_position`` remains
        the synchronous fallback."""
        if self.prefetcher is None:
            return []
        with self._lock:
            reqs = self.prefetcher.plan(
                seq_blocks, position,
                resident=lambda b: (self.hierarchy.locate(b)
                                    in self.hot_tiers))
            out: List[Tuple[str, int]] = []
            for r in reqs:
                loc = self.hierarchy.locate(r.block_id)
                if loc is not None and loc not in self.hot_tiers:
                    out.append((r.block_id, loc))
            self.stats.prefetch_issued += len(reqs)
            return out

    def plan_prefetch_many(self, items: Sequence[Tuple[Sequence[str], int]]
                           ) -> List[Tuple[str, int]]:
        """Batched ``plan_prefetch``: plan every decoding request's
        RoPE-window prefetch under ONE lock acquisition (the fused step
        loop plans once per step, not once per request).  Candidate
        order matches the sequential per-request calls."""
        if self.prefetcher is None or not items:
            return []
        with self._lock:
            out: List[Tuple[str, int]] = []
            resident = (lambda b: (self.hierarchy.locate(b)
                                   in self.hot_tiers))
            for seq_blocks, position in items:
                reqs = self.prefetcher.plan(seq_blocks, position,
                                            resident=resident)
                for r in reqs:
                    loc = self.hierarchy.locate(r.block_id)
                    if loc is not None and loc not in self.hot_tiers:
                        out.append((r.block_id, loc))
                self.stats.prefetch_issued += len(reqs)
            return out

    def promote_async(self, block_id: str, src: int) -> float:
        """Executed on the transfer worker thread: promote into tier 0
        under the manager lock (metas + hierarchy stay consistent).
        Returns the modelled fetch time, 0.0 if the block already moved."""
        with self._lock:
            loc = self.hierarchy.locate(block_id)
            meta = self.metas.get(block_id)
            if loc is None or loc in self.hot_tiers or meta is None:
                return 0.0
            t = self.hierarchy[loc].spec.transfer_time(meta.nbytes)
            self._promote(block_id, loc, 0)
            return t

    def on_tool_switch(self, prev_tool: Optional[str], tool: str,
                       kv_bytes: float = 0.0) -> str:
        """§III-G: record the transition, return its transition type."""
        self.agentic.observe_transition(prev_tool, tool, kv_bytes)
        ttype = self.agentic.transition_type(prev_tool, tool)
        if self.head_tracker is not None and ttype in ("tool_switch",
                                                       "agent_handoff"):
            # bias eviction away from heads serving the outgoing task
            self.head_tracker.set_transition_multipliers(
                np.full(self.head_tracker.matrix.shape[1], 0.8))
        return ttype

    # ------------------------------------------------------------------
    def release_sequence(self, block_ids: Sequence[str], *,
                         retain: bool = False) -> None:
        """Drop refcounts when a request completes; free blocks that hit 0
        AND have low predicted reuse (others linger for cross-request
        reuse — that is the whole point of the paper).

        ``retain=True`` (session continuation: the next turn resubmits
        this prefix) balances the request's dedup reference without ever
        dropping the last one, so the blocks stay registered and
        matchable.  The first retained release of a block leaves one
        standing reference for the session chain; tier eviction ignores
        refcounts, so residency stays capacity-bounded either way."""
        for bid in block_ids:
            meta = self.metas.get(bid)
            if meta is None:
                continue
            if self.store is not None:
                h = getattr(meta, "content_hash", None)
                if h is not None:
                    if retain:
                        if self.store.refcount(bid) > 1:
                            self.store.release(h)
                        continue
                    freed = self.store.release(h)
                    if freed is None:
                        continue     # other references remain
            if retain:
                continue
            if meta.reuse_prob < 0.2:
                self._drop_block(bid)

    def release_all(self) -> None:
        """Drop every block registration and tier-resident copy (replica
        failover teardown): payloads, tier residency, block metadata,
        the radix prefix index and the dedup store are all cleared so
        nothing keeps the dead replica's KV alive.  With a bound fleet
        store, evicting the shared-tier view releases every one of THIS
        owner's fleet references — bytes other replicas still reference
        stay resident (the cross-replica refcount invariant).
        ``self.stats`` is deliberately retained — the cluster aggregates
        it after the replica is gone."""
        with self._lock:
            for tier in self.hierarchy.tiers:
                for bid in tier.blocks():
                    tier.evict(bid)
            self.metas.clear()
            self._payloads.clear()
            self.radix = RadixTree(self.block_tokens)
            self.segments = SegmentIndex(self.block_tokens,
                                         salt=self.cfg.name)
            if self.store is not None:
                self.store = ContentStore()

    def age_all(self) -> None:
        if isinstance(self.evictor, EMAPolicy):
            for m in self.metas.values():
                self.evictor.age(m)

    # ------------------------------------------------------------------
    def metrics(self) -> dict:
        """Prometheus-style metrics (paper §IV Observability)."""
        self.sync_fault_stats()
        return {
            "hit_rate_hot": self.stats.hit_rate,
            "hit_rate_replay": self.stats.replay_hit_rate,
            "accesses": self.stats.accesses,
            "hot_hits_t0": self.stats.hot_hits_t0,
            "hot_hits_t1": self.stats.hot_hits_t1,
            "reregistrations": self.stats.reregistrations,
            "promotions": self.stats.promotions,
            "demotions": self.stats.demotions,
            "cold_misses": self.stats.cold_misses,
            "shared_tier_hits": self.stats.shared_tier_hits,
            "shared_publishes": self.stats.shared_publishes,
            "segment_lookups": self.stats.segment_lookups,
            "segment_hits": self.stats.segment_hits,
            "segment_lookup_time": self.stats.segment_lookup_time,
            "retries": self.stats.retries,
            "io_errors": self.stats.io_errors,
            "integrity_failures": self.stats.integrity_failures,
            "fetch_recomputes": self.stats.fetch_recomputes,
            "tier_health": dict(self.stats.tier_health),
            "faults": self.hierarchy.fault_stats(),
            "segment_index": self.segments.stats(),
            "fleet": self._fleet.stats() if self._fleet else {},
            "dedup": self.store.stats() if self.store else {},
            "tiers": self.hierarchy.stats(),
            "predictor": self.predictor.snapshot(),
            "cost_dollars": self.hierarchy.total_cost_dollars(),
        }
