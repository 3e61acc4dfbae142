"""Trace→engine serving replay: the paper's §V-E evaluation driven
through the real ``ServingEngine`` — single-engine or multi-replica —
instead of the standalone cache manager.

``traces/replay.py`` replays block-access traces against the
``PredictiveCacheManager`` alone — scheduling, paged-pool CoW sharing,
chunked prefill and tier-transfer latency never enter the picture.  This
adapter closes that gap: it converts the same ShareGPT / LMSYS / agentic
session generators (``traces/generators.py``) into **timed multi-turn
request streams** and drives them open-loop against live engines under
a virtual clock:

  * each turn submits the **full conversation prefix** (system prompt +
    input history + new input), so cross-turn and cross-session reuse
    flows through the real radix-match → CoW-page-share / tier-payload
    injection path instead of a metadata lookup;
  * one trace block maps to exactly one engine KV block
    (``ModelConfig.kv_block_tokens`` shrinks the engine block so reduced
    models see trace-scale reuse granularity), keeping the engine's
    hit accounting block-for-block comparable with Table V;
  * sessions arrive open-loop at a fixed virtual interarrival; within a
    session the next turn submits after the previous turn's completion
    plus a think-time gap (closed-loop per conversation, like a real
    chat client);
  * the virtual clock advances per fleet step by a modelled step time:
    a fixed overhead, a per-token compute cost, and the modelled
    tier-fetch / recompute stall for that step (see *Fetch-stall
    model*) — so hit-rate differences between policies surface in
    TTFT/TBT, which is exactly the serving-layer interaction KVDrive
    (arXiv 2605.18071) argues block-level replay cannot capture.

**Multi-replica replay** (``run_cluster_replay``): the same turn
streams route through a ``serving/cluster.py::ReplicaCluster`` — every
busy replica steps once per fleet iteration (replicas run concurrently,
so the clock advances by the *slowest* replica's step time), sessions
route by the configured policy (consistent-hash affinity vs round-robin
vs least-loaded), and mid-replay ``fail_replica`` / ``add_replica``
events measure the failover recomputation tax and elastic-scale-out
remapping.  Hit rates are reported per replica and fleet-wide against
the *global* previously-seen ground truth, so routing that fragments
sessions across replicas shows up directly as a fleet hit-rate drop —
the cross-replica placement effect the KV-cache management survey
(arXiv 2607.02574) calls the deciding factor at scale.

Fetch-stall model: at paper scale a KV block is MBs (the reduced
model's blocks are KBs), so the virtual clock cannot reuse the
manager's reduced-size fetch accounting verbatim.  With
``fetch_stall_model="spec"`` (default) every demand fetch from a
non-hot tier stalls the clock by that tier's
``TierSpec.transfer_time`` evaluated at the **target model's** block
bytes (``target_model``, default llama-3-70b); asynchronous prefetch
promotions are not charged — they overlap compute, which is the
paper's §IV design point.  ``fetch_stall_model="fixed"`` keeps the
previous behaviour: a flat ``fetch_stall_s`` per promotion plus the
reduced-size fetch/recompute accounting.

Tier capacities reuse ``traces/replay.py::replay_tier_specs`` (scaled-
down tiers 0/1 so the reusable working set exceeds the hot set) with
``EngineConfig(tier0_from_budget=False)`` so the pressure capacities
stand.

Hit-rate definition (Table V analogue, measured at the engine):
``engine_hit_rate = hot-hit prompt blocks / previously-seen prompt
blocks``.  The denominator is trace ground truth — a prompt block whose
content appeared in an earlier-submitted turn (first touch excluded,
exactly like ``replay.py``), **fleet-wide**: under multi-replica
routing a block previously seen on replica A but routed to replica B
counts against B's hit rate, because at the serving layer that compute
really is re-paid.  The numerator is the engine's own accounting
(``Request.hot_hit_blocks``): blocks actually served from tiers 0-1.

The port of the JAX package's ``traces/serving_replay.py``.  The device
picks the kernels (CUDA on the card, their plain versions on the CPU),
so the config has no kernel backend; the entry points take ``device``
(the card unless the caller names another) and an optional ``params``
tree, made once from the seed when absent and shared by every replica.
``cfg`` replaces the reduced replay model, e.g. with llama3.2-1b at
full width and 32-token blocks.  The port's engine prices a block's
recompute at the H100 bf16 peak, the JAX engine at the TPU v5e one; the
eviction scores and tier choices see that constant, so the port's hit
rates are its own.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.config import ModelConfig, reduce_config
from repro_torch.core import sizing
from repro_torch.core.faults import FaultInjector, FaultProfile
from repro_torch.models.common import resolve_device
from repro_torch.models.model import build_model
from repro_torch.serving.cluster import ReplicaCluster, make_router
from repro_torch.serving.engine import EngineConfig, ServingEngine
from repro_torch.serving.request import Phase, Request, SamplingParams
from repro_torch.traces.generators import TraceConfig, Turn, workload_sessions
from repro_torch.traces.replay import replay_tier_specs


def replay_model_config(block_tokens: int = 32) -> ModelConfig:
    """Reduced llama3.2-1b with trace-scale KV blocks: one trace block
    (nominally 128 tokens) maps to one ``block_tokens``-token engine
    block, so a full multi-turn prompt stays CPU-sized while the reuse
    structure is preserved block-for-block."""
    from repro_torch.configs import get_config
    cfg = reduce_config(get_config("llama3.2-1b"))
    return dataclasses.replace(cfg, name=cfg.name + "-replay",
                               kv_block_tokens=block_tokens)


# Per-workload tier-0/tier-1 pressure (block counts) for the live-engine
# replay: chosen so the reusable working set (sharegpt 244 / lmsys 110 /
# agentic 168 distinct blocks at 12 sessions, plus the turns' single-use
# output blocks) exceeds the hot set and the eviction policy has
# decisions to make — cf. REPLAY_HOT_BLOCKS for the block-level replay.
# Multi-replica runs keep these capacities PER REPLICA: the fleet's
# aggregate hot capacity grows with n, which is exactly the deployment
# trade the cluster sweep measures (more aggregate cache, colder slices
# under naive routing).
ENGINE_REPLAY_BLOCKS: Dict[str, Tuple[int, int]] = {
    "sharegpt": (48, 72),
    "lmsys": (32, 48),
    "agentic": (64, 96),
}


@dataclass
class ServingReplayConfig:
    workload: str = "agentic"
    policy: str = "bayesian"            # lru | ema | bayesian
    n_sessions: int = 12
    seed: int = 0
    max_turns: int = 6                  # cap turns per session (CPU budget)
    max_new_cap: int = 4                # cap decode tokens per turn
    block_tokens: int = 32              # engine tokens per trace block
    page_tokens: int = 32
    prefill_chunk_tokens: int = 64
    max_step_tokens: int = 160
    n_slots: int = 8                    # target decode concurrency
    hot_blocks: Optional[int] = None    # tier-0 capacity (None: per-workload)
    t1_blocks: Optional[int] = None     # tier-1 capacity (None: per-workload)
    t2_blocks: Optional[int] = None     # cap CXL blocks (None: paper scale;
    #                                     the chaos table caps it to push
    #                                     demotion traffic into NVMe/RDMA)
    t3_blocks: Optional[int] = None     # cap NVMe blocks likewise
    async_transfers: bool = True        # real async worker path; False runs
    #                                     transfers inline — bit-for-bit
    #                                     deterministic (thread completion
    #                                     timing is polled per step, so a
    #                                     prefetch promotion may land a step
    #                                     earlier or later between runs)
    # --- virtual clock model ---------------------------------------------
    session_interarrival_s: float = 0.005
    think_time_s: float = 0.02
    step_overhead_s: float = 1.5e-3
    per_token_s: float = 4e-5
    stall_weight: float = 1.0           # modelled fetch/recompute stall
    fetch_stall_model: str = "spec"     # "spec": per-fetch stall derived
    #                                     from TierSpec.transfer_time at the
    #                                     TARGET model's block bytes, charged
    #                                     per demand fetch from each non-hot
    #                                     tier (async prefetch promotions
    #                                     overlap compute — not charged).
    #                                     "fixed": the earlier flat charge
    #                                     below, kept as an A/B fallback.
    target_model: str = "llama-3-70b"   # paper model whose block bytes set
    #                                     the spec-derived stall
    fetch_stall_s: float = 1e-3         # "fixed" mode: flat stall per
    #                                     promotion (the old constant)
    fused_step: bool = True             # fused jitted decode+sample step
    #                                     closure (False: per-request
    #                                     sampling A/B — greedy replay is
    #                                     token-identical, so hit rates
    #                                     must match either way)
    segment_reuse: bool = True          # content-segment index: resume
    #                                     matching blocks mid-prompt beyond
    #                                     the contiguous radix prefix
    #                                     (False: monolithic-radix A/B)
    # --- fault injection (chaos replay) -----------------------------------
    fault_profiles: Optional[Dict[int, FaultProfile]] = None
    #                                     per-tier chaos profiles; None
    #                                     attaches no injector, and the
    #                                     fault path is fully inert — the
    #                                     replay reproduces the fault-free
    #                                     numbers bit-identically
    fault_seed: int = 0                 # injector RNG seed
    transfer_timeout_s: float = 30.0    # async transfer watchdog (wall s);
    #                                     expired transfers come back as
    #                                     failed events -> recompute
    max_steps: int = 50_000


@dataclass
class ClusterReplayConfig(ServingReplayConfig):
    """Multi-replica replay: ``ServingReplayConfig`` plus fleet shape,
    routing policy and optional mid-replay membership events."""
    n_replicas: int = 2
    routing: str = "affine"             # affine | round_robin |
    #                                     least_loaded | prefix
    ring_salt: str = ""                 # affine: seeds the session→replica
    #                                     assignment without renaming nodes
    fail_replica_after_turns: Optional[int] = None   # fail one replica once
    #                                     this many turns completed fleet-wide
    fail_replica_name: Optional[str] = None          # victim (default: the
    #                                     replica with the most live work)
    add_replica_after_turns: Optional[int] = None    # scale out by one
    #                                     replica at this completion count
    shared_tier: bool = False           # bind every replica's tier 4 to one
    #                                     fleet-shared content-addressed store
    warmup_on_add: bool = False         # push remapped sessions' prefix
    #                                     blocks to a joining replica before
    #                                     it takes traffic


@dataclass
class ServingReplayResult:
    workload: str
    policy: str
    engine_hit_rate: float         # hot (tier 0-1) hits / seen blocks
    reuse_rate: float              # any-tier cache-served / seen blocks
    seen_blocks: int
    manager_hit_rate: float        # PredictiveCacheManager hot-hit rate
    manager_replay_hit_rate: float
    hot_hits_t0: int               # pool (CoW-shareable) hits
    hot_hits_t1: int               # DRAM-resident hits
    cow_share_hits: int            # engine: blocks served by CoW page map
    inject_hits: int               # engine: blocks served by payload inject
    promotions: int
    demotions: int
    requests_done: int
    sessions: int
    generated_tokens: int
    ttft_p50: float                # virtual seconds
    ttft_p95: float
    tbt_p50: float
    tbt_p95: float
    throughput_tok_s: float        # generated tokens / virtual time
    virtual_time_s: float
    steps: int
    wall_s: float
    # segment reuse (zeros when segment_reuse=False)
    segment_hit_blocks: int = 0    # mid-prompt blocks resumed via the
    #                                content-segment index (capped per
    #                                request at the seen ground truth)
    segment_share_hits: int = 0    # engine: resumed by CoW page map
    segment_inject_hits: int = 0   # engine: resumed by payload inject
    segment_lookups: int = 0       # manager: match_segments calls
    segment_lookup_s: float = 0.0  # manager: wall time in those lookups
    # fault injection / robustness (zeros when fault_profiles is None)
    turns_submitted: int = 0       # every dispatched turn; the zero-hung
    #                                invariant is turns_submitted ==
    #                                requests_done
    ttft_p99: float = 0.0          # virtual seconds (chaos-table metric)
    retries: int = 0               # transient errors absorbed by retry
    io_errors: int = 0             # ops that exhausted the retry budget
    integrity_failures: int = 0    # corrupt payloads caught by checksum
    fetch_recomputes: int = 0      # failed fetches converted to recompute
    retry_delay_s: float = 0.0     # modelled backoff charged to the clock
    tier_health: Dict[int, str] = field(default_factory=dict)
    injected: Dict[str, int] = field(default_factory=dict)


@dataclass
class ReplicaReplayStats:
    """One replica's slice of a cluster replay (hit denominators are
    the fleet-wide previously-seen ground truth for the requests that
    COMPLETED on this replica)."""
    name: str
    failed: bool                   # replica was killed mid-replay
    requests_done: int
    seen_blocks: int
    hot_hit_blocks: int
    hit_rate: float                # tier-0/1 hits / seen blocks
    reuse_rate: float              # any-tier served / seen blocks
    manager_hit_rate: float        # the replica manager's own hot-hit rate
    promotions: int
    demotions: int
    shared_hit_blocks: int = 0     # blocks imported from the fleet tier


@dataclass
class ClusterReplayResult:
    workload: str
    policy: str
    routing: str
    n_replicas: int                # replicas that ever served traffic
    fleet_hit_rate: float          # tier-0/1 hits / seen blocks, fleet-wide
    fleet_reuse_rate: float
    seen_blocks: int
    per_replica: List[ReplicaReplayStats]
    redispatched: int              # failover requeues
    reprefill_tokens: int          # prompt+generated tokens whose KV died
    failed_replicas: List[str]
    requests_done: int
    sessions: int
    generated_tokens: int
    ttft_p50: float                # virtual seconds (includes the failover
    ttft_p95: float                # re-prefill tax for redispatched turns)
    tbt_p50: float
    tbt_p95: float
    throughput_tok_s: float
    virtual_time_s: float
    steps: int                     # fleet iterations
    wall_s: float
    # fleet-shared tier 4 (zeros when shared_tier=False)
    shared_tier: bool = False
    shared_hit_blocks: int = 0     # fleet-tier imports across all requests
    shared_hit_rate: float = 0.0   # shared imports / seen blocks
    fleet_hit_rate_incl_shared: float = 0.0  # (hot + shared imports) / seen:
    #                                the fleet-level hit — a shared import is
    #                                a tier-4 fetch, not a re-prefill
    # scale-out warm-up (zeros unless add_replica fired mid-replay)
    joined_replica: str = ""
    postjoin_ttft_p95: float = 0.0  # turns served by the joiner
    steady_ttft_p95: float = 0.0    # turns elsewhere, never redispatched
    warmed_blocks: int = 0
    warmed_sessions: int = 0
    ttft_p99: float = 0.0


@dataclass
class _TurnSpec:
    session_id: str
    prompt: List[int]
    block_types: List[str]
    acct_cids: List[Tuple]         # accountable content ids (full blocks)
    tool: Optional[str]
    max_new: int


@dataclass
class _Tracked:
    req: Request
    session: int
    submit_v: float
    seen_blocks: int
    replica: str = ""
    redispatches: int = 0
    token_times: List[float] = field(default_factory=list)
    done_v: Optional[float] = None


def _materialize(cid: Tuple, bt: int, vocab: int,
                 cache: Dict[Tuple, List[int]]) -> List[int]:
    """Content id -> a deterministic block of ``bt`` tokens.  Identical
    ids yield identical tokens, so the engine's content-hash dedup and
    radix prefix matching see the trace's sharing structure."""
    toks = cache.get(cid)
    if toks is None:
        rng = np.random.default_rng(cid[0])
        toks = [int(t) for t in rng.integers(0, vocab, size=bt)]
        cache[cid] = toks
    return toks


def _turn_spec(turn: Turn, bt: int, vocab: int, max_new_cap: int,
               cache: Dict[Tuple, List[int]]) -> _TurnSpec:
    """One trace turn -> a request spec.

    The prompt is the turn's full conversation prefix (system + history
    + input, in event order) **plus the turn's output blocks** at the
    end: after a real turn, the model's reply occupies KV alongside the
    prompt, and the trace marks those ``intermediate_reasoning`` blocks
    single-use.  Materializing them prompt-side puts the same block
    population in the live pool — single-use scratch that the eviction
    policy must get out of the way of reusable context, which is the
    paper's Problem 3 (recency != reuse; decoding the full reply
    token-by-token on CPU would cost ~bt x more for identical cache
    behaviour).  The next turn's prompt never repeats them, so the radix
    prefix diverges exactly where the trace says it does.  Decode load
    is a capped handful of sampled tokens per turn."""
    prompt: List[int] = []
    btypes: List[str] = []
    cids: List[Tuple] = []
    tool: Optional[str] = None
    out_blocks = 0
    for ev in turn:
        if ev.tool is not None:
            tool = ev.tool
        if ev.block_type == "intermediate_reasoning":
            out_blocks += 1
        prompt.extend(_materialize(ev.content_id, bt, vocab, cache))
        btypes.append(ev.block_type)
        cids.append(ev.content_id)
    # prefill covers prompt[:-1]: the final block stays one token short
    # of full, so it is neither registered nor matchable — exclude it
    # from the hit accounting (it can never be a hit or a miss)
    return _TurnSpec(session_id=turn[0].session, prompt=prompt,
                     block_types=btypes, acct_cids=cids[:-1], tool=tool,
                     max_new=max(1, min(max_new_cap, out_blocks)))


def build_engine(rcfg: ServingReplayConfig, cfg: Optional[ModelConfig] = None,
                 max_len: int = 768, *, device=None,
                 params=None) -> ServingEngine:
    cfg = replay_model_config(rcfg.block_tokens) if cfg is None else cfg
    hot, t1 = ENGINE_REPLAY_BLOCKS.get(rcfg.workload, (64, 96))
    hot = rcfg.hot_blocks if rcfg.hot_blocks is not None else hot
    t1 = rcfg.t1_blocks if rcfg.t1_blocks is not None else t1
    specs = replay_tier_specs(cfg, hot_blocks=hot, t1_blocks=t1)
    if rcfg.t2_blocks is not None or rcfg.t3_blocks is not None:
        bb = sizing.block_bytes(cfg)
        specs = list(specs)
        if rcfg.t2_blocks is not None:
            specs[2] = dataclasses.replace(specs[2],
                                           capacity=rcfg.t2_blocks * bb)
        if rcfg.t3_blocks is not None:
            specs[3] = dataclasses.replace(specs[3],
                                           capacity=rcfg.t3_blocks * bb)
        specs = tuple(specs)
    ecfg = EngineConfig(
        max_len=max_len,
        kv_budget_bytes=rcfg.n_slots * sizing.seq_bytes(cfg, max_len),
        policy=rcfg.policy,
        deadline_s=1e9,                 # virtual time: no wall-clock
        #                                 straggler preemption
        seed=rcfg.seed,
        tier_specs=specs,
        tier0_from_budget=False,        # keep the replay pressure capacity
        async_transfers=rcfg.async_transfers,
        page_tokens=rcfg.page_tokens,
        prefill_chunk_tokens=rcfg.prefill_chunk_tokens,
        max_step_tokens=rcfg.max_step_tokens,
        fused_step=rcfg.fused_step,
        segment_reuse=rcfg.segment_reuse,
        fault_injector=(FaultInjector(dict(rcfg.fault_profiles),
                                      seed=rcfg.fault_seed)
                        if rcfg.fault_profiles else None),
        transfer_timeout_s=rcfg.transfer_timeout_s)
    return ServingEngine(cfg, ecfg, params=params, device=device)


# ---------------------------------------------------------------------------
# virtual-clock fetch-stall model
# ---------------------------------------------------------------------------
class _FetchStallModel:
    """Per-step virtual-clock stall from one engine's manager deltas.

    ``spec`` mode (default): each demand fetch from a non-hot tier —
    visible as a ``ManagerStats.tier_hits`` increment on tiers outside
    ``hot_tiers`` — stalls the clock by that tier's
    ``TierSpec.transfer_time`` at the *target* model's block bytes
    (paper-scale MB blocks, not the reduced model's KB blocks).
    Recompute stalls still charge at ``stall_weight``.  Async prefetch
    promotions are free: they overlap compute (§IV).

    ``fixed`` mode: the earlier model — a flat ``fetch_stall_s`` per
    promotion plus the reduced-size fetch/recompute accounting.
    """

    def __init__(self, rcfg: ServingReplayConfig, engine: ServingEngine):
        self.mode = rcfg.fetch_stall_model
        if self.mode not in ("spec", "fixed"):
            raise ValueError(
                f"fetch_stall_model must be 'spec' or 'fixed', "
                f"got {rcfg.fetch_stall_model!r}")
        self.fixed_s = rcfg.fetch_stall_s
        self.weight = rcfg.stall_weight
        self.hot_tiers = engine.manager.hot_tiers
        from repro_torch.configs.paper_models import PAPER_MODELS
        target = PAPER_MODELS[rcfg.target_model]
        bb = sizing.block_bytes(target)
        self.target_block_bytes = bb
        self.tier_stall_s = {t.spec.tier_id: t.spec.transfer_time(bb)
                             for t in engine.manager.hierarchy.tiers}

    def snapshot(self, engine: ServingEngine) -> tuple:
        st = engine.manager.stats
        hy = engine.manager.hierarchy
        inj = hy.fault_injector
        bo = (dict(inj.read_brownouts_by_tier) if inj is not None else {})
        return (st.fetch_time, st.recompute_time, st.promotions,
                dict(st.tier_hits), hy.counters.retry_delay_s, bo)

    def _fault_stall(self, engine: ServingEngine, rd0: float,
                     bo0: dict) -> float:
        """Virtual seconds of injected-fault latency this step: retry
        backoff delays (modelled, accumulated by ``run_io``) plus the
        brownout inflation of demand-fetch transfers — each read
        brownout turns one tier fetch into ``mult`` fetches' worth of
        stall at the target model's block bytes."""
        hy = engine.manager.hierarchy
        stall = hy.counters.retry_delay_s - rd0
        inj = hy.fault_injector
        if inj is not None:
            for tid, n in inj.read_brownouts_by_tier.items():
                d = n - bo0.get(tid, 0)
                if d > 0:
                    mult = inj.profiles[tid].brownout_latency_mult
                    stall += d * (mult - 1.0) * self.tier_stall_s[tid]
        return stall

    def charge(self, engine: ServingEngine, snap: tuple) -> float:
        f0, r0, p0, th0, rd0, bo0 = snap
        st = engine.manager.stats
        fault_s = self._fault_stall(engine, rd0, bo0)
        if self.mode == "fixed":
            return (fault_s + self.fixed_s * (st.promotions - p0)
                    + self.weight * ((st.fetch_time - f0)
                                     + (st.recompute_time - r0)))
        stall = fault_s + self.weight * (st.recompute_time - r0)
        for tier, n in st.tier_hits.items():
            if tier in self.hot_tiers:
                continue
            d = n - th0.get(tier, 0)
            if d > 0:
                stall += d * self.tier_stall_s[tier]
        return stall


def _percentile(vals: Sequence[float], p: float) -> float:
    vals = sorted(vals)
    if not vals:
        return 0.0
    return vals[min(len(vals) - 1, int(p * len(vals)))]


# ---------------------------------------------------------------------------
# the shared replay loop (single engine == 1-replica cluster)
# ---------------------------------------------------------------------------
@dataclass
class _ReplayCore:
    cluster: ReplicaCluster
    tracked: Dict[int, _Tracked]
    seen_total: int
    virtual_time: float
    steps: int
    wall_s: float
    sessions: int
    join_name: str = ""            # replica added mid-replay ("" if none)
    join_v: float = 0.0            # virtual time of the join


def _run_replay_core(rcfg: ServingReplayConfig, *,
                     cfg: Optional[ModelConfig] = None, device=None,
                     params=None, n_replicas: int = 1,
                     routing: str = "affine", ring_salt: str = "",
                     fail_after: Optional[int] = None,
                     fail_name: Optional[str] = None,
                     add_after: Optional[int] = None,
                     shared_tier: bool = False,
                     warmup_on_add: bool = False,
                     turn_log: Optional[List[dict]] = None) -> _ReplayCore:
    """Drive one workload x policy through ``n_replicas`` live engines
    under the shared virtual clock; the single-engine replay is exactly
    the 1-replica case."""
    cfg = replay_model_config(rcfg.block_tokens) if cfg is None else cfg
    device = resolve_device(device)
    if params is None:
        params = build_model(cfg).init_params(rcfg.seed, device=device)
    bt = sizing.block_tokens(cfg)
    sessions = workload_sessions(
        rcfg.workload, TraceConfig(n_sessions=rcfg.n_sessions,
                                   seed=rcfg.seed))
    cache: Dict[Tuple, List[int]] = {}
    specs: List[List[_TurnSpec]] = [
        [_turn_spec(t, bt, cfg.vocab_size, rcfg.max_new_cap, cache)
         for t in sess[:rcfg.max_turns]]
        for sess in sessions]
    max_prompt = max(len(t.prompt) for s in specs for t in s)
    max_len = max_prompt + rcfg.max_new_cap + 2
    max_len = -(-max_len // rcfg.page_tokens) * rcfg.page_tokens
    router = make_router(routing, salt=ring_salt) \
        if routing == "affine" else make_router(routing)
    cluster = ReplicaCluster(
        engine_factory=lambda: build_engine(rcfg, cfg, max_len=max_len,
                                            device=device, params=params),
        n_replicas=n_replicas, router=router, shared_tier=shared_tier)
    stall = _FetchStallModel(rcfg,
                             next(iter(cluster.engines.values())))

    n_sess = len(specs)
    next_turn = [0] * n_sess
    ready_v = [i * rcfg.session_interarrival_s for i in range(n_sess)]
    in_flight: List[Optional[int]] = [None] * n_sess   # request_id
    seen: set = set()
    tracked: Dict[int, _Tracked] = {}
    vt = 0.0
    t_wall = time.time()
    steps = 0
    done_count = 0
    failed_once = False
    added_once = False

    def pending(i: int) -> bool:
        return next_turn[i] < len(specs[i])

    while any(pending(i) for i in range(n_sess)) or cluster.has_work():
        # open-loop submission: every session whose next turn is due
        for i in range(n_sess):
            if not pending(i) or in_flight[i] is not None \
                    or ready_v[i] > vt:
                continue
            spec = specs[i][next_turn[i]]
            n_seen = sum(1 for c in spec.acct_cids if c in seen)
            seen.update(spec.acct_cids)
            target, req = cluster.dispatch(
                spec.prompt,
                params=SamplingParams(max_new_tokens=spec.max_new),
                session_id=spec.session_id,
                block_types=spec.block_types,
                tool=spec.tool,
                retain_blocks=next_turn[i] + 1 < len(specs[i]))
            tracked[req.request_id] = _Tracked(
                req=req, session=i, submit_v=vt, seen_blocks=n_seen,
                replica=target)
            in_flight[i] = req.request_id
            if turn_log is not None:
                turn_log.append({"session": spec.session_id,
                                 "turn": next_turn[i],
                                 "request_id": req.request_id,
                                 "submit_v": vt,
                                 "prompt_len": len(spec.prompt),
                                 "replica": target})
            next_turn[i] += 1
        busy = cluster.busy()
        if busy:
            # every busy replica steps once; replicas run concurrently,
            # so the fleet clock advances by the slowest replica's step
            dt_max = 0.0
            for name, eng in busy:
                snap = stall.snapshot(eng)
                produced = eng.step()
                step_tokens = eng.last_step_prefill_tokens + produced
                dt = (rcfg.step_overhead_s
                      + rcfg.per_token_s * step_tokens
                      + stall.charge(eng, snap))
                dt_max = max(dt_max, dt)
            vt += dt_max
            steps += 1
            # per-token virtual timestamps (decode emits <=1/step/request)
            for t in tracked.values():
                if t.done_v is not None:
                    continue
                while len(t.token_times) < len(t.req.generated):
                    t.token_times.append(vt)
                if t.req.phase is Phase.DONE:
                    t.done_v = vt
                    done_count += 1
                    in_flight[t.session] = None
                    ready_v[t.session] = vt + rcfg.think_time_s
        else:
            # idle: jump the clock to the next session arrival
            nxt = min((ready_v[i] for i in range(n_sess) if pending(i)),
                      default=vt)
            vt = max(vt, nxt)
        # mid-replay membership events (fleet-completion triggered)
        if (fail_after is not None and not failed_once
                and done_count >= fail_after and cluster.n_replicas > 1):
            failed_once = True
            if fail_name is not None:
                victim = fail_name
            else:
                # default victim: the replica with the most live work
                # (ties by name) — failing an idle replica would make
                # the failover tax trivially zero
                victim = max(
                    sorted(cluster.engines),
                    key=lambda n:
                        cluster.engines[n].scheduler.live_count())
            n_lost = cluster.fail_replica(victim)
            for rid, _frm, to in cluster.redispatch_log[-n_lost:]:
                t = tracked[rid]
                # generation restarts on the successor: drop the stale
                # token timestamps but keep submit_v, so TTFT carries
                # the full failover re-prefill tax
                t.token_times.clear()
                t.replica = to
                t.redispatches += 1
        if (add_after is not None and not added_once
                and done_count >= add_after):
            added_once = True
            join_name = cluster.add_replica(warmup=warmup_on_add)
            join_v = vt
        if steps >= rcfg.max_steps:
            break
    cluster.shutdown()

    done = [t for t in tracked.values() if t.done_v is not None]
    return _ReplayCore(cluster=cluster, tracked=tracked,
                       seen_total=sum(t.seen_blocks for t in done),
                       virtual_time=vt, steps=steps,
                       wall_s=time.time() - t_wall, sessions=n_sess,
                       join_name=join_name if added_once else "",
                       join_v=join_v if added_once else 0.0)


def _latency_rollup(core: _ReplayCore) -> dict:
    done = [t for t in core.tracked.values() if t.done_v is not None]
    ttfts = [t.token_times[0] - t.submit_v for t in done if t.token_times]
    tbts = [b - a for t in done
            for a, b in zip(t.token_times, t.token_times[1:])]
    gen = sum(len(t.req.generated) for t in done)
    vt = core.virtual_time
    return dict(
        requests_done=len(done), generated_tokens=gen,
        ttft_p50=_percentile(ttfts, 0.50), ttft_p95=_percentile(ttfts, 0.95),
        ttft_p99=_percentile(ttfts, 0.99),
        tbt_p50=_percentile(tbts, 0.50), tbt_p95=_percentile(tbts, 0.95),
        throughput_tok_s=gen / vt if vt > 0 else 0.0,
        virtual_time_s=vt, steps=core.steps, wall_s=core.wall_s)


def run_serving_replay(rcfg: ServingReplayConfig,
                       turn_log: Optional[List[dict]] = None, *,
                       cfg: Optional[ModelConfig] = None, device=None,
                       params=None) -> ServingReplayResult:
    """Replay one workload x policy through one live engine (the
    1-replica case of the shared loop).

    ``turn_log`` (optional) receives one dict per submitted turn
    (session, turn index, request id, virtual submit time, replica) —
    the determinism / ordering tests assert on it.
    """
    core = _run_replay_core(rcfg, cfg=cfg, device=device, params=params,
                            n_replicas=1, turn_log=turn_log)
    eng = next(iter(core.cluster.engines.values()))
    done = [t for t in core.tracked.values() if t.done_v is not None]
    seen_total = core.seen_total
    hot = sum(min(t.req.hot_hit_blocks, t.seen_blocks) for t in done)
    # any-tier cache-served: contiguous prefix blocks plus mid-prompt
    # segment-resumed blocks (disjoint by construction — segments start
    # past the materialized prefix)
    served = sum(min(t.req.prefix_hit_blocks + t.req.segment_hit_blocks,
                     t.seen_blocks) for t in done)
    seg = sum(min(t.req.segment_hit_blocks, t.seen_blocks) for t in done)
    eng.manager.sync_fault_stats()
    mst = eng.manager.stats
    hy = eng.manager.hierarchy
    lat = _latency_rollup(core)
    return ServingReplayResult(
        workload=rcfg.workload, policy=rcfg.policy,
        engine_hit_rate=hot / seen_total if seen_total else 0.0,
        reuse_rate=served / seen_total if seen_total else 0.0,
        seen_blocks=seen_total,
        manager_hit_rate=mst.hit_rate,
        manager_replay_hit_rate=mst.replay_hit_rate,
        hot_hits_t0=mst.hot_hits_t0, hot_hits_t1=mst.hot_hits_t1,
        cow_share_hits=eng.cow_share_hits, inject_hits=eng.inject_hits,
        promotions=mst.promotions, demotions=mst.demotions,
        sessions=core.sessions,
        segment_hit_blocks=seg,
        segment_share_hits=eng.segment_share_hits,
        segment_inject_hits=eng.segment_inject_hits,
        segment_lookups=mst.segment_lookups,
        segment_lookup_s=mst.segment_lookup_time,
        turns_submitted=len(core.tracked),
        retries=mst.retries, io_errors=mst.io_errors,
        integrity_failures=mst.integrity_failures,
        fetch_recomputes=mst.fetch_recomputes,
        retry_delay_s=hy.counters.retry_delay_s,
        tier_health=dict(mst.tier_health),
        injected=(hy.fault_injector.stats()
                  if hy.fault_injector is not None else {}), **lat)


def run_cluster_replay(rcfg: ClusterReplayConfig,
                       turn_log: Optional[List[dict]] = None, *,
                       cfg: Optional[ModelConfig] = None, device=None,
                       params=None) -> ClusterReplayResult:
    """Replay one workload x policy through an ``n_replicas`` cluster
    under the configured routing policy (plus optional mid-replay
    ``fail_replica`` / ``add_replica`` events); reports per-replica and
    fleet-level hit rates against the fleet-wide previously-seen ground
    truth, plus the failover redispatch / re-prefill tax."""
    core = _run_replay_core(
        rcfg, cfg=cfg, device=device, params=params,
        n_replicas=rcfg.n_replicas, routing=rcfg.routing,
        ring_salt=rcfg.ring_salt,
        fail_after=rcfg.fail_replica_after_turns,
        fail_name=rcfg.fail_replica_name,
        add_after=rcfg.add_replica_after_turns,
        shared_tier=rcfg.shared_tier,
        warmup_on_add=rcfg.warmup_on_add,
        turn_log=turn_log)
    cluster = core.cluster
    done = [t for t in core.tracked.values() if t.done_v is not None]
    seen_total = core.seen_total
    hot = sum(min(t.req.hot_hit_blocks, t.seen_blocks) for t in done)
    served = sum(min(t.req.prefix_hit_blocks, t.seen_blocks) for t in done)
    # a shared-tier import is a tier-4 fetch instead of a re-prefill:
    # count it toward the fleet-level hit (capped, like hot, at the
    # request's previously-seen ground truth)
    shared = sum(min(t.req.shared_hit_blocks, t.seen_blocks) for t in done)
    incl = sum(min(t.req.hot_hit_blocks + t.req.shared_hit_blocks,
                   t.seen_blocks) for t in done)

    per_replica: List[ReplicaReplayStats] = []
    mgr_stats = cluster.manager_stats()
    names = sorted(mgr_stats)
    for name in names:
        mine = [t for t in done if t.replica == name]
        s_seen = sum(t.seen_blocks for t in mine)
        s_hot = sum(min(t.req.hot_hit_blocks, t.seen_blocks) for t in mine)
        s_served = sum(min(t.req.prefix_hit_blocks, t.seen_blocks)
                       for t in mine)
        ms = mgr_stats[name]
        per_replica.append(ReplicaReplayStats(
            name=name, failed=name in cluster.failed_stats,
            requests_done=len(mine), seen_blocks=s_seen,
            hot_hit_blocks=s_hot,
            hit_rate=s_hot / s_seen if s_seen else 0.0,
            reuse_rate=s_served / s_seen if s_seen else 0.0,
            manager_hit_rate=ms.hit_rate,
            promotions=ms.promotions, demotions=ms.demotions,
            shared_hit_blocks=sum(t.req.shared_hit_blocks for t in mine)))
    lat = _latency_rollup(core)
    # scale-out warm-up: TTFT of turns the joiner served vs steady-state
    # turns (elsewhere, never redispatched) — the post-join spike metric
    postjoin = steady = 0.0
    if core.join_name:
        j_ttfts = [t.token_times[0] - t.submit_v for t in done
                   if t.replica == core.join_name and t.token_times]
        s_ttfts = [t.token_times[0] - t.submit_v for t in done
                   if t.replica != core.join_name and t.token_times
                   and t.redispatches == 0]
        postjoin = _percentile(j_ttfts, 0.95)
        steady = _percentile(s_ttfts, 0.95)
    return ClusterReplayResult(
        workload=rcfg.workload, policy=rcfg.policy, routing=rcfg.routing,
        n_replicas=len(names),
        fleet_hit_rate=hot / seen_total if seen_total else 0.0,
        fleet_reuse_rate=served / seen_total if seen_total else 0.0,
        seen_blocks=seen_total, per_replica=per_replica,
        redispatched=cluster.redispatched,
        reprefill_tokens=cluster.reprefill_tokens,
        failed_replicas=sorted(cluster.failed_stats),
        sessions=core.sessions,
        shared_tier=rcfg.shared_tier,
        shared_hit_blocks=shared,
        shared_hit_rate=shared / seen_total if seen_total else 0.0,
        fleet_hit_rate_incl_shared=incl / seen_total if seen_total else 0.0,
        joined_replica=core.join_name,
        postjoin_ttft_p95=postjoin, steady_ttft_p95=steady,
        warmed_blocks=cluster.warmed_blocks,
        warmed_sessions=cluster.warmed_sessions, **lat)


def run_replay_serving_table(
        workloads: Sequence[str] = ("sharegpt", "lmsys", "agentic"),
        policies: Sequence[str] = ("lru", "ema", "bayesian"), *,
        n_sessions: int = 12, seed: int = 0, max_turns: int = 6,
        device=None) -> List[ServingReplayResult]:
    """Table-V-style sweep through the live engine (one seed: the live
    replay is ~100x the cost of the block-level replay per run; the
    block-level ``run_table_v`` remains the multi-seed statistics)."""
    out = []
    for wl in workloads:
        for policy in policies:
            out.append(run_serving_replay(ServingReplayConfig(
                workload=wl, policy=policy, n_sessions=n_sessions,
                seed=seed, max_turns=max_turns), device=device))
    return out


def run_cluster_table(
        workload: str = "lmsys", policy: str = "bayesian", *,
        n_replicas: Sequence[int] = (1, 2, 4),
        routings: Sequence[str] = ("affine", "round_robin"),
        n_sessions: int = 12, seed: int = 0, max_turns: int = 6,
        shared_tier: bool = False, device=None,
        ) -> List[ClusterReplayResult]:
    """The fleet-level sweep behind ``benchmarks/run.py --table
    cluster``: ``n_replicas x routing_policy`` on one workload.  The
    headline question: does session-affine routing recover the
    single-engine hit rate that session-blind routing fragments?  With
    ``shared_tier=True`` every cell binds the fleet-shared tier 4, and
    the incl-shared hit rate shows how many of the fragmented points a
    cross-replica tier-4 fetch recovers."""
    out = []
    for n in n_replicas:
        for routing in routings:
            if n == 1 and routing != "affine":
                continue            # routing is moot on one replica
            out.append(run_cluster_replay(ClusterReplayConfig(
                workload=workload, policy=policy, n_sessions=n_sessions,
                seed=seed, max_turns=max_turns, n_replicas=n,
                routing=routing, shared_tier=shared_tier),
                device=device))
    return out
