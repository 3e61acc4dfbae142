"""Multi-replica serving cluster: N share-nothing ``ServingEngine``
replicas behind a pluggable request router, with mid-run failover and
elastic scale-out (paper §VII scaling / graceful degradation).

Promoted out of ``launch/serve.py`` (which is now a thin CLI over this
module) so the trace replay can evaluate fleet-level behaviour — the
paper's throughput and cost claims are fleet-level: consistent-hash
session affinity keeps each replica's prefix cache warm, and failover
re-prefills the lost KV on the successor replica.

Routing policies (``make_router``):

  * ``affine`` — consistent-hash session affinity over the same ring
    implementation as the RDMA tier (``core/tiers.ConsistentHashRing``).
    A session's every turn lands on the same replica, so cross-turn
    radix-prefix reuse keeps working; node join/leave remaps ~1/n of
    the session space.
  * ``round_robin`` — classic load spreading, deliberately blind to
    sessions: consecutive turns of one conversation land on different
    replicas, fragmenting the prefix cache.  This is the naive baseline
    the cluster replay (``benchmarks/run.py --table cluster``) measures
    the affinity win against.
  * ``least_loaded`` — route to the replica with the fewest live
    requests (waiting + running + preempted + blocked); ties break by
    name for determinism.
  * ``prefix`` — prefix-cache-aware routing: probe every replica's
    radix tree (non-mutating) for the request's tokens and route to the
    replica holding the longest matching prefix; with no match anywhere
    (or no tokens available) fall back to least-loaded.  A session
    sticks to its replica implicitly — its turn-1 prefix registers
    there, so turn 2's probe finds it — and, unlike hash affinity, two
    sessions sharing a template prefix co-locate on the replica that
    already holds it.

**Fleet-shared tier 4** (``shared_tier=True``): the cluster owns one
``core/tiers.FleetKVStore`` — a content-addressed RDMA namespace — and
binds every replica's tier 4 to it (``SharedTierView``), so a popular
template's blocks occupy fabric bytes once fleet-wide and a replica can
import a prefix another replica published (a tier-4 fetch instead of a
re-prefill).  A failed replica's teardown releases only ITS references;
shared bytes other replicas still use stay resident.

**Scale-out warm-up** (``add_replica(warmup=True)``): before the joiner
takes traffic, sessions the router remaps onto it get their registered
prefix blocks (payloads included) pushed from their previous replica,
so the first post-join turn hits hot instead of paying a re-prefill
TTFT spike.

Failover (``fail_replica``): the dead replica's scheduler is drained —
waiting, running, preempted AND transfer-blocked requests — and every
request is re-dispatched through the router after
``Request.reset_for_redispatch()`` wipes the per-request accounting
that referred to the dead engine (generated tokens, slot, block ids,
chunk cursor, prefix/hot hit counts).  The dead engine's transfer
worker is closed and its cache-manager/tier registrations are released
(``ServingEngine.release_resources``) instead of leaking; its
``ManagerStats`` are retained for fleet aggregation.  The successor
replica re-prefills the lost KV from scratch — the recomputation tax
the paper's graceful-degradation story pays, surfaced here as
``reprefill_tokens``.

Scale-out (``add_replica``): a new share-nothing engine joins the
router; under ``affine`` routing ~1/n of the session space remaps to it
(cold prefix cache until those sessions resubmit their prefixes).

The port of the JAX package's ``serving/cluster.py``.  Two things
differ: the default replica factory builds each engine on ``device``
(the card unless the caller names another, as ``ServingEngine`` does),
and its replicas share one read-only params tree, made once from the
engine seed — the same weights the JAX replicas re-init from that
seed, held once on the card.  A caller's factory is used as it is.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.cache_manager import ManagerStats
from repro_torch.core.tiers import ConsistentHashRing, FleetKVStore
from repro_torch.models.common import resolve_device
from repro_torch.models.model import build_model
from repro_torch.serving.engine import EngineConfig, ServingEngine
from repro_torch.serving.request import Request


# ---------------------------------------------------------------------------
# Routing policies
# ---------------------------------------------------------------------------
class RoutingPolicy:
    """Maps a session key to a replica name.  Stateful: policies are
    told about replica join/leave so failover and scale-out re-route
    without the cluster knowing policy internals.  ``tokens`` (the
    request's prompt tokens, when the dispatcher has them) lets
    content-aware policies inspect the prefix; hash/load policies
    ignore it."""

    name = "?"

    def add_replica(self, replica: str) -> None:
        raise NotImplementedError

    def remove_replica(self, replica: str) -> None:
        raise NotImplementedError

    def route(self, key: str, engines: Dict[str, "ServingEngine"] = None,
              tokens: Optional[Sequence[int]] = None) -> str:
        raise NotImplementedError


class SessionAffinityRouter(RoutingPolicy):
    """Consistent-hash session affinity (the paper's default).

    ``salt`` seeds the key hashing, so tests can pin — or deliberately
    vary — the session→replica assignment without renaming replicas.
    """

    name = "affine"

    def __init__(self, vnodes: int = 64, salt: str = ""):
        self.ring = ConsistentHashRing(vnodes=vnodes)
        self.salt = salt

    def add_replica(self, replica: str) -> None:
        self.ring.add_node(replica)

    def remove_replica(self, replica: str) -> None:
        self.ring.remove_node(replica)

    def route(self, key: str, engines=None, tokens=None) -> str:
        return self.ring.lookup(f"{self.salt}:{key}" if self.salt else key)


class RoundRobinRouter(RoutingPolicy):
    """Session-blind load spreading — the fragmentation baseline."""

    name = "round_robin"

    def __init__(self):
        self._replicas: List[str] = []
        self._next = 0

    def add_replica(self, replica: str) -> None:
        if replica not in self._replicas:
            self._replicas.append(replica)
            self._replicas.sort()

    def remove_replica(self, replica: str) -> None:
        if replica in self._replicas:
            self._replicas.remove(replica)

    def route(self, key: str, engines=None, tokens=None) -> str:
        if not self._replicas:
            raise RuntimeError("no replicas")
        out = self._replicas[self._next % len(self._replicas)]
        self._next += 1
        return out


class LeastLoadedRouter(RoutingPolicy):
    """Route to the replica with the fewest live requests."""

    name = "least_loaded"

    def __init__(self):
        self._replicas: List[str] = []

    def add_replica(self, replica: str) -> None:
        if replica not in self._replicas:
            self._replicas.append(replica)
            self._replicas.sort()

    def remove_replica(self, replica: str) -> None:
        if replica in self._replicas:
            self._replicas.remove(replica)

    @staticmethod
    def _load(eng: "ServingEngine") -> int:
        return eng.scheduler.live_count()

    def route(self, key: str, engines: Dict[str, "ServingEngine"] = None,
              tokens=None) -> str:
        if not self._replicas:
            raise RuntimeError("no replicas")
        return min(self._replicas, key=lambda n: (self._load(engines[n]), n))


class PrefixAwareRouter(RoutingPolicy):
    """Prefix-cache-aware routing: probe every replica's radix tree
    (non-mutating) for the request's tokens; the replica holding the
    longest live matching prefix wins (ties break by name).  With no
    match anywhere — or no tokens supplied — fall back to least-loaded.

    Sessions stick implicitly: turn 1 registers its prefix on whichever
    replica it lands, so turn 2's probe finds it there.  Unlike hash
    affinity, sessions sharing a template prefix co-locate."""

    name = "prefix"

    def __init__(self):
        self._replicas: List[str] = []

    def add_replica(self, replica: str) -> None:
        if replica not in self._replicas:
            self._replicas.append(replica)
            self._replicas.sort()

    def remove_replica(self, replica: str) -> None:
        if replica in self._replicas:
            self._replicas.remove(replica)

    def route(self, key: str, engines: Dict[str, "ServingEngine"] = None,
              tokens: Optional[Sequence[int]] = None) -> str:
        if not self._replicas:
            raise RuntimeError("no replicas")
        if tokens is not None and engines:
            best, best_n = "", 0
            for n in self._replicas:
                depth = engines[n].manager.peek_prefix_blocks(tokens)
                if depth > best_n:
                    best, best_n = n, depth
            if best_n > 0:
                return best
        if not engines:
            return self._replicas[0]
        return min(self._replicas,
                   key=lambda n: (engines[n].scheduler.live_count(), n))


ROUTERS: Dict[str, Callable[[], RoutingPolicy]] = {
    "affine": SessionAffinityRouter,
    "round_robin": RoundRobinRouter,
    "least_loaded": LeastLoadedRouter,
    "prefix": PrefixAwareRouter,
}


def make_router(policy: str, **kw) -> RoutingPolicy:
    if policy not in ROUTERS:
        raise ValueError(f"unknown routing policy {policy!r} "
                         f"(have {sorted(ROUTERS)})")
    return ROUTERS[policy](**kw)


# ---------------------------------------------------------------------------
# The cluster
# ---------------------------------------------------------------------------
class ReplicaCluster:
    """N share-nothing engine replicas + pluggable request routing.

    ``engine_factory`` builds one replica engine; the default constructs
    ``ServingEngine(cfg, engine_cfg, device=device)`` over one params
    tree shared by every replica (made once from the engine seed;
    replicas share no other state).  The trace replay passes a factory
    that applies its replay tier specs and virtual-clock engine config.
    """

    def __init__(self, cfg=None, engine_cfg: Optional[EngineConfig] = None,
                 n_replicas: int = 2, *, routing: str = "affine",
                 engine_factory: Optional[Callable[[], ServingEngine]] = None,
                 router: Optional[RoutingPolicy] = None,
                 name_prefix: str = "replica",
                 shared_tier: bool = False,
                 rdma_nodes: Sequence[str] = ("node0", "node1",
                                              "node2", "node3"),
                 device=None):
        if engine_factory is None:
            if cfg is None:
                raise ValueError("need cfg+engine_cfg or engine_factory")
            engine_cfg = EngineConfig() if engine_cfg is None else engine_cfg
            device = resolve_device(device)
            params = build_model(cfg).init_params(engine_cfg.seed,
                                                  device=device)
            engine_factory = lambda: ServingEngine(  # noqa: E731
                cfg, engine_cfg, params=params, device=device)
        self._factory = engine_factory
        self._prefix = name_prefix
        self._next_replica = 0
        self.router = router if router is not None else make_router(routing)
        self.engines: Dict[str, ServingEngine] = {}
        # fleet-shared tier 4: one content-addressed namespace every
        # replica's TierHierarchy binds (created lazily from the first
        # replica's tier-4 spec so replay tier overrides apply)
        self._shared_tier = shared_tier
        self._rdma_nodes = tuple(rdma_nodes)
        self.fleet_store: Optional[FleetKVStore] = None
        # session → last submitted prompt / serving replica, kept for
        # the scale-out warm-up path (push remapped sessions' hot
        # blocks to a joiner before it takes traffic)
        self._session_prompt: Dict[str, List[int]] = {}
        self._session_replica: Dict[str, str] = {}
        self.warmed_blocks = 0
        self.warmed_sessions = 0
        # failed replicas keep ONLY their ManagerStats and completed
        # count for fleet rollup — retaining the dead engine would keep
        # its params and KV pool (the dominant allocations) alive
        self.failed_stats: Dict[str, ManagerStats] = {}
        self.failed_done: Dict[str, int] = {}
        self.redispatched = 0
        self.reprefill_tokens = 0          # prompt tokens whose KV was lost
        self._anon_ids = 0
        # (request_id, from_replica, to_replica) per failover redispatch
        self.redispatch_log: List[Tuple[int, str, str]] = []
        for _ in range(n_replicas):
            self.add_replica()

    # -- membership ---------------------------------------------------------
    @property
    def n_replicas(self) -> int:
        return len(self.engines)

    def add_replica(self, name: Optional[str] = None, *,
                    warmup: bool = False) -> str:
        """Join a fresh replica; under affine routing ~1/n of the
        session space remaps onto it.  With ``warmup=True`` the
        sessions the router remaps onto the joiner get their prefix
        blocks (payloads included) pushed from their previous replica
        BEFORE the joiner takes traffic, so the first post-join turn
        hits hot instead of paying a re-prefill TTFT spike."""
        if name is None:
            name = f"{self._prefix}{self._next_replica}"
        self._next_replica += 1
        if name in self.engines or name in self.failed_stats:
            # a failed replica's name stays reserved: reusing it would
            # collide the stats rollups and mark the newcomer failed
            raise ValueError(f"replica {name!r} already exists")
        eng = self._factory()
        if self._shared_tier:
            if self.fleet_store is None:
                spec = next((t.spec for t in eng.manager.hierarchy.tiers
                             if t.spec.tier_id == 4), None)
                if spec is not None:
                    self.fleet_store = FleetKVStore(
                        spec, nodes=self._rdma_nodes)
            if self.fleet_store is not None:
                eng.bind_fleet_store(self.fleet_store, name)
        self.engines[name] = eng
        self.router.add_replica(name)
        if warmup:
            for sid, prompt in self._session_prompt.items():
                src = self._session_replica.get(sid)
                if src is None or src == name or src not in self.engines:
                    continue
                if self.route(sid) != name:
                    continue             # session did not remap to joiner
                n = self._warm_session(sid, prompt, src, name)
                if n:
                    self.warmed_blocks += n
                    self.warmed_sessions += 1
        return name

    def _warm_session(self, sid: str, prompt: List[int],
                      src_name: str, dst_name: str) -> int:
        """Copy one remapped session's registered prefix blocks (with
        payloads) from its previous replica to the joiner.  Returns the
        number of blocks adopted."""
        src = self.engines[src_name].manager
        dst = self.engines[dst_name].manager
        tokens = list(prompt)[:-1]       # engines never cache the last token
        bids = src.match_prefix(tokens)
        if not bids:
            return 0
        bt = src.block_tokens
        payloads = [src._payloads.get(b) for b in bids]
        adopted = dst.adopt_sequence(tokens[:len(bids) * bt], payloads)
        return len(adopted)

    def fail_replica(self, name: str) -> int:
        """Kill a replica: drain every live request (waiting, running,
        preempted, transfer-blocked), reset their per-request accounting,
        re-dispatch through the router, and release the dead engine's
        manager/tier registrations.  Returns the redispatch count."""
        if len(self.engines) <= 1:
            # check BEFORE mutating: there is nowhere to re-dispatch,
            # and popping first would leave an empty, unusable cluster
            raise RuntimeError("cannot fail the last replica")
        eng = self.engines.pop(name)
        self.router.remove_replica(name)
        lost = eng.scheduler.drain_requests()
        for req in lost:
            # KV (including any generated tokens) died with the replica:
            # the successor re-prefills the prompt from scratch
            self.reprefill_tokens += req.prompt_len + len(req.generated)
            req.reset_for_redispatch()
            target = self.route(req.session_id or str(req.request_id),
                                tokens=list(req.prompt)[:-1])
            self.engines[target].scheduler.submit(req)
            if req.session_id is not None:
                self._session_replica[req.session_id] = target
            self.redispatched += 1
            self.redispatch_log.append((req.request_id, name, target))
        eng.manager.sync_fault_stats()
        self.failed_stats[name] = eng.manager.stats
        self.failed_done[name] = len(eng.scheduler.done)
        eng.release_resources()
        return len(lost)

    def cancel_request(self, request: Request) -> bool:
        """Cancel one live request wherever it lives (frontend drain-
        deadline shedding); returns True when an engine released it."""
        for eng in self.engines.values():
            if eng.cancel_request(request):
                return True
        return False

    # -- dispatch -----------------------------------------------------------
    def route(self, session_key: str,
              tokens: Optional[Sequence[int]] = None) -> str:
        return self.router.route(session_key, self.engines, tokens)

    def dispatch(self, prompt, *, session_id: Optional[str] = None,
                 **kw) -> Tuple[str, Request]:
        """Route + submit; returns (replica_name, request).  Session-less
        requests route by a fresh surrogate key so they still spread
        across the ring."""
        key = session_id if session_id is not None \
            else f"anon{self._anon_ids}"
        self._anon_ids += 1
        target = self.route(key, tokens=list(prompt)[:-1])
        if session_id is not None:
            self._session_prompt[session_id] = list(prompt)
            self._session_replica[session_id] = target
        req = self.engines[target].submit(prompt, session_id=session_id,
                                          **kw)
        return target, req

    def submit(self, prompt, *, session_id: Optional[str] = None,
               **kw) -> Request:
        return self.dispatch(prompt, session_id=session_id, **kw)[1]

    # -- stepping -----------------------------------------------------------
    def busy(self) -> List[Tuple[str, ServingEngine]]:
        """Replicas with live work, in stable name order."""
        return [(n, e) for n, e in sorted(self.engines.items())
                if e.scheduler.has_work()]

    def step(self) -> int:
        """One fleet iteration: every busy replica steps once (replicas
        run concurrently in a real deployment).  Returns tokens
        produced fleet-wide."""
        produced = 0
        for _, eng in self.busy():
            produced += eng.step()
        return produced

    def has_work(self) -> bool:
        return any(e.scheduler.has_work() for e in self.engines.values())

    def run(self, max_steps: int = 10_000) -> dict:
        steps = 0
        while steps < max_steps and self.has_work():
            self.step()
            steps += 1
        return self.stats()

    # -- stats --------------------------------------------------------------
    def manager_stats(self, include_failed: bool = True
                      ) -> Dict[str, ManagerStats]:
        """Per-replica ``ManagerStats`` (failed replicas retain theirs
        for fleet aggregation)."""
        out = {}
        for n, e in self.engines.items():
            e.manager.sync_fault_stats()
            out[n] = e.manager.stats
        if include_failed:
            out.update(self.failed_stats)
        return out

    # quarantined beats probing beats degraded beats healthy when two
    # replicas disagree about the same tier id in the fleet rollup
    _HEALTH_RANK = {"healthy": 0, "degraded": 1, "probing": 2,
                    "quarantined": 3}

    def fleet_manager_stats(self) -> ManagerStats:
        """Fleet-wide rollup: field-wise sum over every replica that
        ever served traffic (hit rates derive from the summed counts).
        ``tier_health`` merges worst-state-wins per tier id."""
        agg = ManagerStats()
        for ms in self.manager_stats().values():
            for f in dataclasses.fields(ManagerStats):
                if f.name == "tier_hits":
                    for t, n in ms.tier_hits.items():
                        agg.tier_hits[t] = agg.tier_hits.get(t, 0) + n
                elif f.name == "tier_health":
                    for t, st in ms.tier_health.items():
                        cur = agg.tier_health.get(t, "healthy")
                        if self._HEALTH_RANK.get(st, 0) > \
                                self._HEALTH_RANK.get(cur, 0):
                            agg.tier_health[t] = st
                        else:
                            agg.tier_health.setdefault(t, cur)
                else:
                    setattr(agg, f.name,
                            getattr(agg, f.name) + getattr(ms, f.name))
        return agg

    def stats(self) -> dict:
        agg = {"replicas": {n: e.stats()
                            for n, e in sorted(self.engines.items())},
               "failed_replicas": sorted(self.failed_stats),
               "routing": self.router.name,
               "redispatched": self.redispatched,
               "reprefill_tokens": self.reprefill_tokens,
               "shared_tier": self._shared_tier,
               "warmed_blocks": self.warmed_blocks,
               "warmed_sessions": self.warmed_sessions}
        if self.fleet_store is not None:
            agg["fleet_store"] = self.fleet_store.stats()
        agg["done"] = sum(s["scheduler"]["done"]
                          for s in agg["replicas"].values())
        agg["done"] += sum(self.failed_done.values())
        fleet = self.fleet_manager_stats()
        agg["fleet"] = {"hit_rate_hot": fleet.hit_rate,
                        "accesses": fleet.accesses,
                        "hot_hits_t0": fleet.hot_hits_t0,
                        "hot_hits_t1": fleet.hot_hits_t1,
                        "promotions": fleet.promotions,
                        "demotions": fleet.demotions}
        return agg

    def shutdown(self) -> None:
        for eng in self.engines.values():
            eng.shutdown()
