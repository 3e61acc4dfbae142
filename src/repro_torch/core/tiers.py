"""Six-tier memory hierarchy for KV cache blocks (paper §III-B, Table II).

TPU adaptation (DESIGN.md §Hardware-adaptation): the paper's tiers are
GPU-centric (HBM3 / pinned DRAM via CUDA streams / CXL mmap / cuFile GDS /
ibverbs RDMA / Lustre).  On a TPU pod the same hierarchy maps to:

    Tier 0  device HBM     (jax arrays, donated in-place updates)
    Tier 1  host DRAM      (numpy, pinned-host analogue; async D2H/H2D)
    Tier 2  CXL pool       (mmap-backed store; on v5e hosts this models a
                            CXL 3.0 expander attached to the host)
    Tier 3  NVMe           (file-backed store, O_DIRECT-aligned records)
    Tier 4  remote pool    (consistent-hash ring over ICI/DCN peers —
                            one-sided RDMA read ~ remote host fetch)
    Tier 5  parallel FS    (content-addressed files, dedup via SHA-256)

Every tier implements the uniform ``TierManager`` interface with
thread-safe Allocate / Read / Write / Evict / Stats (paper §IV).  Since
this container has no CXL/NVMe/IB hardware, non-host tiers are backed by
in-memory or file stores and *account* transfer time against the published
bandwidth/latency specs — that accounting is what the trace replay and the
analytical projections consume (paper §V-B methodology).
"""
from __future__ import annotations

import bisect
import hashlib
import itertools
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.faults import (FaultCounters, FaultInjector, HealthConfig,
                               HEALTHY, QUARANTINED, RetryPolicy,
                               TierHealthMonitor, TierIntegrityError,
                               TierIOError, payload_crc)


# ---------------------------------------------------------------------------
# Published hardware specifications (paper Table II)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class TierSpec:
    tier_id: int
    name: str
    bandwidth: float          # bytes / s
    latency: float            # seconds (GPU-observed)
    cost_per_gb_hour: float   # $ / GB / h
    capacity: float           # bytes

    def transfer_time(self, nbytes: float) -> float:
        return self.latency + nbytes / self.bandwidth


GB = 1024 ** 3
TB = 1024 ** 4

# Capacities follow Table IV's cumulative column: 40 GB -> 200 -> 712 ->
# 4.7 TB -> 38+ TB.
PAPER_TIER_SPECS: Tuple[TierSpec, ...] = (
    TierSpec(0, "gpu_hbm", 3.35e12, 100e-9, 0.500, 40 * GB),
    TierSpec(1, "cpu_dram", 204e9, 3e-6, 0.050, 160 * GB),
    TierSpec(2, "cxl_mem", 64e9, 500e-9, 0.030, 512 * GB),
    TierSpec(3, "nvme_gds", 12e9, 10e-6, 0.020, 4 * TB),
    TierSpec(4, "rdma_pool", 50e9, 5e-6, 0.005, 34 * TB),
    TierSpec(5, "parallel_fs", 2e9, 1e-3, 0.001, 1000 * TB),
)

# TPU v5e single-host flavour (DESIGN.md): HBM 16 GB/chip, PCIe host link.
TPU_V5E_TIER_SPECS: Tuple[TierSpec, ...] = (
    TierSpec(0, "tpu_hbm", 819e9, 100e-9, 0.500, 16 * GB),
    TierSpec(1, "host_dram", 128e9, 3e-6, 0.050, 128 * GB),
    TierSpec(2, "cxl_mem", 64e9, 500e-9, 0.030, 512 * GB),
    TierSpec(3, "nvme", 8e9, 20e-6, 0.020, 4 * TB),
    TierSpec(4, "ici_remote", 50e9, 5e-6, 0.005, 34 * TB),
    TierSpec(5, "parallel_fs", 2e9, 1e-3, 0.001, 1000 * TB),
)


# ---------------------------------------------------------------------------
# Stats
# ---------------------------------------------------------------------------
@dataclass
class TierStats:
    reads: int = 0
    writes: int = 0
    evictions: int = 0
    bytes_read: float = 0.0
    bytes_written: float = 0.0
    sim_time: float = 0.0            # accumulated modelled transfer time
    byte_hours: float = 0.0          # for $/Mtok accounting
    integrity_failures: int = 0      # crc mismatches caught on read

    def as_dict(self) -> dict:
        return dataclasses_asdict(self)


def dataclasses_asdict(obj) -> dict:
    import dataclasses
    return dataclasses.asdict(obj)


# ---------------------------------------------------------------------------
# TierManager — uniform interface (paper §IV)
# ---------------------------------------------------------------------------
class CapacityError(RuntimeError):
    pass


class TierManager:
    """One memory tier: a block store with capacity + transfer accounting."""

    def __init__(self, spec: TierSpec, *, backing_dir: Optional[str] = None):
        self.spec = spec
        self._store: Dict[str, Optional[np.ndarray]] = {}
        self._sizes: Dict[str, float] = {}
        self._used = 0.0
        self._lock = threading.RLock()
        self.stats = TierStats()
        self.available = True
        self._dir = backing_dir
        # fault tolerance: the hierarchy attaches one injector to every
        # tier; None means the fault hooks below are skipped entirely
        self.fault_injector: Optional[FaultInjector] = None
        self._crc: Dict[str, int] = {}
        if backing_dir:
            os.makedirs(backing_dir, exist_ok=True)

    # -- helpers ------------------------------------------------------------
    def _path(self, block_id: str) -> str:
        assert self._dir
        return os.path.join(self._dir, hashlib.sha256(
            block_id.encode()).hexdigest())

    def _charge(self, nbytes: float, *, read: bool,
                mult: float = 1.0) -> float:
        t = self.spec.transfer_time(nbytes) * mult
        self.stats.sim_time += t
        if read:
            self.stats.reads += 1
            self.stats.bytes_read += nbytes
        else:
            self.stats.writes += 1
            self.stats.bytes_written += nbytes
        return t

    # -- interface ------------------------------------------------------------
    @property
    def used(self) -> float:
        return self._used

    @property
    def free(self) -> float:
        return self.spec.capacity - self._used

    def contains(self, block_id: str) -> bool:
        with self._lock:
            return block_id in self._sizes

    def allocate(self, block_id: str, nbytes: float) -> None:
        with self._lock:
            if not self.available:
                raise CapacityError(f"tier {self.spec.name} unavailable")
            if block_id in self._sizes:
                return
            if self._used + nbytes > self.spec.capacity:
                raise CapacityError(
                    f"tier {self.spec.name}: {nbytes:.0f}B over capacity "
                    f"({self._used:.0f}/{self.spec.capacity:.0f})")
            self._sizes[block_id] = nbytes
            self._store[block_id] = None
            self._used += nbytes

    def _verify(self, block_id: str, payload: Optional[np.ndarray],
                crc: Optional[int]) -> None:
        """Checksum gate on the read path: a payload whose crc32 does not
        match what was recorded at write time is corrupt and must never
        reach a decode — raise instead of returning it."""
        if crc is None or payload is None:
            return
        if payload_crc(payload) != crc:
            self.stats.integrity_failures += 1
            raise TierIntegrityError(self.spec.tier_id, "read", block_id)

    def write(self, block_id: str, payload: Optional[np.ndarray],
              nbytes: Optional[float] = None) -> float:
        """Returns modelled transfer time (seconds).  Raises
        ``TierIOError`` on an injected transient write fault (before any
        state mutates)."""
        with self._lock:
            inj, mult = self.fault_injector, 1.0
            if inj is not None:
                mult = inj.check_write(self.spec.tier_id, block_id)
            if block_id not in self._sizes:
                size = float(nbytes if nbytes is not None
                             else (payload.nbytes if payload is not None else 0))
                self.allocate(block_id, size)
            size = self._sizes[block_id]
            if self._dir is not None and payload is not None:
                np.save(self._path(block_id) + ".npy", payload)
                self._store[block_id] = None
            else:
                self._store[block_id] = payload
            if inj is not None and payload is not None:
                self._crc[block_id] = payload_crc(payload)
            return self._charge(size, read=False, mult=mult)

    def read(self, block_id: str) -> Tuple[Optional[np.ndarray], float]:
        """Returns (payload, modelled transfer time).  Raises
        ``TierIOError`` on an injected transient fault and
        ``TierIntegrityError`` when the payload fails its checksum."""
        with self._lock:
            if not self.available:
                raise CapacityError(f"tier {self.spec.name} unavailable")
            if block_id not in self._sizes:
                raise KeyError(block_id)
            inj, mult = self.fault_injector, 1.0
            if inj is not None:
                mult = inj.check_read(self.spec.tier_id, block_id)
            size = self._sizes[block_id]
            payload = self._store.get(block_id)
            if payload is None and self._dir is not None:
                path = self._path(block_id) + ".npy"
                if os.path.exists(path):
                    payload = np.load(path)
            if inj is not None and payload is not None:
                payload = inj.maybe_corrupt(self.spec.tier_id, block_id,
                                            payload)
                self._verify(block_id, payload, self._crc.get(block_id))
            return payload, self._charge(size, read=True, mult=mult)

    def attach_payload(self, block_id: str,
                       payload: Optional[np.ndarray]) -> None:
        """Backfill stored bytes for a block that was allocated
        metadata-first (prompt blocks register before the engine extracts
        their KV arrays from the pool).  Not a modelled I/O: no transfer
        time is charged and no fault is drawn — it only makes later
        demotions/promotions carry (and checksum-gate) real payloads."""
        if payload is None:
            return
        with self._lock:
            if block_id not in self._sizes \
                    or self._store.get(block_id) is not None:
                return
            if self._dir is not None:
                np.save(self._path(block_id) + ".npy", payload)
            else:
                self._store[block_id] = payload
            if self.fault_injector is not None:
                self._crc[block_id] = payload_crc(payload)

    def evict(self, block_id: str) -> None:
        with self._lock:
            if block_id not in self._sizes:
                return
            self._used -= self._sizes.pop(block_id)
            self._store.pop(block_id, None)
            self._crc.pop(block_id, None)
            self.stats.evictions += 1
            if self._dir is not None:
                path = self._path(block_id) + ".npy"
                if os.path.exists(path):
                    os.remove(path)

    def blocks(self) -> List[str]:
        with self._lock:
            return list(self._sizes)

    def size_of(self, block_id: str) -> float:
        return self._sizes[block_id]

    def accrue_byte_hours(self, hours: float) -> None:
        with self._lock:
            self.stats.byte_hours += self._used * hours

    def stats_dict(self) -> dict:
        d = dataclasses_asdict(self.stats)
        d.update(tier=self.spec.name, used=self._used,
                 capacity=self.spec.capacity, available=self.available)
        return d


# ---------------------------------------------------------------------------
# Tier 4: consistent-hash RDMA pool (paper §III-B / §IV / §VII scaling)
# ---------------------------------------------------------------------------
class ConsistentHashRing:
    """Consistent hashing with virtual nodes; O(log n) lookup via bisect.

    Node join/leave remaps only ~1/n of the key space — the property the
    paper leans on for 1024+-node scaling and graceful failure handling.
    """

    def __init__(self, nodes: Sequence[str] = (), vnodes: int = 64):
        self.vnodes = vnodes
        self._ring: List[Tuple[int, str]] = []
        self._nodes: set = set()
        for n in nodes:
            self.add_node(n)

    @staticmethod
    def _hash(key: str) -> int:
        return int.from_bytes(
            hashlib.sha256(key.encode()).digest()[:8], "big")

    def add_node(self, node: str) -> None:
        if node in self._nodes:
            return
        self._nodes.add(node)
        for v in range(self.vnodes):
            h = self._hash(f"{node}#{v}")
            bisect.insort(self._ring, (h, node))

    def remove_node(self, node: str) -> None:
        if node not in self._nodes:
            return
        self._nodes.discard(node)
        self._ring = [(h, n) for h, n in self._ring if n != node]

    def lookup(self, key: str) -> str:
        if not self._ring:
            raise RuntimeError("hash ring empty")
        h = self._hash(key)
        idx = bisect.bisect_right(self._ring, (h, chr(0x10FFFF)))
        if idx == len(self._ring):
            idx = 0
        return self._ring[idx][1]

    @property
    def nodes(self) -> List[str]:
        return sorted(self._nodes)


class RDMATier(TierManager):
    """Distributed block pool across the fabric using a consistent hash
    ring.  Each peer holds a shard; one-sided reads fetch remote blocks.
    Node failure: the ring drops the peer and its displaced blocks are
    re-homed onto the surviving ring (a modelled re-replication write
    per block); blocks are lost only when no peer survives — graceful
    degradation."""

    def __init__(self, spec: TierSpec, nodes: Sequence[str] = ("node0",),
                 vnodes: int = 64):
        super().__init__(spec)
        self.ring = ConsistentHashRing(nodes, vnodes=vnodes)
        self._node_store: Dict[str, Dict[str, float]] = {n: {} for n in nodes}
        self.rehomed_blocks = 0        # fail_node re-replications

    def placement(self, block_id: str) -> str:
        return self.ring.lookup(block_id)

    def read(self, block_id: str) -> Tuple[Optional[np.ndarray], float]:
        inj = self.fault_injector
        if inj is not None:
            inj.maybe_flap(self, "read", block_id)
        return super().read(block_id)

    def write(self, block_id: str, payload: Optional[np.ndarray],
              nbytes: Optional[float] = None) -> float:
        inj = self.fault_injector
        if inj is not None:
            inj.maybe_flap(self, "write", block_id)
        return super().write(block_id, payload, nbytes=nbytes)

    def allocate(self, block_id: str, nbytes: float) -> None:
        super().allocate(block_id, nbytes)
        node = self.placement(block_id)
        self._node_store.setdefault(node, {})[block_id] = nbytes

    def evict(self, block_id: str) -> None:
        for store in self._node_store.values():
            store.pop(block_id, None)
        super().evict(block_id)

    def add_node(self, node: str) -> None:
        self.ring.add_node(node)
        self._node_store.setdefault(node, {})

    def fail_node(self, node: str) -> List[str]:
        """Drop a peer and re-home its displaced blocks through the ring
        onto the survivors (each re-insertion charges one re-replication
        write).  Returns the block ids actually lost — non-empty only
        when the failed peer was the last one."""
        with self._lock:
            self.ring.remove_node(node)
            displaced = list(self._node_store.pop(node, {}))
            lost: List[str] = []
            for bid in displaced:
                if not self.contains(bid):
                    continue
                if not self.ring.nodes:
                    TierManager.evict(self, bid)
                    lost.append(bid)
                    continue
                nbytes = self._sizes[bid]
                survivor = self.ring.lookup(bid)
                self._node_store.setdefault(survivor, {})[bid] = nbytes
                self._charge(nbytes, read=False)   # re-replication write
                self.rehomed_blocks += 1
            return lost

    def node_load(self) -> Dict[str, float]:
        return {n: sum(s.values()) for n, s in self._node_store.items()}


# ---------------------------------------------------------------------------
# Fleet-shared tier-4 namespace (one RDMA pool for every replica)
# ---------------------------------------------------------------------------
class FleetKVStore:
    """One fleet-wide, content-addressed tier-4 namespace.

    The paper treats the RDMA/fabric tier as a *fleet* resource, not a
    per-node spillway: every replica's ``TierHierarchy`` binds a
    ``SharedTierView`` over this store, and blocks are keyed by content
    hash — a popular template's blocks occupy fabric bytes once no
    matter how many replicas registered them.

    Reference counting is per (owner, local block id) mapping: a view's
    allocate acquires one reference, its evict releases it.  A key whose
    refcount reaches zero STAYS resident — it is exactly the cross-
    replica prefix cache — and is reclaimed lazily, oldest-first, only
    under capacity pressure (``_make_room``).  Eviction never touches a
    key with live references, so one replica's teardown can never strand
    or free another replica's blocks.
    """

    def __init__(self, spec: Optional[TierSpec] = None,
                 nodes: Sequence[str] = ("node0", "node1", "node2", "node3"),
                 vnodes: int = 64,
                 fault_injector: Optional[FaultInjector] = None):
        spec = PAPER_TIER_SPECS[4] if spec is None else spec
        self.tier = RDMATier(spec, nodes=nodes, vnodes=vnodes)
        self.tier.fault_injector = fault_injector
        self._refs: Dict[str, int] = {}
        self._lock = threading.RLock()
        self.publishes = 0             # writes that added new bytes
        self.dedup_publishes = 0       # ref bumps on already-resident keys
        self.fetches = 0               # demand payload reads
        self.evicted_cold = 0          # zero-ref keys reclaimed for room

    # -- key namespace ------------------------------------------------------
    def ref_count(self, key: str) -> int:
        with self._lock:
            return self._refs.get(key, 0)

    def contains_key(self, key: str) -> bool:
        return self.tier.contains(key)

    def has_payload(self, key: str) -> bool:
        with self._lock:
            return (self.tier.contains(key)
                    and self.tier._store.get(key) is not None)

    # -- reference lifecycle ------------------------------------------------
    def acquire(self, key: str, payload: Optional[np.ndarray],
                nbytes: float) -> bool:
        """One owner reference on ``key``; bytes are written only if the
        content is not already resident.  Returns True when new bytes
        were written (False: dedup — the fleet already had it)."""
        with self._lock:
            if self.tier.contains(key):
                self._refs[key] = self._refs.get(key, 0) + 1
                if payload is not None and self.tier._store.get(key) is None:
                    self.tier._store[key] = payload
                    if self.tier.fault_injector is not None:
                        self.tier._crc[key] = payload_crc(payload)
                self.dedup_publishes += 1
                return False
            self._make_room(nbytes)
            self.tier.write(key, payload, nbytes=nbytes)
            self._refs[key] = self._refs.get(key, 0) + 1
            self.publishes += 1
            return True

    def put_payload(self, key: str, payload: np.ndarray) -> None:
        with self._lock:
            if self.tier.contains(key) and \
                    self.tier._store.get(key) is None:
                self.tier._store[key] = payload
                if self.tier.fault_injector is not None:
                    self.tier._crc[key] = payload_crc(payload)

    def release(self, key: str) -> None:
        """Drop one owner reference.  Zero-ref keys stay resident (the
        shared prefix cache) until capacity pressure reclaims them."""
        with self._lock:
            n = self._refs.get(key, 0) - 1
            if n <= 0:
                self._refs.pop(key, None)
            else:
                self._refs[key] = n

    def _make_room(self, nbytes: float) -> None:
        """Reclaim zero-ref keys, oldest-first.  Keys with live owner
        references are never evicted — the no-stranded-reference
        invariant the shared-tier tests pin down."""
        if self.tier.free >= nbytes:
            return
        for key in list(self.tier._sizes):
            if self._refs.get(key, 0) == 0:
                self.tier.evict(key)
                self.evicted_cold += 1
                if self.tier.free >= nbytes:
                    return

    # -- data path ----------------------------------------------------------
    def fetch(self, key: str) -> Tuple[Optional[np.ndarray], float]:
        """Demand read of a shared block: (payload, modelled transfer
        seconds), or (None, 0.0) when the key is not resident."""
        with self._lock:
            if not self.tier.contains(key):
                return None, 0.0
            payload, t = self.tier.read(key)
            self.fetches += 1
            return payload, t

    def peek(self, key: str) -> Optional[np.ndarray]:
        """Payload without transfer accounting (intra-owner reads the
        per-view stats already charge)."""
        with self._lock:
            return self.tier._store.get(key)

    def fail_node(self, node: str) -> List[str]:
        return self.tier.fail_node(node)

    def stats(self) -> dict:
        with self._lock:
            return {"keys": len(self.tier._sizes),
                    "used": self.tier.used,
                    "capacity": self.tier.spec.capacity,
                    "live_refs": sum(self._refs.values()),
                    "publishes": self.publishes,
                    "dedup_publishes": self.dedup_publishes,
                    "fetches": self.fetches,
                    "evicted_cold": self.evicted_cold,
                    "rehomed_blocks": self.tier.rehomed_blocks}


class SharedTierView(TierManager):
    """One replica's tier-4 adapter over the ``FleetKVStore``.

    Local block ids translate to fleet keys — the block's content hash
    when the resolver knows it, an owner-scoped fallback otherwise — so
    colliding local ids (every manager names blocks ``blk0, blk1, …``)
    never alias across replicas, while identical *content* always does.

    ``used``/``blocks``/``stats`` are owner-scoped (this replica's
    mappings only): teardown of one replica zeroes ITS view without
    touching bytes other owners still reference.  ``free`` is fleet-wide
    — capacity genuinely is shared — so the demotion cascade sees the
    real pool headroom.
    """

    def __init__(self, store: FleetKVStore, owner: str,
                 resolve_key: Optional[Callable[[str],
                                               Optional[str]]] = None):
        super().__init__(store.tier.spec)
        self.fleet = store
        self.owner = owner
        self._resolve = resolve_key
        self._map: Dict[str, str] = {}     # local bid -> fleet key

    def _key(self, block_id: str) -> str:
        key = self._resolve(block_id) if self._resolve is not None else None
        return key if key else f"{self.owner}:{block_id}"

    @property
    def free(self) -> float:
        return self.fleet.tier.free

    def contains(self, block_id: str) -> bool:
        with self._lock:
            key = self._map.get(block_id)
            return key is not None and self.fleet.contains_key(key)

    def fleet_key(self, block_id: str) -> Optional[str]:
        with self._lock:
            return self._map.get(block_id)

    def allocate(self, block_id: str, nbytes: float) -> None:
        with self._lock:
            if not self.available:
                raise CapacityError(f"tier {self.spec.name} unavailable")
            if block_id in self._map:
                return
            key = self._key(block_id)
            self.fleet.acquire(key, None, nbytes)     # may raise Capacity
            self._map[block_id] = key
            self._sizes[block_id] = nbytes
            self._used += nbytes

    def write(self, block_id: str, payload: Optional[np.ndarray],
              nbytes: Optional[float] = None) -> float:
        with self._lock:
            inj, mult = self.fault_injector, 1.0
            if inj is not None:
                mult = inj.check_write(self.spec.tier_id, block_id)
            key = self._map.get(block_id)
            if key is not None and not self.fleet.contains_key(key):
                # the fleet copy died (total node loss): drop the stale
                # mapping and re-acquire below
                self.evict(block_id)
                key = None
            if key is None:
                size = float(nbytes if nbytes is not None
                             else (payload.nbytes if payload is not None
                                   else 0))
                self.allocate(block_id, size)
                key = self._map[block_id]
            if payload is not None:
                self.fleet.put_payload(key, payload)
            return self._charge(self._sizes[block_id], read=False, mult=mult)

    def read(self, block_id: str) -> Tuple[Optional[np.ndarray], float]:
        with self._lock:
            if not self.available:
                raise CapacityError(f"tier {self.spec.name} unavailable")
            key = self._map.get(block_id)
            if key is None or not self.fleet.contains_key(key):
                raise KeyError(block_id)
            inj, mult = self.fault_injector, 1.0
            if inj is not None:
                mult = inj.check_read(self.spec.tier_id, block_id)
            payload = self.fleet.peek(key)
            if inj is not None and payload is not None:
                payload = inj.maybe_corrupt(self.spec.tier_id, block_id,
                                            payload)
                self._verify(block_id, payload,
                             self.fleet.tier._crc.get(key))
            return payload, self._charge(self._sizes[block_id], read=True,
                                         mult=mult)

    def evict(self, block_id: str) -> None:
        with self._lock:
            key = self._map.pop(block_id, None)
            if key is None:
                return
            self._used -= self._sizes.pop(block_id)
            self._store.pop(block_id, None)
            self.stats.evictions += 1
            self.fleet.release(key)


# ---------------------------------------------------------------------------
# The hierarchy
# ---------------------------------------------------------------------------
class TierHierarchy:
    """Ordered tier stack with promote/demote and failure handling.

    With a ``fault_injector`` attached, every tier's read/write can
    raise ``TierIOError``; the hierarchy wraps its own transfer paths
    (``move`` / ``read_tier`` / ``write_tier``) in the ``RetryPolicy``
    and feeds per-op outcomes to a per-tier health state machine that
    quarantines repeatedly-failing tiers (routing demotions around them
    via the same ``available`` flag ``fail_tier`` uses) and probes them
    back to health.  Without an injector none of this runs — the fault
    layer is completely inert."""

    def __init__(self, specs: Sequence[TierSpec] = PAPER_TIER_SPECS,
                 *, backing_root: Optional[str] = None,
                 rdma_nodes: Sequence[str] = ("node0", "node1", "node2",
                                              "node3"),
                 fault_injector: Optional[FaultInjector] = None,
                 retry_policy: Optional[RetryPolicy] = None,
                 health_config: Optional[HealthConfig] = None):
        self.tiers: List[TierManager] = []
        for spec in specs:
            if spec.tier_id == 4:
                self.tiers.append(RDMATier(spec, nodes=rdma_nodes))
            else:
                backing = (os.path.join(backing_root, spec.name)
                           if backing_root and spec.tier_id >= 3 else None)
                self.tiers.append(TierManager(spec, backing_dir=backing))
        self._lock = threading.RLock()
        self.fault_injector = fault_injector
        for t in self.tiers:
            t.fault_injector = fault_injector
        if retry_policy is None and fault_injector is not None:
            retry_policy = RetryPolicy()
        self.retry_policy = retry_policy
        self._retry_rng = np.random.default_rng(
            retry_policy.seed if retry_policy is not None else 0)
        self.health = TierHealthMonitor(len(self.tiers), health_config)
        self.counters = FaultCounters()
        self.clock = 0.0

    # -- fault-tolerant I/O -------------------------------------------------
    def run_io(self, tier_id: int, fn):
        """Run one tier I/O op under the retry policy + health tracking.

        Transient ``TierIOError``s are retried with modelled backoff
        (virtual seconds accumulated in ``counters.retry_delay_s`` — no
        wall sleeps); integrity errors escalate immediately (the copy is
        corrupt, re-reading cannot help the caller decode it safely);
        exhaustion of the attempt/deadline budget re-raises the last
        error.  ``KeyError``/``CapacityError`` pass through untouched.
        Fast path: with no injector attached this is just ``fn()``."""
        if self.fault_injector is None:
            return fn()
        policy = self.retry_policy
        attempt, cum = 0, 0.0
        while True:
            attempt += 1
            try:
                out = fn()
            except TierIntegrityError:
                with self._lock:
                    self.counters.integrity_failures += 1
                    self._record_health(tier_id, ok=False)
                raise
            except TierIOError:
                with self._lock:
                    self._record_health(tier_id, ok=False)
                    if policy is None or attempt >= policy.max_attempts:
                        self.counters.io_errors += 1
                        raise
                    d = policy.delay(attempt, self._retry_rng)
                    if cum + d > policy.deadline_s:
                        self.counters.io_errors += 1
                        raise
                    cum += d
                    self.counters.retries += 1
                    self.counters.retry_delay_s += d
            else:
                with self._lock:
                    self._record_health(tier_id, ok=True)
                return out

    def _record_health(self, tier_id: int, *, ok: bool) -> None:
        before = self.health.state(tier_id)
        rec = (self.health.record_success if ok
               else self.health.record_failure)
        after = rec(tier_id, self.clock)
        if after == QUARANTINED and before != QUARANTINED:
            # reuse the fail_tier routing: an unavailable tier drops out
            # of locate() and the demotion graph until a probe recovers it
            self.tiers[tier_id].available = False
            self.counters.quarantines += 1

    def read_tier(self, tier_id: int,
                  block_id: str) -> Tuple[Optional[np.ndarray], float]:
        t = self.tiers[tier_id]
        return self.run_io(tier_id, lambda: t.read(block_id))

    def write_tier(self, tier_id: int, block_id: str,
                   payload: Optional[np.ndarray],
                   nbytes: Optional[float] = None) -> float:
        t = self.tiers[tier_id]
        return self.run_io(
            tier_id, lambda: t.write(block_id, payload, nbytes=nbytes))

    def attach_payload(self, block_id: str,
                       payload: Optional[np.ndarray]) -> None:
        """Backfill bytes for a metadata-first block wherever it lives
        (free: no fault draw, no time charged — see TierManager)."""
        tid = self.locate(block_id)
        if tid is not None:
            self.tiers[tid].attach_payload(block_id, payload)

    def tick(self, dt: float = 1.0) -> None:
        """Advance the hierarchy's virtual clock (drives health probes)."""
        self.clock += dt
        if self.fault_injector is not None:
            self.probe_quarantined()

    def probe_quarantined(self) -> None:
        """Issue recovery probes for quarantined tiers whose probe
        interval has elapsed; a successful probe restores routing."""
        with self._lock:
            for t in self.tiers:
                tid = t.spec.tier_id
                if not self.health.due_probe(tid, self.clock):
                    continue
                ok = self._probe_tier(tid)
                self.counters.probes += 1
                st = self.health.probe_result(tid, ok, self.clock)
                if st == HEALTHY:
                    self.restore_tier(tid)
                    self.counters.probe_recoveries += 1

    def _probe_tier(self, tier_id: int) -> bool:
        """One probe round-trip (write + read + evict of a sentinel)
        through the quarantined tier with faults live."""
        t = self.tiers[tier_id]
        probe_id = f"__probe_t{tier_id}__"
        t.available = True
        try:
            t.write(probe_id, None, nbytes=1.0)
            t.read(probe_id)
            return True
        except Exception:                     # noqa: BLE001
            return False
        finally:
            try:
                t.evict(probe_id)
            except Exception:                 # noqa: BLE001
                pass
            t.available = False

    def __getitem__(self, tier_id: int) -> TierManager:
        return self.tiers[tier_id]

    @property
    def n_tiers(self) -> int:
        return len(self.tiers)

    def active_tiers(self) -> List[TierManager]:
        return [t for t in self.tiers if t.available]

    def locate(self, block_id: str) -> Optional[int]:
        """Fastest tier currently holding the block."""
        for t in self.tiers:
            if t.available and t.contains(block_id):
                return t.spec.tier_id
        return None

    def move(self, block_id: str, src: int, dst: int,
             payload: Optional[np.ndarray] = None) -> float:
        """Promote (dst < src) or demote (dst > src); returns modelled
        transfer time (read from src + write to dst)."""
        with self._lock:
            s, d = self.tiers[src], self.tiers[dst]
            if not s.contains(block_id):
                raise KeyError(f"{block_id} not in tier {src}")
            data, t_read = self.run_io(src, lambda: s.read(block_id))
            nbytes = s.size_of(block_id)
            t_write = self.run_io(
                dst, lambda: d.write(block_id, payload if payload is not None
                                     else data, nbytes=nbytes))
            s.evict(block_id)
            return t_read + t_write

    def fail_tier(self, tier_id: int) -> List[str]:
        """Paper §VII: on tier failure, remove it from the promotion/
        demotion graph and redistribute its blocks to adjacent tiers."""
        with self._lock:
            t = self.tiers[tier_id]
            blocks = t.blocks()
            moved, lost = [], []
            for bid in blocks:
                nbytes = t.size_of(bid)
                payload = t._store.get(bid)
                placed = False
                for adj in self._adjacent(tier_id):
                    try:
                        self.tiers[adj].write(bid, payload, nbytes=nbytes)
                        placed = True
                        moved.append(bid)
                        break
                    except CapacityError:
                        continue
                if not placed:
                    lost.append(bid)
                t.evict(bid)
            t.available = False
            return lost

    def restore_tier(self, tier_id: int) -> None:
        self.tiers[tier_id].available = True

    def _adjacent(self, tier_id: int) -> List[int]:
        order = []
        for delta in (1, -1, 2, -2, 3, -3, 4, -4, 5, -5):
            j = tier_id + delta
            if 0 <= j < len(self.tiers) and self.tiers[j].available:
                order.append(j)
        return order

    # -- accounting ---------------------------------------------------------
    def total_cost_dollars(self) -> float:
        return sum(t.stats.byte_hours / GB * t.spec.cost_per_gb_hour
                   for t in self.tiers)

    def capacity_through(self, tier_id: int) -> float:
        """Cumulative capacity of tiers 0..tier_id (paper Table IV col 2)."""
        return sum(t.spec.capacity for t in self.tiers[:tier_id + 1])

    def fault_stats(self) -> dict:
        """Fault-tolerance accounting + injected-fault counts + health."""
        out = dataclasses_asdict(self.counters)
        out["tier_health"] = {t.spec.tier_id:
                              self.health.state(t.spec.tier_id)
                              for t in self.tiers}
        if self.fault_injector is not None:
            out["injected"] = self.fault_injector.stats()
        return out

    def stats(self) -> List[dict]:
        out = []
        for t in self.tiers:
            d = t.stats_dict()
            d["health"] = self.health.state(t.spec.tier_id)
            out.append(d)
        return out


# ---------------------------------------------------------------------------
# Async tier transfers (paper §IV: "transfers overlap compute")
# ---------------------------------------------------------------------------
@dataclass
class TransferRequest:
    """One demotion/promotion/fetch to run off the engine step loop."""
    block_id: str
    src: int
    dst: int
    kind: str = "demote"          # demote | fetch | promote | custom
    payload: Optional[np.ndarray] = None
    nbytes: Optional[float] = None
    tag: str = ""                 # caller correlation key (e.g. request id)
    evict_src: bool = False       # fetch: drop the source copy after reading
    # custom: callable(hierarchy) -> (sim_time, payload | None)
    execute: Optional[Callable] = None
    ticket: int = 0
    timeout_s: Optional[float] = None   # per-transfer wall deadline
    #                                     (None -> worker default)


@dataclass
class TransferEvent:
    request: TransferRequest
    ok: bool
    sim_time: float = 0.0         # modelled transfer seconds (tier specs)
    wall_ms: float = 0.0          # host wall time on the worker thread
    payload: Optional[np.ndarray] = None
    error: Optional[str] = None


class AsyncTierTransferWorker:
    """Background transfer engine: the scheduler submits demotions /
    promotions / fetches and polls completion events, so tier traffic
    never blocks the decode step loop.

    Double-buffered submission: callers append to a staging buffer under
    a light lock; the worker swaps staging <-> active when it goes to
    execute, so submitters never contend with an in-progress transfer.
    A preempted request's payload therefore stays valid in the caller's
    staging copy until the demotion write completes — restores that
    arrive before the write finishes are served from the buffer for free.
    """

    def __init__(self, hierarchy: TierHierarchy, name: str = "kv-transfer",
                 *, fault_injector: Optional[FaultInjector] = None,
                 default_timeout_s: Optional[float] = 30.0):
        self.hierarchy = hierarchy
        self.fault_injector = (fault_injector if fault_injector is not None
                               else hierarchy.fault_injector)
        self.default_timeout_s = default_timeout_s
        self._staging: List[TransferRequest] = []
        self._completed: Deque[TransferEvent] = deque()
        # ticket -> (request, t0_wall, deadline_wall | None): transfers an
        # injected fault stalled forever.  They still count as in-flight
        # until their deadline expires into a failed TransferEvent.
        self._stalled: Dict[int, Tuple[TransferRequest, float,
                                       Optional[float]]] = {}
        self._cv = threading.Condition()
        self._stop = False
        self._inflight = 0
        self._tickets = itertools.count(1)
        self.submitted = 0
        self.completed = 0
        self.failed = 0
        self.timeouts = 0
        self.stalled_total = 0
        self.max_inflight = 0
        self.sim_time_total = 0.0
        self.wall_ms_total = 0.0
        self._thread = threading.Thread(target=self._run, name=name,
                                        daemon=True)
        self._thread.start()

    # -- producer side ------------------------------------------------------
    def submit(self, req: TransferRequest) -> int:
        with self._cv:
            if self._stop:
                raise RuntimeError("transfer worker closed")
            req.ticket = next(self._tickets)
            self._staging.append(req)
            self.submitted += 1
            self._inflight += 1
            self.max_inflight = max(self.max_inflight, self._inflight)
            self._cv.notify_all()
        return req.ticket

    def poll(self) -> List[TransferEvent]:
        """Completion events since the last poll (non-blocking).  Also
        sweeps stalled transfers past their deadline into failed
        events, so the step loop sees timeouts without a worker wakeup."""
        with self._cv:
            self._expire_stalled_locked()
            out = list(self._completed)
            self._completed.clear()
        return out

    def drain(self, timeout: float = 10.0, *, escalate: bool = False) -> bool:
        """Block until every submitted transfer has completed.  With
        ``escalate=True`` the drain deadline is enforced: transfers still
        stalled when it expires are shed as failed ``TransferEvent``s
        (error="transfer timeout") so shutdown can never hang on an
        injected stall.  Returns True when nothing is left in flight."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while self._inflight > 0:
                self._expire_stalled_locked()
                if self._inflight == 0:
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    if escalate:
                        self._expire_stalled_locked(force=True)
                    return self._inflight == 0
                self._cv.wait(min(remaining, 0.05))
            return True

    def _expire_stalled_locked(self, force: bool = False) -> None:
        """Turn stalled transfers whose deadline passed (or all of them,
        with ``force``) into failed completion events.  Caller holds
        ``_cv``."""
        if not self._stalled:
            return
        now = time.monotonic()
        for ticket in list(self._stalled):
            req, t0, dl = self._stalled[ticket]
            if not force and (dl is None or now - t0 < dl):
                continue
            del self._stalled[ticket]
            ev = TransferEvent(req, False, 0.0, (now - t0) * 1e3, None,
                               "transfer timeout")
            self._completed.append(ev)
            self._inflight -= 1
            self.completed += 1
            self.failed += 1
            self.timeouts += 1
        self._cv.notify_all()

    def close(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join(timeout=5.0)

    def stats(self) -> dict:
        with self._cv:
            return {"submitted": self.submitted,
                    "completed": self.completed,
                    "failed": self.failed,
                    "timeouts": self.timeouts,
                    "stalled": len(self._stalled),
                    "stalled_total": self.stalled_total,
                    "in_flight": self._inflight,
                    "max_inflight": self.max_inflight,
                    "sim_time_total": self.sim_time_total,
                    "wall_ms_total": self.wall_ms_total}

    # -- worker side --------------------------------------------------------
    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._staging and not self._stop:
                    if self._stalled:
                        # wake periodically to expire stalled transfers
                        self._cv.wait(0.05)
                        self._expire_stalled_locked()
                    else:
                        self._cv.wait()
                if self._stop and not self._staging:
                    return
                active, self._staging = self._staging, []   # buffer swap
            for req in active:
                inj = self.fault_injector
                if inj is not None and inj.should_stall(
                        req.src, req.block_id, req.kind):
                    with self._cv:
                        dl = (req.timeout_s if req.timeout_s is not None
                              else self.default_timeout_s)
                        self._stalled[req.ticket] = (req, time.monotonic(),
                                                     dl)
                        self.stalled_total += 1
                    continue
                ev = self._execute(req)
                with self._cv:
                    self._completed.append(ev)
                    self._inflight -= 1
                    self.completed += 1
                    if not ev.ok:
                        self.failed += 1
                    self.sim_time_total += ev.sim_time
                    self.wall_ms_total += ev.wall_ms
                    self._cv.notify_all()

    def _execute(self, req: TransferRequest) -> TransferEvent:
        t0 = time.monotonic()
        sim, payload = 0.0, None
        try:
            if req.execute is not None:
                sim, payload = req.execute(self.hierarchy)
            elif req.kind == "demote":
                if self.hierarchy[req.src].contains(req.block_id):
                    sim = self.hierarchy.move(req.block_id, req.src, req.dst,
                                              payload=req.payload)
                else:
                    sim = self.hierarchy.write_tier(
                        req.dst, req.block_id, req.payload,
                        nbytes=req.nbytes)
            elif req.kind == "fetch":
                payload, sim = self.hierarchy.read_tier(req.src,
                                                        req.block_id)
                if req.evict_src:
                    self.hierarchy[req.src].evict(req.block_id)
            elif req.kind == "promote":
                sim = self.hierarchy.move(req.block_id, req.src, req.dst)
            else:
                raise ValueError(f"unknown transfer kind {req.kind!r}")
            return TransferEvent(req, True, sim,
                                 (time.monotonic() - t0) * 1e3, payload)
        except Exception as e:                      # noqa: BLE001
            return TransferEvent(req, False, sim,
                                 (time.monotonic() - t0) * 1e3, None, str(e))
