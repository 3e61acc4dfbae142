"""Deterministic fault injection and fault tolerance for the tier stack.

The paper (§VII) claims the six-tier hierarchy "maintains correctness
under tier failure and degraded fabric conditions", but clean membership
events (``fail_tier`` / ``fail_node``) are the easy half: real NVMe,
RDMA fabric, and parallel-filesystem tiers exhibit *transient* I/O
errors, latency brownouts, silent bit flips, and node flaps.  This
module provides the machinery the hierarchy uses to survive them:

  * ``FaultInjector`` — a seeded, per-tier fault model.  Attached via
    ``TierHierarchy(fault_injector=...)`` it makes ``TierManager.read/
    write`` (and the RDMA / fleet-shared subclasses) raise typed
    ``TierIOError``s, inflate transfer times during brownouts, flip
    payload bits, and flap RDMA ring nodes — all driven by one seeded
    RNG so a chaos run replays bit-identically.  When no injector is
    attached every hook is skipped entirely: the fault layer is inert.
  * ``RetryPolicy`` — bounded attempts, exponential backoff with
    deterministic seeded jitter, and a per-op delay deadline.  Backoff
    delays are *modelled* virtual seconds (accumulated by the caller),
    never wall-clock sleeps, so trace replay stays fast.
  * crc32 payload checksums (``payload_crc``) written at demote/publish
    time and verified on read/import — corruption is detected and
    converted to a miss (``TierIntegrityError``), never decoded.
  * ``TierHealthMonitor`` — a per-tier health state machine
    (healthy → degraded → quarantined → probing) that drives the
    hierarchy's route-around-sick-tiers behavior through the same
    ``available`` flag the ``fail_tier``/``restore_tier`` plumbing uses.
"""
from __future__ import annotations

import threading
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

__all__ = [
    "TierIOError", "TierIntegrityError", "FaultProfile", "FaultInjector",
    "RetryPolicy", "FaultCounters", "HealthConfig", "TierHealthMonitor",
    "payload_crc", "HEALTHY", "DEGRADED", "QUARANTINED", "PROBING",
]


# ---------------------------------------------------------------------------
# Typed errors
# ---------------------------------------------------------------------------
class TierIOError(RuntimeError):
    """A tier I/O operation failed (injected transient error, node flap,
    or transfer timeout).  Retryable unless it is a ``TierIntegrityError``."""

    def __init__(self, tier_id: int, op: str, block_id: str,
                 kind: str = "transient", detail: str = ""):
        self.tier_id = tier_id
        self.op = op
        self.block_id = block_id
        self.kind = kind
        msg = f"tier {tier_id} {op} {block_id!r}: {kind}"
        if detail:
            msg += f" ({detail})"
        super().__init__(msg)


class TierIntegrityError(TierIOError):
    """Payload failed its crc32 check on read — the copy is corrupt.
    Never retried: callers convert it to a miss and recompute."""

    def __init__(self, tier_id: int, op: str, block_id: str,
                 detail: str = ""):
        super().__init__(tier_id, op, block_id, kind="corruption",
                         detail=detail)


# ---------------------------------------------------------------------------
# Checksums
# ---------------------------------------------------------------------------
def payload_crc(payload: np.ndarray) -> int:
    """crc32 over the payload bytes (dtype-agnostic)."""
    return zlib.crc32(np.ascontiguousarray(payload).tobytes())


# ---------------------------------------------------------------------------
# Fault model
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class FaultProfile:
    """Per-tier fault rates.  All probabilities are per-operation."""
    read_error_rate: float = 0.0     # transient read failure
    write_error_rate: float = 0.0    # transient write failure
    corruption_rate: float = 0.0     # in-flight bit flip on read payloads
    brownout_rate: float = 0.0       # op lands in a latency brownout
    brownout_latency_mult: float = 10.0   # transfer-time multiplier then
    stall_rate: float = 0.0          # async transfer never completes
    flap_rate: float = 0.0           # RDMA tiers: ring node drops + rejoins

    @property
    def any_faults(self) -> bool:
        return (self.read_error_rate > 0 or self.write_error_rate > 0
                or self.corruption_rate > 0 or self.brownout_rate > 0
                or self.stall_rate > 0 or self.flap_rate > 0)


class FaultInjector:
    """Seeded per-tier fault source.

    One RNG drives every probabilistic decision, so a single seed
    reproduces an entire chaos run.  Tiers without a profile draw
    nothing — the op-ordering of a fault-free tier is untouched.
    Thread-safe: the worker thread and the step loop share the stream
    under a lock (cross-thread interleaving is the one nondeterminism
    async mode already has).
    """

    def __init__(self, profiles: Dict[int, FaultProfile], seed: int = 0):
        self.profiles = dict(profiles)
        self.seed = seed
        self.enabled = True
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()
        self._forced_stalls: set = set()      # block ids stalled forever
        self._forced_corruptions: set = set()  # block ids corrupted once
        self.read_brownouts_by_tier: Dict[int, int] = {}
        self.counters: Dict[str, int] = {
            "injected_read_errors": 0,
            "injected_write_errors": 0,
            "injected_corruptions": 0,
            "injected_brownouts": 0,
            "injected_stalls": 0,
            "injected_flaps": 0,
        }

    # -- targeted faults (tests / smoke) ------------------------------------
    def force_stall(self, block_id: str) -> None:
        """Stall every async transfer of ``block_id`` forever."""
        self._forced_stalls.add(block_id)

    def clear_stall(self, block_id: str) -> None:
        self._forced_stalls.discard(block_id)

    def force_corrupt(self, block_id: str) -> None:
        """Corrupt the next read of ``block_id`` (one-shot)."""
        self._forced_corruptions.add(block_id)

    # -- probabilistic hooks ------------------------------------------------
    def _draw(self) -> float:
        with self._lock:
            return float(self._rng.random())

    def _bump(self, key: str) -> None:
        with self._lock:
            self.counters[key] += 1

    def check_read(self, tier_id: int, block_id: str) -> float:
        """Raises ``TierIOError`` on an injected transient read error;
        otherwise returns the transfer-time multiplier (>1 in brownout)."""
        prof = self.profiles.get(tier_id)
        if prof is None or not self.enabled:
            return 1.0
        if prof.read_error_rate > 0 and self._draw() < prof.read_error_rate:
            self._bump("injected_read_errors")
            raise TierIOError(tier_id, "read", block_id)
        if prof.brownout_rate > 0 and self._draw() < prof.brownout_rate:
            self._bump("injected_brownouts")
            with self._lock:
                # read brownouts stall demand fetches (write brownouts
                # land on async demotions, which overlap compute) — the
                # replay's stall model charges these per tier
                self.read_brownouts_by_tier[tier_id] = (
                    self.read_brownouts_by_tier.get(tier_id, 0) + 1)
            return prof.brownout_latency_mult
        return 1.0

    def check_write(self, tier_id: int, block_id: str) -> float:
        prof = self.profiles.get(tier_id)
        if prof is None or not self.enabled:
            return 1.0
        if prof.write_error_rate > 0 and self._draw() < prof.write_error_rate:
            self._bump("injected_write_errors")
            raise TierIOError(tier_id, "write", block_id)
        if prof.brownout_rate > 0 and self._draw() < prof.brownout_rate:
            self._bump("injected_brownouts")
            return prof.brownout_latency_mult
        return 1.0

    def maybe_corrupt(self, tier_id: int, block_id: str,
                      payload: np.ndarray) -> np.ndarray:
        """Possibly flip one bit in a COPY of the payload (the stored
        bytes stay intact — this models an in-flight/readback flip).
        The returned copy will fail its crc check."""
        if not self.enabled:
            return payload
        forced = block_id in self._forced_corruptions
        prof = self.profiles.get(tier_id)
        if not forced and (prof is None or prof.corruption_rate <= 0
                           or self._draw() >= prof.corruption_rate):
            return payload
        self._forced_corruptions.discard(block_id)
        self._bump("injected_corruptions")
        buf = np.array(payload, copy=True)
        flat = buf.reshape(-1).view(np.uint8)
        with self._lock:
            idx = int(self._rng.integers(0, flat.size)) if flat.size else 0
        if flat.size:
            flat[idx] ^= 0x01
        return buf

    def should_stall(self, tier_id: int, block_id: str,
                     kind: str = "") -> bool:
        """Async transfer worker hook: should this transfer hang?"""
        if not self.enabled:
            return False
        if block_id in self._forced_stalls:
            self._bump("injected_stalls")
            return True
        prof = self.profiles.get(tier_id)
        if prof is None or prof.stall_rate <= 0:
            return False
        if self._draw() < prof.stall_rate:
            self._bump("injected_stalls")
            return True
        return False

    def maybe_flap(self, tier, op: str, block_id: str) -> None:
        """RDMA tiers: with ``flap_rate`` probability drop one ring node
        (its blocks re-home onto survivors) and immediately rejoin it,
        failing the in-flight op with a transient ``TierIOError``."""
        if not self.enabled:
            return
        prof = self.profiles.get(tier.spec.tier_id)
        if prof is None or prof.flap_rate <= 0:
            return
        if self._draw() >= prof.flap_rate:
            return
        nodes = tier.ring.nodes
        if len(nodes) <= 1:
            return                      # never flap the last node
        with self._lock:
            node = nodes[int(self._rng.integers(0, len(nodes)))]
        tier.fail_node(node)
        tier.add_node(node)
        self._bump("injected_flaps")
        raise TierIOError(tier.spec.tier_id, op, block_id, kind="flap",
                          detail=f"node {node} flapped")

    def stats(self) -> dict:
        with self._lock:
            return dict(self.counters)


# ---------------------------------------------------------------------------
# Retry policy
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class RetryPolicy:
    """Bounded retries with exponential backoff and deterministic jitter.

    Delays are *modelled* seconds (virtual time) — the caller accumulates
    them into its transfer accounting; nothing sleeps.  Escalation
    happens on whichever bound trips first: ``max_attempts`` total tries
    or cumulative backoff delay exceeding ``deadline_s``.
    """
    max_attempts: int = 4
    base_delay_s: float = 1e-3
    backoff_mult: float = 2.0
    jitter_frac: float = 0.25
    deadline_s: float = 0.25
    seed: int = 0

    def delay(self, attempt: int,
              rng: Optional[np.random.Generator] = None) -> float:
        """Backoff delay after the ``attempt``-th failed try (1-based)."""
        d = self.base_delay_s * self.backoff_mult ** (attempt - 1)
        if self.jitter_frac > 0 and rng is not None:
            d *= 1.0 + self.jitter_frac * (2.0 * float(rng.random()) - 1.0)
        return d

    def schedule(self) -> List[float]:
        """The full deterministic backoff schedule for one op under this
        policy's seed: delays after failed attempts 1..max_attempts-1,
        truncated where the cumulative delay would cross the deadline."""
        rng = np.random.default_rng(self.seed)
        out: List[float] = []
        cum = 0.0
        for attempt in range(1, self.max_attempts):
            d = self.delay(attempt, rng)
            if cum + d > self.deadline_s:
                break
            cum += d
            out.append(d)
        return out


@dataclass
class FaultCounters:
    """Hierarchy-level fault-tolerance accounting (one per hierarchy)."""
    retries: int = 0                 # transient errors absorbed by retry
    io_errors: int = 0               # ops that exhausted the retry budget
    integrity_failures: int = 0      # corrupt payloads caught by checksum
    retry_delay_s: float = 0.0       # modelled backoff delay (virtual s)
    probes: int = 0                  # recovery probes of quarantined tiers
    probe_recoveries: int = 0        # probes that restored routing
    quarantines: int = 0             # health transitions into quarantine


# ---------------------------------------------------------------------------
# Per-tier health state machine
# ---------------------------------------------------------------------------
HEALTHY = "healthy"
DEGRADED = "degraded"
QUARANTINED = "quarantined"
PROBING = "probing"


@dataclass(frozen=True)
class HealthConfig:
    degraded_after: int = 3          # consecutive failures -> degraded
    quarantine_after: int = 8        # consecutive failures -> quarantined
    recover_successes: int = 3       # consecutive successes -> healthy
    probe_interval: float = 25.0     # virtual seconds between probes


class TierHealthMonitor:
    """healthy → degraded → quarantined → probing state machine.

    Pure bookkeeping: the hierarchy feeds it per-op outcomes and acts on
    the returned state (flipping ``available`` to route traffic around
    quarantined tiers).  The only path out of quarantine is a successful
    recovery probe — ``probe_result(tid, True)`` — so a sick tier can
    never silently rejoin the demotion graph.
    """

    def __init__(self, n_tiers: int, config: Optional[HealthConfig] = None):
        self.cfg = config or HealthConfig()
        self._state: Dict[int, str] = {i: HEALTHY for i in range(n_tiers)}
        self._fails: Dict[int, int] = {i: 0 for i in range(n_tiers)}
        self._oks: Dict[int, int] = {i: 0 for i in range(n_tiers)}
        self._quarantined_at: Dict[int, float] = {}
        self.quarantines = 0
        self.recoveries = 0

    def state(self, tier_id: int) -> str:
        return self._state.get(tier_id, HEALTHY)

    def as_dict(self) -> Dict[int, str]:
        return dict(self._state)

    def record_failure(self, tier_id: int, now: float = 0.0) -> str:
        st = self._state.get(tier_id, HEALTHY)
        if st in (QUARANTINED, PROBING):
            return st
        self._oks[tier_id] = 0
        self._fails[tier_id] = self._fails.get(tier_id, 0) + 1
        if self._fails[tier_id] >= self.cfg.quarantine_after:
            self._state[tier_id] = QUARANTINED
            self._quarantined_at[tier_id] = now
            self._fails[tier_id] = 0
            self.quarantines += 1
        elif self._fails[tier_id] >= self.cfg.degraded_after:
            self._state[tier_id] = DEGRADED
        return self._state[tier_id]

    def record_success(self, tier_id: int, now: float = 0.0) -> str:
        st = self._state.get(tier_id, HEALTHY)
        if st in (QUARANTINED, PROBING):
            return st
        self._fails[tier_id] = 0
        self._oks[tier_id] = self._oks.get(tier_id, 0) + 1
        if st == DEGRADED and self._oks[tier_id] >= self.cfg.recover_successes:
            self._state[tier_id] = HEALTHY
        return self._state[tier_id]

    def due_probe(self, tier_id: int, now: float) -> bool:
        """True (and transitions to PROBING) when a quarantined tier's
        probe interval has elapsed."""
        if self._state.get(tier_id) != QUARANTINED:
            return False
        if now - self._quarantined_at.get(tier_id, 0.0) < \
                self.cfg.probe_interval:
            return False
        self._state[tier_id] = PROBING
        return True

    def probe_result(self, tier_id: int, ok: bool, now: float = 0.0) -> str:
        """Outcome of a recovery probe.  Success is the ONLY transition
        out of quarantine; failure re-quarantines with a fresh timer."""
        if self._state.get(tier_id) != PROBING:
            return self._state.get(tier_id, HEALTHY)
        if ok:
            self._state[tier_id] = HEALTHY
            self._fails[tier_id] = 0
            self._oks[tier_id] = 0
            self._quarantined_at.pop(tier_id, None)
            self.recoveries += 1
        else:
            self._state[tier_id] = QUARANTINED
            self._quarantined_at[tier_id] = now
        return self._state[tier_id]
