"""KV caches of the live engine: the paged block-table pool (default)
and the dense per-slot layout (``paged=False`` A/B path).

``PagedKVCache``: KV state lives in a global pool of fixed-size pages on
the engine's device — [L, n_pages, page, Hkv, hd] per K and V, or for
MLA one latent pool [L, n_pages, page, dl+dr] of ``[c_kv ; k_rope]``
rows — and each decode slot owns a block table of page indices; the
paged attention kernels (``kernels/ops.py``) read through that
indirection.  Pages are refcounted (``serving/block_allocator.py``):
radix-prefix hits map the prefix's physical pages straight into the new
request's block table (copy-on-write sharing), and the cache manager
pins the pages of every tier-0-resident prompt block so they survive
request completion.  Writes go into the pool tensors in place
(``index_put_``); page 0 is a reserved scratch page that absorbs the
decode-step writes of inactive slots and the padded tail of every chunk
write.

``SlotKVCache``: the model's contiguous dense state
(``DecoderModel.init_decode_state``: [L, n_slots, max_len, Hkv, hd] per
K and V, or for MLA one latent cache [L, n_slots, max_len, dl+dr], plus
per-slot lengths), one row per decode slot.

Both speak the same engine-facing API (``_KVCacheBase``): acquire /
release / free_slots / set_length, write_prefill / write_range /
inject_block / prefix_kv, extract_block / evict_slot_to_payload /
restore_slot.  Block payloads — the currency of the multi-tier
hierarchy — are numpy arrays [2, L, n, Hkv, hd] (MLA: [1, L, n,
dl+dr]), identical in both layouts.  A bf16 cache hands out ``uint16``
arrays of the bf16 bits (numpy has no bf16 of its own), so ``nbytes``,
checksums and ``np.save`` see the same bytes as the JAX engine's
payloads; a float32 cache hands out float32 arrays.  Copies between
host and device are synchronous: each waits for the stream to drain, and
is an ``engine.sync`` span while a profiler records (``serving/spans.py``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.config import MLA, ModelConfig
from repro_torch.core.tiers import CapacityError
from repro_torch.models.common import resolve_device
from repro_torch.serving.block_allocator import BlockAllocator
from repro_torch.serving.spans import to_device, to_host


@dataclass
class SlotInfo:
    request_id: int = -1
    length: int = 0
    active: bool = False


def payload_from_tensor(t: torch.Tensor) -> np.ndarray:
    """Device tensor -> numpy payload (bf16 travels as uint16 bits)."""
    if t.dtype == torch.bfloat16:
        return to_host(t.contiguous().view(torch.int16)).view(np.uint16)
    return to_host(t)


def tensor_from_payload(a: np.ndarray, device) -> torch.Tensor:
    """numpy payload -> tensor on ``device`` (uint16 means bf16 bits)."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint16:
        return to_device(a.view(np.int16), None, device).view(torch.bfloat16)
    return to_device(a, None, device)


class _KVCacheBase:
    """Slot bookkeeping and payload conversion shared by both layouts.
    Subclasses provide ``kinds`` ((storage key, chunk-state key) pairs
    in payload order), ``device``, ``slots``, ``write_range``,
    ``extract_block`` and ``set_length``."""

    kinds: Tuple[Tuple[str, str], ...]
    slots: List[SlotInfo]

    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if not s.active]

    def acquire(self, request_id: int, length: int) -> int:
        for i, s in enumerate(self.slots):
            if not s.active:
                self.slots[i] = SlotInfo(request_id, length, True)
                return i
        raise RuntimeError("no free slot")

    def advance(self, slot: int) -> None:
        """Post-decode length advance of the host mirror only (the
        decode step already advanced the device-side length, so a cached
        device state stays valid)."""
        self.slots[slot].length += 1

    # ------------------------------------------------------------------
    # payloads and preemption
    # ------------------------------------------------------------------
    def _payload_state(self, payload: np.ndarray) -> Dict:
        return {src: tensor_from_payload(payload[i], self.device)[:, None]
                for i, (_, src) in enumerate(self.kinds)}

    def write_prefill(self, slot: int, state1: Dict, length: int) -> None:
        """Copy a batch-1 prefill state's first ``length`` tokens into
        the slot from position 0."""
        self.write_range(slot, state1, 0, length)
        self.set_length(slot, length)

    def inject_block(self, slot: int, payload: np.ndarray,
                     start: int) -> int:
        """Write one reused block payload at token offset ``start``."""
        n = payload.shape[2]
        self.write_range(slot, self._payload_state(payload), start, n)
        return n

    def write_chunk(self, slot: int, state1: Dict, offset: int,
                    n_tokens: int) -> None:
        """Scatter the first ``n_tokens`` of a prefill chunk's KV at
        token ``offset`` and advance the slot's valid length."""
        self.write_range(slot, state1, offset, n_tokens)
        self.set_length(slot, offset + n_tokens)

    def evict_slot_to_payload(self, slot: int) -> Tuple[np.ndarray, int]:
        """Preemption: extract the whole slot state for tier demotion."""
        length = self.slots[slot].length
        return self.extract_block(slot, 0, length), length

    def restore_slot(self, slot: int, payload: np.ndarray,
                     length: int) -> None:
        self.inject_block(slot, payload, 0)
        self.set_length(slot, length)


class SlotKVCache(_KVCacheBase):
    """Fixed decode slots over the model's contiguous dense state."""

    def __init__(self, model, n_slots: int, max_len: int, device=None):
        cfg: ModelConfig = model.cfg
        self.cfg = cfg
        self.device = resolve_device(device)
        self.n_slots = n_slots
        self.max_len = max_len
        self.state = model.init_decode_state(n_slots, max_len,
                                             device=self.device)
        # (state key, prefill-state key) pairs, in payload order
        self.kinds = ((("latent", "latent"),) if cfg.attention_variant == MLA
                      else (("k", "k"), ("v", "v")))
        self.slots = [SlotInfo() for _ in range(n_slots)]

    def release(self, slot: int) -> None:
        self.slots[slot] = SlotInfo()
        self.state["lengths"][slot] = 0

    def release_storage(self) -> None:
        """Drop the device state (failover teardown)."""
        self.state = {}

    def set_length(self, slot: int, length: int) -> None:
        self.slots[slot].length = length
        self.state["lengths"][slot] = length

    def write_range(self, slot: int, state1: Dict, start: int,
                    n_tokens: int) -> None:
        """Copy a batch-1 KV state into positions [start, start+n)."""
        for key, src in self.kinds:
            dst = self.state[key]
            dst[:, slot, start:start + n_tokens] = \
                state1[src][:, 0, :n_tokens].to(dst.dtype)

    def extract_block(self, slot: int, start: int,
                      n_tokens: int) -> np.ndarray:
        """Slot KV -> block payload [2, L, n_tokens, Hkv, hd] (MLA [1, L,
        n_tokens, dl+dr]), numpy."""
        return payload_from_tensor(torch.stack(
            [self.state[key][:, slot, start:start + n_tokens]
             for key, _ in self.kinds]))

    def prefix_kv(self, slot: int, length: int):
        """The cached prefix (k, v) [L, 1, length, Hkv, hd] (MLA
        (latent,) [L, 1, length, dl+dr]) for the suffix prefill."""
        return tuple(self.state[key][:, slot:slot + 1, :length]
                     for key, _ in self.kinds)


class PagedKVCache(_KVCacheBase):
    """Global page pool + per-slot block tables + CoW prefix sharing.

    Block tables are host numpy ([n_slots, pages_per_slot] int32, 0 =
    unmapped); ``decode_state()`` snapshots them (plus per-slot lengths)
    into device tensors for ``DecoderModel.decode_step_paged``.
    """

    def __init__(self, model, n_slots: int, max_len: int, *,
                 page_tokens: int = 64, reserve_pages: Optional[int] = None,
                 dtype: torch.dtype = torch.bfloat16, device=None):
        cfg: ModelConfig = model.cfg
        self.cfg = cfg
        self.device = resolve_device(device)
        self.n_slots = n_slots
        self.max_len = max_len
        self.page = page_tokens
        self.pages_per_slot = -(-max_len // page_tokens)
        if reserve_pages is None:
            # headroom for manager-pinned prefix blocks that outlive slots
            reserve_pages = max(8, 2 * self.pages_per_slot)
        self.n_pages = 1 + n_slots * self.pages_per_slot + reserve_pages
        self.allocator = BlockAllocator(self.n_pages, reserved=(0,))
        if cfg.attention_variant == MLA:
            # (pool, chunk-state key) pairs, in payload order
            self.kinds = (("latent_pages", "latent"),)
            row = (cfg.d_latent + cfg.d_rope,)
        else:
            self.kinds = (("k_pages", "k"), ("v_pages", "v"))
            row = (max(cfg.n_kv_heads, 1), cfg.hd)
        shape = (cfg.n_layers, self.n_pages, self.page) + row
        self.pools = {pool: torch.zeros(shape, dtype=dtype,
                                        device=self.device)
                      for pool, _ in self.kinds}
        self.tables = np.zeros((n_slots, self.pages_per_slot), np.int32)
        self._mapped = [0] * n_slots           # contiguous mapped page count
        self.slots = [SlotInfo() for _ in range(n_slots)]
        self.block_pages: Dict[str, List[int]] = {}
        # device-state cache for the fused step loop: in steady-state
        # decode (same slot set, no table/length/pool mutation since the
        # last step) the state returned by the previous decode is handed
        # straight back — no table copy, no host->device upload.
        # ``state_version`` is bumped by every host-side mutation that
        # would make the cached snapshot stale.
        self.state_version = 0
        self._cached_state: Optional[Dict] = None
        self._cached_slots: Optional[frozenset] = None
        self._cached_version = -1
        self.state_reuses = 0      # decode_state served from the cache
        self.state_rebuilds = 0    # full snapshot builds

    # ------------------------------------------------------------------
    # slots
    # ------------------------------------------------------------------
    def release(self, slot: int) -> None:
        for pi in range(self._mapped[slot]):
            self.allocator.deref(int(self.tables[slot, pi]))
        self.tables[slot, :] = 0
        self._mapped[slot] = 0
        self.slots[slot] = SlotInfo()
        self.state_version += 1

    def set_length(self, slot: int, length: int) -> None:
        self.slots[slot].length = length
        self.state_version += 1

    def release_storage(self) -> None:
        """Drop the device pools (failover teardown); the host tables
        and page refcounts stay readable."""
        self.pools = {}
        self._cached_state = None

    # ------------------------------------------------------------------
    # page mapping
    # ------------------------------------------------------------------
    def _alloc(self, n: int) -> List[int]:
        """Allocate with backpressure: a full pool first reclaims pages
        pinned for manager blocks (oldest registrations first)."""
        try:
            return self.allocator.alloc(n)
        except CapacityError:
            for bid in list(self.block_pages):
                self.drop_block_pages(bid)
                if self.allocator.n_free >= n:
                    break
            return self.allocator.alloc(n)

    def _ensure_pages(self, slot: int, n_tokens: int) -> None:
        need = -(-n_tokens // self.page)
        cur = self._mapped[slot]
        if need <= cur:
            return
        for i, pid in enumerate(self._alloc(need - cur)):
            self.tables[slot, cur + i] = pid
        self._mapped[slot] = need
        self.state_version += 1

    def ensure_private(self, slot: int, page_index: int) -> None:
        """Copy-on-write: give the slot a private copy of a shared page
        before any write lands on it."""
        pid = int(self.tables[slot, page_index])
        if pid == 0 or self.allocator.refcount(pid) <= 1:
            return
        new = self._alloc(1)[0]
        for arr in self.pools.values():
            arr[:, new] = arr[:, pid]
        self.tables[slot, page_index] = new
        self.allocator.deref(pid)
        self.allocator.note_cow_copy()
        self.state_version += 1

    def ensure_pages_at(self, slot: int, page_indices: Sequence[int]) -> None:
        """Allocate pages for unmapped (hole) table entries among
        ``page_indices`` (segment assembly maps resumed segments beyond
        the contiguous frontier, leaving gap pages at entry 0)."""
        missing = [pi for pi in page_indices
                   if int(self.tables[slot, pi]) == 0]
        if not missing:
            return
        for pi, pid in zip(missing, self._alloc(len(missing))):
            self.tables[slot, pi] = pid
        self._mapped[slot] = max(self._mapped[slot],
                                 max(page_indices) + 1)
        self.state_version += 1

    # ------------------------------------------------------------------
    # CoW prefix sharing with the cache manager
    # ------------------------------------------------------------------
    def can_share(self, block_id: str) -> bool:
        return block_id in self.block_pages

    def share_block(self, slot: int, block_id: str, start: int) -> int:
        """Map a pool-resident block's pages into the slot's table
        (refcount bump — no bytes move).  Returns tokens mapped."""
        pids = self.block_pages[block_id]
        assert start % self.page == 0, "shared blocks must be page-aligned"
        pi0 = start // self.page
        for j, pid in enumerate(pids):
            self.allocator.ref(pid, share=True)
            self.tables[slot, pi0 + j] = pid
        self._mapped[slot] = max(self._mapped[slot], pi0 + len(pids))
        self.state_version += 1
        return len(pids) * self.page

    def register_block_pages(self, block_id: str, slot: int, start: int,
                             n_tokens: int) -> None:
        """Pin the pages backing a newly registered prompt block."""
        if block_id in self.block_pages:
            return
        assert start % self.page == 0 and n_tokens % self.page == 0
        pids = [int(self.tables[slot, pi])
                for pi in range(start // self.page,
                                (start + n_tokens) // self.page)]
        for pid in pids:
            self.allocator.ref(pid)
        self.block_pages[block_id] = pids

    def drop_block_pages(self, block_id: str) -> None:
        for pid in self.block_pages.pop(block_id, ()):
            self.allocator.deref(pid)

    def gc_blocks(self, manager) -> int:
        """Unpin pages of blocks that left tier 0."""
        dropped = 0
        for bid in list(self.block_pages):
            if bid not in manager.metas or manager.hierarchy.locate(bid) != 0:
                self.drop_block_pages(bid)
                dropped += 1
        return dropped

    # ------------------------------------------------------------------
    # writes
    # ------------------------------------------------------------------
    def _scatter(self, state1: Dict, pids: np.ndarray,
                 offs: np.ndarray) -> None:
        """Write ``state1``'s [L, 1, W, ...] KV (or latent) into every pool
        at (pids[w], offs[w]), in place.  Entries past the valid count
        point at scratch page 0."""
        pid_t = to_device(pids, torch.long, self.device)
        off_t = to_device(offs, torch.long, self.device)
        for key, src in self.kinds:
            pool = self.pools[key]
            pool[:, pid_t, off_t] = state1[src][:, 0].to(pool.dtype)
        self.state_version += 1

    def write_range(self, slot: int, state1: Dict, start: int,
                    n_tokens: int) -> None:
        """Scatter a batch-1 KV (or latent) state into positions
        [start, start+n), allocating (and CoW-privatizing) pages as
        needed.  The index arrays span the data buffer's full width,
        with entries past ``n_tokens`` directed at scratch page 0."""
        self._ensure_pages(slot, start + n_tokens)
        for pi in range(start // self.page,
                        (start + n_tokens - 1) // self.page + 1):
            self.ensure_private(slot, pi)
        width = state1[self.kinds[0][1]].shape[2]
        pos = np.arange(start, start + n_tokens)
        pids = np.zeros(width, np.int64)
        offs = np.zeros(width, np.int64)
        pids[:n_tokens] = self.tables[slot, pos // self.page]
        offs[:n_tokens] = pos % self.page
        self._scatter(state1, pids, offs)

    def write_chunk_positions(self, slot: int, state1: Dict,
                              positions: Sequence[int]) -> None:
        """Scatter the first ``len(positions)`` tokens of a segment-
        prefill chunk at the given ascending (possibly non-contiguous)
        absolute positions.  Does NOT advance the slot length."""
        n = len(positions)
        if n == 0:
            return
        pos = np.asarray(positions, np.int64)
        touched = sorted({int(p) for p in pos // self.page})
        self.ensure_pages_at(slot, touched)
        for pi in touched:
            self.ensure_private(slot, pi)
        width = state1[self.kinds[0][1]].shape[2]
        pids = np.zeros(width, np.int64)
        offs = np.zeros(width, np.int64)
        pids[:n] = self.tables[slot, pos // self.page]
        offs[:n] = pos % self.page
        self._scatter(state1, pids, offs)

    # ------------------------------------------------------------------
    # reads
    # ------------------------------------------------------------------
    def _gather(self, key: str, slot: int, start: int,
                n_tokens: int) -> torch.Tensor:
        """Pool pages -> contiguous [L, n_tokens, ...]."""
        p0 = start // self.page
        p1 = (start + n_tokens - 1) // self.page
        pids = to_device(self.tables[slot, p0:p1 + 1], torch.long,
                         self.device)
        arr = self.pools[key][:, pids]              # [L, np, page, ...]
        flat = arr.reshape((arr.shape[0], -1) + arr.shape[3:])
        rel = start - p0 * self.page
        return flat[:, rel:rel + n_tokens]

    def extract_block(self, slot: int, start: int,
                      n_tokens: int) -> np.ndarray:
        """Slot KV -> block payload [2, L, n_tokens, Hkv, hd] (MLA:
        [1, L, n_tokens, dl+dr]), numpy."""
        kv = torch.stack([self._gather(pool, slot, start, n_tokens)
                          for pool, _ in self.kinds])
        return payload_from_tensor(kv)

    def prefix_kv(self, slot: int, length: int):
        """The cached prefix [L, 1, length, ...] per pool ((k, v), MLA
        (latent,)) for the suffix prefill."""
        return tuple(self._gather(pool, slot, 0, length)[:, None]
                     for pool, _ in self.kinds)

    # ------------------------------------------------------------------
    # decode-step interface
    # ------------------------------------------------------------------
    def _prepare_decode_pages(self, include: Optional[set]) -> None:
        """Guarantee every decoding slot a private page for the incoming
        token, with one allocator call for the whole step."""
        needs = []
        for i, s in enumerate(self.slots):
            if not s.active or (include is not None and i not in include):
                continue
            need = -(-(s.length + 1) // self.page) - self._mapped[i]
            if need > 0:
                needs.append((i, need))
        if needs:
            pids = self._alloc(sum(n for _, n in needs))
            j = 0
            for i, need in needs:
                cur = self._mapped[i]
                for t in range(need):
                    self.tables[i, cur + t] = pids[j]
                    j += 1
                self._mapped[i] = cur + need
            self.state_version += 1
        for i, s in enumerate(self.slots):
            if not s.active or (include is not None and i not in include):
                continue
            self.ensure_private(i, s.length // self.page)

    def decode_state(self, decode_slots: Optional[Sequence[int]] = None,
                     reuse: bool = False) -> Dict:
        """Snapshot for ``decode_step_paged``.  Excluded rows get a
        zeroed block table and length 0, so their KV write lands on the
        scratch page.  ``reuse=True``: when the previous step's returned
        state covers the same slot set and nothing changed host-side
        since (``state_version``), hand it straight back."""
        include = (None if decode_slots is None else set(decode_slots))
        self._prepare_decode_pages(include)
        if reuse and include is not None:
            key = frozenset(include)
            if (self._cached_state is not None
                    and self._cached_slots == key
                    and self._cached_version == self.state_version):
                state = self._cached_state
                self._cached_state = None
                self.state_reuses += 1
                return state
        self.state_rebuilds += 1
        tables = self.tables
        lengths = np.asarray(
            [s.length if s.active and (include is None or i in include)
             else 0 for i, s in enumerate(self.slots)], np.int32)
        if include is not None:
            tables = tables.copy()
            for i in range(self.n_slots):
                if i not in include:
                    tables[i, :] = 0
        state = dict(self.pools)
        # copies: the host tables keep changing after the snapshot
        state["block_tables"] = to_device(tables, None, self.device)
        state["lengths"] = to_device(lengths, None, self.device)
        return state

    def chunk_state(self, slot: int) -> Dict:
        """Snapshot for ``prefill_chunk``: the page pools plus this
        slot's block-table row (batch dim 1)."""
        state = dict(self.pools)
        state["block_table"] = to_device(self.tables[slot:slot + 1], None,
                                         self.device)
        return state

    def absorb(self, new_state: Dict,
               decode_slots: Optional[Sequence[int]] = None) -> None:
        """Take back the state after a decode step (the pools were
        updated in place).  With ``decode_slots`` the whole returned
        state — tables and per-row lengths already advanced on device —
        is cached for ``decode_state(reuse=True)`` next step."""
        for key in self.pools:
            self.pools[key] = new_state[key]
        self.state_version += 1
        if decode_slots is not None:
            self._cached_state = new_state
            self._cached_slots = frozenset(decode_slots)
            self._cached_version = self.state_version
        else:
            self._cached_state = None
