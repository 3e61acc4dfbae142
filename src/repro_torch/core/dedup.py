"""Content-addressable deduplication (paper §III-F).

Three cooperating indexes:

  * a SHA-256 **content store** with reference counting — identical KV
    blocks (system prompts, few-shot examples, tool descriptions repeated
    verbatim) are stored once;
  * a **radix tree** over token-id sequences for longest-prefix matching —
    a new request reuses every cached block along its longest matched
    prefix (this is what converts dedup hits into skipped prefill compute);
  * a **segment index** keying every registered block by its salted
    content digest independent of prompt position, so a prefix match
    that diverges mid-prompt (history truncation shifting blocks left)
    can *resume* on contiguous content past the divergent span.

Checkpoint persistence to Tier 5 uses delta-encoding: a manifest
references already-present blocks by hash and only ships new ones
(paper Table VI: 10-30% savings).
"""
from __future__ import annotations

import bisect
import hashlib
import threading
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

import numpy as np


def content_hash(tokens: Sequence[int], salt: str = "") -> str:
    """SHA-256 over the block's token ids (+ model salt so equal token
    blocks from different models never alias)."""
    h = hashlib.sha256()
    if salt:
        h.update(salt.encode())
    h.update(np.asarray(tokens, dtype=np.int32).tobytes())
    return h.hexdigest()


def payload_hash(arr: np.ndarray) -> str:
    h = hashlib.sha256()
    h.update(str(arr.dtype).encode())
    h.update(str(arr.shape).encode())
    h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# Reference-counted content store
# ---------------------------------------------------------------------------
class ContentStore:
    """hash -> (block_id, refcount).  The first writer owns the canonical
    block; later identical blocks just bump the refcount."""

    def __init__(self):
        self._by_hash: Dict[str, str] = {}
        self._refs: Dict[str, int] = {}
        self._lock = threading.RLock()
        self.dedup_hits = 0
        self.inserts = 0

    def intern(self, h: str, block_id: str) -> Tuple[str, bool]:
        """Returns (canonical_block_id, was_duplicate)."""
        with self._lock:
            if h in self._by_hash:
                canonical = self._by_hash[h]
                self._refs[canonical] += 1
                self.dedup_hits += 1
                return canonical, True
            self._by_hash[h] = block_id
            self._refs[block_id] = 1
            self.inserts += 1
            return block_id, False

    def contains_hash(self, h: str) -> bool:
        with self._lock:
            return h in self._by_hash

    def lookup(self, h: str) -> Optional[str]:
        """Canonical block id for ``h`` (None if never interned) —
        without touching the refcount."""
        with self._lock:
            return self._by_hash.get(h)

    def refcount(self, block_id: str) -> int:
        with self._lock:
            return self._refs.get(block_id, 0)

    def release(self, h: str) -> Optional[str]:
        """Drop one reference; returns the block_id to free if it hit 0."""
        with self._lock:
            canonical = self._by_hash.get(h)
            if canonical is None:
                return None
            self._refs[canonical] -= 1
            if self._refs[canonical] <= 0:
                del self._refs[canonical]
                del self._by_hash[h]
                return canonical
            return None

    def stats(self) -> dict:
        with self._lock:
            return {"unique_blocks": len(self._by_hash),
                    "dedup_hits": self.dedup_hits,
                    "inserts": self.inserts}


# ---------------------------------------------------------------------------
# Radix tree over token sequences (prefix reuse across requests)
# ---------------------------------------------------------------------------
@dataclass
class RadixNode:
    edge: Tuple[int, ...] = ()
    children: Dict[Tuple, "RadixNode"] = field(default_factory=dict)
    block_ids: List[str] = field(default_factory=list)   # blocks along edge
    hits: int = 0


class RadixTree:
    """Compressed trie over token ids, block-granular.

    Insertion registers a request's token prefix as a chain of blocks;
    ``match`` returns the cached block ids covering the longest shared
    block-aligned prefix of a new request.  Lookup is O(matched tokens);
    the paper quotes <1 us per block which holds here (see benchmarks).
    """

    def __init__(self, block_tokens: int):
        self.block_tokens = block_tokens
        self.root = RadixNode()
        self._lock = threading.RLock()

    def _blocks_of(self, tokens: Sequence[int]) -> List[Tuple[int, ...]]:
        bt = self.block_tokens
        n = (len(tokens) // bt) * bt
        return [tuple(tokens[i:i + bt]) for i in range(0, n, bt)]

    def insert(self, tokens: Sequence[int], block_ids: Sequence[str]) -> None:
        """Register full blocks of `tokens` mapped 1:1 onto `block_ids`."""
        blocks = self._blocks_of(tokens)
        assert len(block_ids) >= len(blocks), "one block id per full block"
        with self._lock:
            node = self.root
            for blk, bid in zip(blocks, block_ids):
                child = node.children.get(blk)   # keyed by full block
                if child is not None:
                    node = child
                    if bid not in node.block_ids:
                        node.block_ids.append(bid)
                else:
                    nxt = RadixNode(edge=blk, block_ids=[bid])
                    node.children[blk] = nxt
                    node = nxt

    def match(self, tokens: Sequence[int]) -> List[str]:
        """Longest block-aligned prefix match -> canonical block ids."""
        out: List[str] = []
        with self._lock:
            node = self.root
            for blk in self._blocks_of(tokens):
                child = node.children.get(blk)
                if child is None or not child.block_ids:
                    break
                child.hits += 1
                out.append(child.block_ids[0])
                node = child
        return out

    def probe(self, tokens: Sequence[int]) -> List[str]:
        """Non-mutating ``match``: the same longest-prefix walk without
        bumping hit counters.  The prefix-aware router polls EVERY
        replica's tree per routed request; probing must not skew the
        hotness signal the eviction policies read."""
        out: List[str] = []
        with self._lock:
            node = self.root
            for blk in self._blocks_of(tokens):
                child = node.children.get(blk)
                if child is None or not child.block_ids:
                    break
                out.append(child.block_ids[0])
                node = child
        return out

    def remove_block(self, block_id: str) -> None:
        """Unregister an evicted block everywhere (rare; full walk)."""
        with self._lock:
            stack = [self.root]
            while stack:
                n = stack.pop()
                for c in n.children.values():
                    if block_id in c.block_ids:
                        c.block_ids.remove(block_id)
                    stack.append(c)

    def size(self) -> int:
        count = 0
        stack = [self.root]
        while stack:
            n = stack.pop()
            count += len(n.children)
            stack.extend(n.children.values())
        return count


# ---------------------------------------------------------------------------
# Segment index: position-independent content lookup (resume past divergence)
# ---------------------------------------------------------------------------
@dataclass
class SegmentMatch:
    """One resumed run of content-matched blocks within a query prompt."""
    start_block: int                 # block index into the query's prompt
    block_ids: List[str]             # canonical block id per matched block

    @property
    def n_blocks(self) -> int:
        return len(self.block_ids)

    @property
    def end_block(self) -> int:
        return self.start_block + len(self.block_ids)


class SegmentIndex:
    """Content-digest index over block *segments*.

    The radix tree can only reuse the longest contiguous prefix: one
    divergent block (history truncation shifting the conversation left)
    loses everything after it.  This index keys every registered full
    block by its salted content digest with no positional context, so a
    match can **resume** after a divergent span: ``match`` scans a
    query's full blocks from a given block index and groups consecutive
    digest hits into maximal segments — non-overlapping and in prompt
    order by construction, one lookup per scanned block.

    Index contents are a pure function of the inserted
    (digest, block id) pairs: per digest the ids are kept sorted and
    ``lookup`` returns the smallest, so the index is invariant to
    session insertion order under a fixed salt.
    """

    def __init__(self, block_tokens: int, salt: str = "",
                 min_blocks: int = 1):
        self.block_tokens = block_tokens
        self.salt = salt
        self.min_blocks = max(1, min_blocks)
        self._by_digest: Dict[str, List[str]] = {}   # digest -> sorted ids
        self._digests_of: Dict[str, Set[str]] = {}   # block id -> digests
        self._lock = threading.RLock()
        self.lookups = 0
        self.hits = 0

    def block_digest(self, tokens: Sequence[int]) -> str:
        """Digest of one full block's token ids under the index salt."""
        assert len(tokens) == self.block_tokens, "full blocks only"
        return content_hash(tokens, salt=self.salt)

    def _blocks_of(self, tokens: Sequence[int]) -> List[Sequence[int]]:
        bt = self.block_tokens
        n = (len(tokens) // bt) * bt
        return [tokens[i:i + bt] for i in range(0, n, bt)]

    def insert_block(self, tokens: Sequence[int], block_id: str,
                     digest: Optional[str] = None) -> str:
        """Register one full block; returns its digest (computed from
        ``tokens`` unless the caller already has it)."""
        d = digest if digest is not None else self.block_digest(tokens)
        with self._lock:
            ids = self._by_digest.setdefault(d, [])
            if block_id not in ids:
                bisect.insort(ids, block_id)
            self._digests_of.setdefault(block_id, set()).add(d)
        return d

    def insert_sequence(self, tokens: Sequence[int],
                        block_ids: Sequence[str]) -> None:
        """Register every full block of ``tokens`` mapped 1:1 onto
        ``block_ids`` (same contract as ``RadixTree.insert``)."""
        blocks = self._blocks_of(tokens)
        assert len(block_ids) >= len(blocks), "one block id per full block"
        for blk, bid in zip(blocks, block_ids):
            self.insert_block(blk, bid)

    def lookup(self, digest: str) -> Optional[str]:
        """Canonical (smallest) block id registered for ``digest``."""
        with self._lock:
            ids = self._by_digest.get(digest)
            return ids[0] if ids else None

    def remove_block(self, block_id: str) -> None:
        """Unregister an evicted block from every digest it backed."""
        with self._lock:
            for d in self._digests_of.pop(block_id, ()):
                ids = self._by_digest.get(d)
                if ids is None:
                    continue
                try:
                    ids.remove(block_id)
                except ValueError:
                    pass
                if not ids:
                    del self._by_digest[d]

    def match(self, tokens: Sequence[int],
              start_block: int = 0) -> List[SegmentMatch]:
        """Scan full blocks of ``tokens`` from block index
        ``start_block`` and return maximal runs of content hits as
        segments (>= ``min_blocks`` long).  Segments never overlap and
        appear in prompt order — the scan is a single left-to-right
        pass, one digest lookup per block."""
        blocks = self._blocks_of(tokens)
        out: List[SegmentMatch] = []
        run_start, run_ids = -1, []     # current run of consecutive hits
        with self._lock:
            for i in range(max(0, start_block), len(blocks)):
                self.lookups += 1
                bid = self.lookup(self.block_digest(blocks[i]))
                if bid is not None:
                    self.hits += 1
                    if run_start < 0:
                        run_start = i
                    run_ids.append(bid)
                elif run_start >= 0:
                    if len(run_ids) >= self.min_blocks:
                        out.append(SegmentMatch(run_start, run_ids))
                    run_start, run_ids = -1, []
            if run_start >= 0 and len(run_ids) >= self.min_blocks:
                out.append(SegmentMatch(run_start, run_ids))
        return out

    def size(self) -> int:
        with self._lock:
            return len(self._by_digest)

    def stats(self) -> dict:
        with self._lock:
            return {"digests": len(self._by_digest),
                    "lookups": self.lookups,
                    "hits": self.hits}


# ---------------------------------------------------------------------------
# Delta-encoded checkpoints (Tier 5 persistence, paper Table VI)
# ---------------------------------------------------------------------------
@dataclass
class CheckpointManifest:
    """A checkpoint is a manifest: every block referenced by hash, plus the
    subset of payloads not already in the destination store."""
    block_hashes: List[str]
    new_blocks: Dict[str, float]        # hash -> bytes actually written
    reused_blocks: Dict[str, float]     # hash -> bytes skipped

    @property
    def raw_bytes(self) -> float:
        return sum(self.new_blocks.values()) + sum(self.reused_blocks.values())

    @property
    def written_bytes(self) -> float:
        return sum(self.new_blocks.values())

    @property
    def savings(self) -> float:
        raw = self.raw_bytes
        return 0.0 if raw == 0 else 1.0 - self.written_bytes / raw


def delta_checkpoint(blocks: Iterable[Tuple[str, float]],
                     present: ContentStore) -> CheckpointManifest:
    """blocks: iterable of (content_hash, nbytes).  Blocks whose hash is
    already in `present` are referenced, not re-written."""
    hashes, new, reused = [], {}, {}
    seen_local: Dict[str, float] = {}
    for h, nbytes in blocks:
        hashes.append(h)
        if present.contains_hash(h) or h in seen_local:
            reused[h] = reused.get(h, 0.0) + nbytes   # every appearance
        else:
            new[h] = nbytes                           # written once
            seen_local[h] = nbytes
    return CheckpointManifest(hashes, new, reused)
