"""Load real ShareGPT / LMSYS JSON dumps into the trace session
structure (``List[List[Turn]]``, ``Turn = List[BlockAccess]``) so
published conversation dumps replay through ``traces/serving_replay.py``
and the block-level simulators unmodified.

Formats (auto-detected per record):

* **ShareGPT** — ``[{"id": ..., "conversations": [{"from":
  "human"|"gpt"|"system", "value": str}, ...]}, ...]``
* **LMSYS** (lmsys-chat-1m style) — ``[{"conversation_id": ...,
  "conversation": [{"role": "user"|"assistant"|"system", "content":
  str}, ...]}, ...]``

Both ``.json`` (one array) and ``.jsonl`` (one record per line) files
load.  There is no tokenizer in this repo, so text is block-aligned by
a word-count token estimate (~4/3 tokens per whitespace word) and each
``BLOCK``-token chunk becomes one content id — a stable digest of the
chunk text, so identical text (a system prompt shared across sessions,
an unchanged conversation prefix) maps to identical content ids and is
visible to dedup, the radix prefix index and the fleet-shared tier
exactly like the synthetic generators' content.

Turn shape mirrors ``generators._sharegpt_session``: every turn re-reads
the system prompt and the truncated input history (inputs only, last
``history_blocks`` blocks), then the new user input, then the
assistant reply as single-use ``intermediate_reasoning`` output blocks.

The ``workload_sessions`` interface dispatches here for workloads named
``file:<path>`` — e.g. ``ServingReplayConfig(workload=
"file:/data/sharegpt.json")`` replays a real dump through the live
engine with no other change.
"""
from __future__ import annotations

import json
import zlib
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from repro_torch.traces.generators import BLOCK, BlockAccess, Turn

# token estimate per whitespace word (the usual ~0.75 words/token)
_TOKENS_PER_WORD = 4.0 / 3.0


def _estimate_tokens(text: str) -> int:
    return max(1, int(round(len(text.split()) * _TOKENS_PER_WORD)))


def text_blocks(text: str, block_tokens: int = BLOCK) -> List[Tuple[int, ...]]:
    """Block-align ``text``: split into ``block_tokens``-sized chunks on
    word boundaries; each chunk's content id is a stable digest of the
    chunk text (identical text -> identical ids, across processes).

    Sizing is pure integer arithmetic (``block_tokens * 3 // 4`` words
    per block — the inverse of the 4/3 tokens-per-word estimate), so
    chunk boundaries can never drift with float rounding.  Explicit
    tail rule: a trailing fragment estimated under half a block merges
    into the previous chunk instead of minting its own content id —
    the replay materializes every id at full block size, so a
    nearly-empty tail block both inflated reuse accounting and gave
    re-ingested text a digest that depended on where the mis-sized
    tail happened to fall."""
    words = text.split()
    if not words:
        return []
    words_per_block = max(1, (block_tokens * 3) // 4)
    chunks = [words[i:i + words_per_block]
              for i in range(0, len(words), words_per_block)]
    if len(chunks) > 1 and _estimate_tokens(
            " ".join(chunks[-1])) < block_tokens // 2:
        chunks[-2].extend(chunks.pop())
    out: List[Tuple[int, ...]] = []
    for chunk in chunks:
        s = " ".join(chunk)
        out.append((zlib.crc32(s.encode("utf-8")) & 0x7FFFFFFF,))
    return out


# ---------------------------------------------------------------------------
# record parsing
# ---------------------------------------------------------------------------
def _messages(record: dict) -> Optional[List[Tuple[str, str]]]:
    """Normalize one dump record to [(role, text), ...] with roles in
    {"system", "user", "assistant"}; None if the record is neither
    format."""
    if "conversations" in record:          # ShareGPT
        roles = {"human": "user", "user": "user", "gpt": "assistant",
                 "chatgpt": "assistant", "bing": "assistant",
                 "bard": "assistant", "assistant": "assistant",
                 "system": "system"}
        out = []
        for m in record["conversations"]:
            role = roles.get(str(m.get("from", "")).lower())
            if role and m.get("value"):
                out.append((role, str(m["value"])))
        return out
    if "conversation" in record:           # LMSYS
        out = []
        for m in record["conversation"]:
            role = str(m.get("role", "")).lower()
            if role in ("system", "user", "assistant") and m.get("content"):
                out.append((role, str(m["content"])))
        return out
    return None


def _session_id(record: dict, index: int) -> str:
    for key in ("id", "conversation_id", "session_id"):
        if key in record:
            return f"ing-{record[key]}"
    return f"ing-{index}"


def _session_turns(messages: List[Tuple[str, str]], sid: str, *,
                   block_tokens: int, history_blocks: int,
                   max_turns: Optional[int]) -> List[Turn]:
    """Pair user->assistant exchanges into turns with the generator's
    event shape (system + history + input + output per turn)."""
    sys_blocks: List[Tuple[int, ...]] = []
    exchanges: List[Tuple[List, List]] = []   # (input blocks, output blocks)
    pending_user: List[str] = []
    for role, text in messages:
        if role == "system" and not exchanges and not pending_user:
            sys_blocks.extend(text_blocks(text, block_tokens))
        elif role == "user":
            pending_user.append(text)
        elif role == "assistant" and pending_user:
            inp = text_blocks(" ".join(pending_user), block_tokens)
            out = text_blocks(text, block_tokens)
            exchanges.append((inp, out))
            pending_user = []
    turns: List[Turn] = []
    history: List[Tuple[int, ...]] = []
    first = True
    for inp, out in exchanges[:max_turns]:
        ev: Turn = []
        for b in sys_blocks:
            ev.append(BlockAccess(b, "system_prompt", "reasoning_step",
                                  sid, new_session=first))
            first = False
        for b in history:                       # inputs only, truncated
            ev.append(BlockAccess(b, "user_context", "reasoning_step",
                                  sid, new_session=first))
            first = False
        for b in inp:
            ev.append(BlockAccess(b, "user_context", "reasoning_step",
                                  sid, new_session=first))
            first = False
        for b in out:                           # single-use scratch
            ev.append(BlockAccess(b, "intermediate_reasoning",
                                  "reasoning_step", sid,
                                  new_session=first))
            first = False
        history.extend(inp)
        history = history[-history_blocks:]
        turns.append(ev)
    return turns


def _iter_records(path: Path):
    text = path.read_text(encoding="utf-8")
    if path.suffix == ".jsonl":
        for line in text.splitlines():
            line = line.strip()
            if line:
                yield json.loads(line)
        return
    data = json.loads(text)
    if isinstance(data, dict):                 # single-record dump
        data = [data]
    yield from data


def load_sessions(path, *, block_tokens: int = BLOCK,
                  max_sessions: Optional[int] = None,
                  max_turns: Optional[int] = None,
                  history_blocks: int = 12) -> List[List[Turn]]:
    """Load a ShareGPT/LMSYS dump into session/turn structure.

    ``history_blocks`` caps the re-read input history per turn (matches
    the synthetic ShareGPT generator's truncation — the divergence that
    caps radix prefix reuse on this workload is a property of the data
    pipeline, so real dumps reproduce it too)."""
    path = Path(path)
    sessions: List[List[Turn]] = []
    for i, record in enumerate(_iter_records(path)):
        if max_sessions is not None and len(sessions) >= max_sessions:
            break
        if not isinstance(record, dict):
            continue
        msgs = _messages(record)
        if not msgs:
            continue
        turns = _session_turns(msgs, _session_id(record, i),
                               block_tokens=block_tokens,
                               history_blocks=history_blocks,
                               max_turns=max_turns)
        if turns:
            sessions.append(turns)
    if not sessions:
        raise ValueError(f"{path}: no ShareGPT/LMSYS conversations found")
    return sessions


# cache keyed by (resolved path, mtime): replay sweeps re-enter
# workload_sessions once per cell, and real dumps are large
_CACHE: Dict[Tuple[str, float, int], List[List[Turn]]] = {}


def file_sessions(spec: str, n_sessions: int) -> List[List[Turn]]:
    """``workload_sessions`` entry point for ``file:<path>`` workloads:
    the first ``n_sessions`` conversations of the dump."""
    path = Path(spec)
    key = (str(path.resolve()), path.stat().st_mtime, 0)
    if key not in _CACHE:
        _CACHE[key] = load_sessions(path)
    return _CACHE[key][:n_sessions]
