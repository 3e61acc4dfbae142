"""What decides ``correct``: the served tokens of a sample of the
requests the window finished, held to the plain reference.

The sample is drawn from the seed and always holds the finished request
with the most prompt and served tokens; requests are added until the
sample's served tokens reach ``min_tokens`` or every finished request
is in.  The reference runs once over each sampled request's prompt and
served tokens (``reference/forward.py``, float32, TF32 off) and reads,
at each served position, how far the served token's logit lies below
its best (``gap``).  The number compared is the widest gap.

The control is judged the same way: at the same positions, the gaps of
the tokens that the reference computed in float8 (e4m3) puts first."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclass
class Sample:
    prompt: List[int]
    served: List[int]


def finished_sample(handles, seed: int, min_tokens: int,
                    max_requests: int) -> List[Sample]:
    done = [h for h in handles if h.status == "done" and h.tokens]
    if not done:
        return []
    longest = max(range(len(done)),
                  key=lambda i: len(done[i].prompt) + len(done[i].tokens))
    rng = np.random.default_rng(int(seed) + 1)
    order = [longest] + [int(i) for i in rng.permutation(len(done))
                         if i != longest]
    out: List[Sample] = []
    served = 0
    for i in order:
        if served >= min_tokens or len(out) >= max_requests:
            break
        out.append(Sample(list(done[i].prompt), list(done[i].tokens)))
        served += len(done[i].tokens)
    return out


def sequences(samples: Sequence[Sample]) -> Tuple[list, list]:
    """The reference's inputs: prompt + served tokens but the last, and
    the first position whose logits predict a served token."""
    return ([s.prompt + s.served[:-1] for s in samples],
            [len(s.prompt) - 1 for s in samples])


def gaps(logits: Sequence[torch.Tensor], chosen: Sequence[Sequence[int]]
         ) -> List[float]:
    """Per position, best logit minus the chosen token's logit."""
    out: List[float] = []
    for lg, toks in zip(logits, chosen):
        idx = torch.as_tensor(list(toks), device=lg.device).long()
        g = lg.max(dim=-1).values - lg.gather(1, idx[:, None])[:, 0]
        out.extend(float(x) for x in g.cpu())
    return out


def served_gap(ref, samples: Sequence[Sample], device,
               chosen: Optional[Sequence[Sequence[int]]] = None) -> Dict:
    """The widest gap under ``ref`` of the served tokens, or of
    ``chosen`` (one token a served position of each sample)."""
    seqs, starts = sequences(samples)
    lg = ref.logits(seqs, starts, device)
    g = gaps(lg, chosen or [s.served for s in samples])
    return {"gap_max": max(g) if g else float("nan"), "positions": len(g),
            "requests": len(samples)}


def control_picks(ref_low, samples: Sequence[Sample], device
                  ) -> List[List[int]]:
    """The token that the lower precision puts first at each served
    position, on the same prompts and served tokens."""
    seqs, starts = sequences(samples)
    return [lg.argmax(dim=-1).tolist()
            for lg in ref_low.logits(seqs, starts, device)]


def verdict(gap: Optional[float], limit: float) -> bool:
    return gap is not None and np.isfinite(gap) and gap <= limit
