"""The plain reference: a float32 forward of a configuration's layer
equations in plain PyTorch, with no kernel, no cache and no batching.
It imports nothing of the program.

This file holds what every family shares: RMSNorm, split-half RoPE at
``rope_theta``, causal softmax in blocks of query rows, the layer
(RMSNorm, attention, residual, RMSNorm, FFN, residual), the final
RMSNorm and the head (or the tied embedding).  Each family's attention
and FFN are in ``reference/<model_type>.py``, found by the
configuration's ``model_type`` (``load``).  Float32 throughout, TF32
off.  ``prec`` rounds each product's operands first: ``fp8`` is the
e4m3 control (a scale a tensor for weights, a scale a row for
activations).

The weights are the tensors the benchmark made, in the engine's
layer-stacked layout ("embed", "layers"/"attn"/..., "ln_f", "head");
each layer's leaves are widened to float32 as the layer runs.
"""
from __future__ import annotations

import importlib
from typing import Dict, List, Optional, Sequence

import torch

F8_MAX = 448.0
# query rows of one attention block: rows x heads x keys float32 scores
# stay under this many elements
SCORE_ELEMS = 1 << 28


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_fp8(x: torch.Tensor, per_row: bool) -> torch.Tensor:
    """x rounded to float8 e4m3 under a scale that maps its largest
    magnitude (of the tensor, or of each row) to 448, then widened."""
    if per_row:
        amax = x.abs().amax(dim=-1, keepdim=True)
    else:
        amax = x.abs().amax()
    s = (amax / F8_MAX).clamp_min(1e-30)
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


class Prec:
    def __init__(self, kind: str = "fp32"):
        if kind not in ("fp32", "fp8"):
            raise ValueError(kind)
        self.kind = kind

    def w(self, t: torch.Tensor) -> torch.Tensor:
        t = t.float()
        return round_fp8(t, False) if self.kind == "fp8" else t

    def a(self, t: torch.Tensor) -> torch.Tensor:
        return round_fp8(t, True) if self.kind == "fp8" else t

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.a(x), w)


def rms(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * g


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x [S, ..., d] at positions pos [S], split-half pairs."""
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                        device=x.device) / d))
    ang = pos.float()[:, None] * inv[None, :]
    shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (d // 2,)
    cos, sin = torch.cos(ang).view(shape), torch.sin(ang).view(shape)
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def causal_softmax_blocks(n: int, heads: int, score_fn, value_fn):
    """Attention over n positions in blocks of query rows: score_fn(lo,
    hi) -> [rows, heads, n] raw scores, value_fn(p [rows, heads, n]) ->
    the rows' context; the causal mask keeps keys <= the query."""
    rows = max(1, SCORE_ELEMS // max(1, heads * n))
    out = []
    for lo in range(0, n, rows):
        hi = min(n, lo + rows)
        s = score_fn(lo, hi)
        q_pos = torch.arange(lo, hi, device=s.device)[:, None, None]
        k_pos = torch.arange(n, device=s.device)[None, None, :]
        s = s.masked_fill(k_pos > q_pos, float("-inf"))
        out.append(value_fn(torch.softmax(s, dim=-1)))
    return torch.cat(out, dim=0)


def load(config: Dict, params: Dict, prec: str = "fp32"):
    """The reference of ``config``'s family, ``reference/<model_type>.py``."""
    mod = importlib.import_module("reference." + config["model_type"])
    return mod.Reference(config, params, prec)


class Reference:
    """The forward of one configuration (its config file as a dict) over
    the benchmark's weights; a family's subclass gives
    ``attn(a, h, pos)`` and ``ffn(f, h, capacity)``."""

    def __init__(self, config: Dict, params: Dict, prec: str = "fp32"):
        self.c = config
        self.p = params
        self.prec = Prec(prec)
        self.L = int(config["num_hidden_layers"])
        self.eps = float(config["rms_norm_eps"])
        self.theta = float(config["rope_theta"])

    # -- weights -------------------------------------------------------------
    def widened(self, i: int) -> Dict:
        """Layer i's leaves in float32 (rounded as ``prec`` says)."""
        def take(t):
            if isinstance(t, dict):
                return {k: take(v) for k, v in t.items()}
            return self.prec.w(t[i])
        return take(self.p["layers"])

    # -- layers --------------------------------------------------------------
    def layer(self, lp: Dict, x: torch.Tensor, pos: torch.Tensor,
              capacity: Optional[int] = None) -> torch.Tensor:
        """One layer (its ``widened`` leaves) over x [S, D] at pos [S]."""
        h = rms(x, lp["ln1"], self.eps)
        x = x + self.attn(lp["attn"], h, pos)
        h = rms(x, lp["ln2"], self.eps)
        return x + self.ffn(lp["ffn"], h, capacity)

    def head(self) -> torch.Tensor:
        """[D, V] float32 (the untied head, or the tied embedding's
        transpose)."""
        if "head" in self.p:
            return self.prec.w(self.p["head"])
        return self.prec.w(self.p["embed"]).t()

    # -- the forward ------------------------------------------------------------
    def logits(self, seqs: Sequence[Sequence[int]], starts: Sequence[int],
               device, capacity=None) -> List[torch.Tensor]:
        """For each token sequence, the float32 logits [len - start, V]
        of its positions start .. len - 1 (each predicting the next
        token).  Every sequence runs alone from position 0, layer by
        layer over all of them; ``capacity(n_tokens)`` (MoE) bounds each
        expert's share of one sequence's tokens, None keeps every
        choice."""
        emb = self.p["embed"]
        xs = [emb[torch.as_tensor(list(s), device=emb.device).long()]
              .to(device).float() for s in seqs]
        poss = [torch.arange(len(s), device=device) for s in seqs]
        for i in range(self.L):
            lp = self.widened(i)
            xs = [self.layer(lp, x, pos,
                             None if capacity is None else capacity(len(pos)))
                  for x, pos in zip(xs, poss)]
            del lp
        W = self.head().to(device)
        g = self.p["ln_f"].float().to(device)
        return [self.prec.mm(rms(x[st:], g, self.eps), W)
                for x, st in zip(xs, starts)]
