#!/usr/bin/env python3
"""Time flash prefill with its log-sum-exp (kernel 7) and its backward
(kernel 7b) of two or more source trees of this repository on one CUDA
card, in turns (A, B, ..., then the same trees in reverse order), at
``chip_smoke.py``'s backward shapes (``BWD_CASES``), the dry run's train
micro-batch (``LONG_CASES``' 4 x 4096 row) and any ``--case``.

    python3 scripts/flash_ab.py [--which f|b|fb] [--case B,S,Hq,Hkv,dk,dv]
                                TREE [TREE ...]

Each TREE is a checkout of the repository: ``.`` for this one, another
commit unpacked with ``git archive`` into a git-ignored directory (e.g.
``build/parent``).  Each turn is one process that builds that tree's
kernels into the tree's own ``build/`` and times its wrappers with this
tree's ``chip_smoke.time_ms`` (CUDA-event windows of L2-flushed
launches) on the same seeded inputs.  One JSON line a (turn, case): the
tree, the card's name and power limit, the forward's ms (``f``), the
backward's ms and each of its kernels' device ms from the profiler
(``b``: ``kernel_split_ms``, L2 warm).
"""
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def cases(extra):
    """(name, B, S, Hq, Hkv, dk, dv, dtype) of every timed case."""
    import chip_smoke as cs
    long = [(name, b, s, hq, hkv, hd, hd, "bfloat16")
            for name, b, s, hq, hkv, hd, backward in cs.LONG_CASES
            if backward]
    return list(cs.BWD_CASES) + long + [
        ("case_" + "x".join(map(str, c)), *c, "bfloat16") for c in extra]


def one(tree: Path, which: str, extra) -> None:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(tree / "src"))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import flash_prefill as fp
    todo = cases(extra)
    if not Path(fp.__file__).is_relative_to(tree):
        raise AssertionError(f"repro_torch was not imported from {tree}")
    card = cs.nvidia_smi()
    gen = torch.Generator(device="cuda").manual_seed(7)
    for name, B, S, hq, hkv, dk, dv, dtype in todo:
        dt = getattr(torch, dtype)

        def rn(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(dt)
        q, k, v = rn(B, S, hq, dk), rn(B, S, hkv, dk), rn(B, S, hkv, dv)
        rec = {"tree": str(tree), "card": card, "case": name,
               "shape": [B, S, hq, hkv, dk, dv], "dtype": dtype}
        if "f" in which:
            rec["fwd_ms"] = cs.time_ms(torch, lambda: fp.flash_prefill(
                q, k, v, backend="cuda", with_lse=True))["ms"]
        if "b" in which:
            o, lse = fp.flash_prefill(q, k, v, backend="cuda", with_lse=True)
            do = rn(B, S, hq, dv)

            def bwd():
                return fp.flash_prefill_bwd(q, k, v, o, do, lse,
                                            backend="cuda")
            rec["bwd_ms"] = cs.time_ms(torch, bwd)["ms"]
            rec["kernel_split_ms"] = cs.kernel_split_ms(torch, bwd)
        print(json.dumps(rec), flush=True)


def main() -> int:
    args = sys.argv[1:]
    which, extra = "fb", []
    while args[:1] in (["--which"], ["--case"]):
        if args[0] == "--which":
            which = args[1]
        else:
            extra.append(tuple(int(x) for x in args[1].split(",")))
        args = args[2:]
    if args[:1] == ["--one"]:
        one(Path(args[1]).resolve(), which, extra)
        return 0
    try:
        import torch
    except ImportError:
        torch = None
    if (not args or torch is None or not torch.cuda.is_available()
            or not set(which) <= {"f", "b"}
            or any(len(c) != 6 for c in extra)):
        print("flash_ab: needs a CUDA card, --which f, b or fb, each --case "
              "as B,S,Hq,Hkv,dk,dv, and at least one tree", file=sys.stderr)
        return 2
    flags = ["--which", which]
    for c in extra:
        flags += ["--case", ",".join(map(str, c))]
    for tree in args + args[::-1]:
        subprocess.run([sys.executable, __file__, *flags, "--one", tree],
                       check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
