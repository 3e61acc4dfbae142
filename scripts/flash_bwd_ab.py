#!/usr/bin/env python3
"""Time the flash prefill backward (``flash_prefill_bwd``) of two or more
source trees of this repository on one CUDA card, in turns (A, B, ...,
then the same trees in reverse order), at ``chip_smoke.py``'s backward
shapes (``BWD_CASES``).

    python3 scripts/flash_bwd_ab.py TREE [TREE ...]

Each TREE is a checkout of the repository: ``.`` for this one, another
commit unpacked with ``git archive`` into a git-ignored directory (e.g.
``build/parent``).  Each turn is one process that builds that tree's
kernels into the tree's own ``build/`` and times its wrapper with this
tree's ``chip_smoke.time_ms`` (CUDA-event windows of L2-flushed
launches) on the same seeded inputs.  One JSON line a (turn, shape):
the tree, the card's name and power limit, ms, and each kernel's device
ms from the profiler (``kernel_split_ms``, L2 warm).
"""
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def one(tree: Path) -> None:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(tree / "src"))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels.flash_prefill import flash_prefill_bwd
    if not Path(flash_prefill_bwd.__code__.co_filename).is_relative_to(tree):
        raise AssertionError(f"repro_torch was not imported from {tree}")
    card = cs.nvidia_smi()
    gen = torch.Generator(device="cuda").manual_seed(2222)
    for case in cs.BWD_CASES:
        name, a = cs.bwd_case(torch, gen, *case)[:2]

        def fn():
            return flash_prefill_bwd(**a, backend="cuda")
        ms = cs.time_ms(torch, fn)["ms"]
        print(json.dumps({"tree": str(tree), "card": card, "kernel": name,
                          "shape": list(case[1:]), "ms": ms,
                          "kernel_split_ms": cs.kernel_split_ms(torch, fn)}),
              flush=True)


def main() -> int:
    args = sys.argv[1:]
    if len(args) == 2 and args[0] == "--one":
        one(Path(args[1]).resolve())
        return 0
    try:
        import torch
    except ImportError:
        torch = None
    if not args or torch is None or not torch.cuda.is_available():
        print("flash_bwd_ab: needs a CUDA card and at least one tree",
              file=sys.stderr)
        return 2
    for tree in args + args[::-1]:
        subprocess.run([sys.executable, __file__, "--one", tree], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
