#!/usr/bin/env python3
"""Time the GQA chunk and segment prefill (kernels 2 and 3) and their
absorbed-MLA counterparts (kernels 5 and 6) of two or more source trees
of this repository on one CUDA card, in turns (A, B, ..., then the same
trees in reverse order), at ``chip_smoke.py``'s ``kernels`` and
``mla_kernels``-phase shapes.

Kernels 2 and 3: llama3.2-1b's heads (32 / 8, hd 64) over a 512-token
window, the chunk at offset 320, at the window's last chunk (448) and at
offset 0 (a prompt's first chunk), the gap segment chunk, the same at
32-token pages (offset 336) and at granite-moe's G = 3; and
llama-3-70b's geometry (64 / 8, hd 128) at offset 320.  Kernels 5 and 6:
DeepSeek-V3's widths (128 heads, dl 512, dr 64, 64-token pages), the
chunk of 64 at offset 1024 (``mla_paged_prefill``), the two-gap segment
chunk (``mla_paged_prefill_seg``), a whole 1100-token prompt at offset 0
(``mla_paged_prefill_offset0``, the monolithic prefill's call) and the
chunk of 64 at offset 0 (``mla_paged_prefill_tile1``: every block walks
one tile, so its time is a block's start-up and one tile), each also
with its kernel's device ms from the profiler (L2 warm,
``profiler_ms``).

    python3 scripts/prefill_ab.py TREE [TREE ...]

Each TREE is a checkout of the repository: ``.`` for this one, another
commit unpacked with ``git archive`` into a git-ignored directory (e.g.
``build/parent``).  Each turn is one process that builds that tree's
kernels into the tree's own ``build/`` and times its wrappers with this
tree's ``chip_smoke.time_ms`` (CUDA-event windows of L2-flushed
launches) on the same seeded inputs.  A tree with the `wgmma` body's
split plan (``prefill_split_plan``) is also timed with splits of 1 to 4
and of 8 tiles (those plans of at most ``MAX_SPLITS`` splits), and a
tree with the MLA `wgmma` body (``mla_body``) with each launch order
(``MLA_VARIANTS``), each variant held to the plain version first. One
JSON line a (turn, case): the tree, the card's name and power limit, the
body, ``ms`` and each variant's ms; first, a turn's ``launch_floor``:
one launch of a one-element kernel timed the same way, and the sha256 of
kernels 1-4, 7 and 8's outputs on the kernels phases' inputs
(``untouched``); last, whether every turn gave the same digests
(``untouched_equal``; the exit code is 1 if not).
"""
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# the MLA `wgmma` body's launches timed beside the default: each launch
# order
MLA_VARIANTS = {f"longest_first_{o}": {"longest_first": o} for o in (0, 1)}


def case_inputs(torch, cs):
    """(name, entry, args) of every timed case, on seeded inputs."""
    gen = torch.Generator(device="cuda").manual_seed(1234)
    out = []
    for tag, kw in (("", {}), ("_page32", {"page": 32, "offset": 336}),
                    ("_g3", {"B": 32, "Hq": 24})):
        _, pre, seg = cs.make_kernel_inputs(torch, gen, **kw)
        out.append(("paged_prefill" + tag, "paged_prefill", pre))
        if not tag:
            window = pre["block_tables"].shape[1] * pre["k_pages"].shape[1]
            for name, off in (("paged_prefill_long",
                               window - pre["q"].shape[1]),
                              ("paged_prefill_offset0", 0)):
                out.append((name, "paged_prefill", dict(
                    pre, offsets=torch.full_like(pre["offsets"], off))))
        out.append(("paged_prefill_seg" + tag, "paged_prefill_seg", seg))
    # llama-3-70b's attention geometry, one 64-query chunk at offset 320
    hq, hkv, hd, page, p, c = 64, 8, 128, 64, 8, 64
    n = 1 + 64 * p + 16

    def rn(*shape):
        return torch.randn(shape, generator=gen,
                           device="cuda").to(torch.bfloat16)
    tables = (torch.randperm(n - 1, generator=gen, device="cuda")[:p] + 1
              ).reshape(1, p).to(torch.int32)
    out.append(("paged_prefill_hd128", "paged_prefill", dict(
        q=rn(1, c, hq, hd), k_chunk=rn(1, c, hkv, hd),
        v_chunk=rn(1, c, hkv, hd), k_pages=rn(n, page, hkv, hd),
        v_pages=rn(n, page, hkv, hd), block_tables=tables,
        offsets=torch.tensor([320], dtype=torch.int32, device="cuda"))))
    return out


def mla_case_inputs(torch, cs):
    """(name, entry, args) of kernels 5 and 6's timed cases, on seeded
    inputs: the ``mla_kernels`` phase's chunk and segment chunk, the
    monolithic prefill's whole prompt at offset 0 over one empty
    64-token page, and the phase's chunk at offset 0."""
    _, pre, seg = cs.make_mla_kernel_inputs(
        torch, torch.Generator(device="cuda").manual_seed(4321),
        cs.mla_config())
    gen = torch.Generator(device="cuda").manual_seed(4322)
    hq, dl = pre["q_lat"].shape[2:]
    dr, c = pre["q_rope"].shape[-1], cs.MLA_PROMPT

    def rn(*shape):
        return torch.randn(shape, generator=gen,
                           device="cuda").to(torch.bfloat16)
    zero = torch.zeros((1,), dtype=torch.int32, device="cuda")
    whole = dict(pre, q_lat=rn(1, c, hq, dl), q_rope=rn(1, c, hq, dr),
                 lat_chunk=rn(1, c, dl + dr),
                 latent_pages=torch.zeros((1, 64, dl + dr),
                                          dtype=torch.bfloat16,
                                          device="cuda"),
                 block_tables=torch.zeros((1, 1), dtype=torch.int32,
                                          device="cuda"),
                 offsets=zero)
    return [("mla_paged_prefill", "mla_paged_prefill", pre),
            ("mla_paged_prefill_seg", "mla_paged_prefill_seg", seg),
            ("mla_paged_prefill_offset0", "mla_paged_prefill", whole),
            ("mla_paged_prefill_tile1", "mla_paged_prefill",
             dict(pre, offsets=zero))]


def mla_body_of(pp, a) -> str:
    """The body the tree's MLA C entry runs on inputs ``a`` (a tree
    before the `wgmma` body has only the tensor-core query)."""
    import ctypes

    from repro_torch.kernels import build
    from repro_torch.kernels.paged_attention import DTYPE_CODES
    q, lat = a["q_lat"], a["latent_pages"]
    n_cp = q.shape[1] if "chunk_positions" in a else 0
    codes = (DTYPE_CODES[q.dtype], DTYPE_CODES[lat.dtype])
    if hasattr(pp, "mla_body"):
        return pp.mla_body(q.shape[-1], a["q_rope"].shape[-1], n_cp,
                           lat.shape[1], *codes)
    fn = build.entry("mla_paged_prefill", "mla_paged_prefill_tensor_core",
                     [ctypes.c_int] * 5)
    tc = fn(q.shape[-1], a["q_rope"].shape[-1], n_cp, *codes)
    return "tensor_core" if tc else "cuda_core"


def untouched_outputs(torch, cs, ops) -> dict:
    """sha256 of the outputs of the kernels this comparison does not
    redesign -- 1 (the GQA decode), 2 and 3 (the GQA chunk and segment
    prefill), 4 (the MLA decode), 7 (flash prefill) and 8 (the int8
    decode) -- on the kernels phases' seeded inputs: two trees that agree
    here agree bit for bit."""
    import hashlib

    from repro_torch.models import attention as attn

    def digest(t):
        return hashlib.sha256(t.contiguous().view(torch.uint8).cpu()
                              .numpy().tobytes()).hexdigest()
    dec, pre, seg = cs.make_kernel_inputs(
        torch, torch.Generator(device="cuda").manual_seed(1234))
    mdec = cs.make_mla_kernel_inputs(
        torch, torch.Generator(device="cuda").manual_seed(4321),
        cs.mla_config())[0]
    i8 = cs.make_int8_decode_inputs(
        torch, torch.Generator(device="cuda").manual_seed(5678), attn)
    gen = torch.Generator(device="cuda").manual_seed(9876)
    flash = {key: torch.randn((1, 384, h, 64), generator=gen,
                              device="cuda").to(torch.bfloat16)
             for key, h in (("q", 32), ("k", 8), ("v", 8))}
    return {"paged_decode": digest(ops.paged_decode(**dec)),
            "paged_prefill": digest(ops.paged_prefill(**pre)),
            "paged_prefill_seg": digest(ops.paged_prefill_seg(**seg)),
            "mla_paged_decode": digest(ops.mla_decode(**mdec)),
            "flash_prefill": digest(ops.flash_causal(**flash)),
            "paged_decode_int8": digest(ops.paged_decode_int8(**i8))}


def body_of(pp, a) -> str:
    """The body the tree's C entry runs on inputs ``a`` (a tree before
    the `wgmma` body has only the tensor-core query)."""
    import ctypes

    from repro_torch.kernels import build
    from repro_torch.kernels.paged_attention import DTYPE_CODES
    q, kp = a["q"], a["k_pages"]
    codes = (DTYPE_CODES[q.dtype], DTYPE_CODES[kp.dtype])
    if hasattr(pp, "body"):
        return pp.body(q.shape[-2], kp.shape[2], q.shape[-1], kp.shape[1],
                       *codes)
    fn = build.entry("paged_prefill", "paged_prefill_tensor_core",
                     [ctypes.c_int] * 5)
    tc = fn(q.shape[-2], kp.shape[2], q.shape[-1], *codes)
    return "tensor_core" if tc else "cuda_core"


def one(tree: Path) -> None:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(tree / "src"))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_prefill as pp
    if not Path(pp.__file__).is_relative_to(tree):
        raise AssertionError(f"repro_torch was not imported from {tree}")
    from repro_torch.kernels import build
    build.build_all()        # one nvcc a source, in parallel
    card = cs.nvidia_smi()
    # the floor of this timing: one launch of a one-element kernel
    one = torch.zeros(1, device="cuda")
    print(json.dumps({"tree": str(tree), "card": card, "case": "launch_floor",
                      "ms": cs.time_ms(torch, lambda: one.add_(1))["ms"]}),
          flush=True)
    print(json.dumps({"tree": str(tree), "case": "untouched",
                      "sha256": untouched_outputs(torch, cs, ops)}),
          flush=True)
    fns = {"paged_prefill": ops.paged_prefill,
           "paged_prefill_seg": ops.paged_prefill_seg}
    for name, entry, a in case_inputs(torch, cs):
        args = list(a.values())
        rec = {"tree": str(tree), "card": card, "case": name,
               "body": body_of(pp, a),
               "ms": cs.time_ms(torch, lambda: fns[entry](
                   **a, backend="cuda"))["ms"]}
        if hasattr(pp, "prefill_split_plan") and rec["body"] == "wgmma":
            b, c, hq, hd = a["q"].shape
            _, page, hkv, _ = a["k_pages"].shape
            plan = pp.prefill_split_plan(b, c, hq, hkv, hd, page,
                                         a["block_tables"].shape[1])
            rec["plan"] = plan._asdict()
            variants = {}
            for tiles in (1, 2, 3, 4, 8):
                span = tiles * pp.KEY_TILE
                v = plan._replace(tiles=tiles,
                                  pool_splits=-(-plan.window // span),
                                  chunk_splits=-(-c // span))
                if v.splits <= pp.MAX_SPLITS:
                    variants[f"tiles_{tiles}"] = v
            plain = fns[entry](**a, backend="torch").float()
            for key, v in variants.items():
                out = pp._launch(entry, *args, plan=v)
                err = float((out.float() - plain).abs().max())
                if not err <= cs.KERNEL_ATOL:
                    raise AssertionError(f"{name} {key}: max_abs_err {err}")
                rec[key + "_ms"] = cs.time_ms(torch, lambda: pp._launch(
                    entry, *args, plan=v))["ms"]
        print(json.dumps(rec), flush=True)
    mla_fns = {"mla_paged_prefill": ops.mla_prefill,
               "mla_paged_prefill_seg": ops.mla_prefill_seg}
    for name, entry, a in mla_case_inputs(torch, cs):
        fn = mla_fns[entry]
        rec = {"tree": str(tree), "card": card, "case": name,
               "body": mla_body_of(pp, a),
               "ms": cs.time_ms(torch, lambda: fn(**a, backend="cuda"))["ms"],
               "profiler_ms": cs.kernel_split_ms(torch, lambda: fn(
                   **a, backend="cuda"))}
        plain = fn(**a, backend="torch").float()
        err = float((fn(**a, backend="cuda").float() - plain).abs().max())
        if not err <= cs.KERNEL_ATOL:
            raise AssertionError(f"{name}: max_abs_err {err}")
        if rec["body"] == "wgmma":
            args = [v for k, v in a.items() if k not in ("d_latent",
                                                         "scale")]
            for key, kw in MLA_VARIANTS.items():
                def call():
                    return pp._launch_mla(entry, *args, a["d_latent"],
                                          a["scale"], **kw)
                err = float((call().float() - plain).abs().max())
                if not err <= cs.KERNEL_ATOL:
                    raise AssertionError(f"{name} {key}: max_abs_err {err}")
                rec[key + "_ms"] = cs.time_ms(torch, call)["ms"]
        print(json.dumps(rec), flush=True)


def main() -> int:
    args = sys.argv[1:]
    if args[:1] == ["--one"]:
        one(Path(args[1]).resolve())
        return 0
    try:
        import torch
    except ImportError:
        torch = None
    if not args or torch is None or not torch.cuda.is_available():
        print("prefill_ab: needs a CUDA card and at least one tree",
              file=sys.stderr)
        return 2
    digests = {}
    for tree in args + args[::-1]:
        out = subprocess.run([sys.executable, __file__, "--one", tree],
                             check=True, stdout=subprocess.PIPE,
                             text=True).stdout
        print(out, end="", flush=True)
        for line in out.splitlines():
            rec = json.loads(line)
            if rec["case"] == "untouched":
                digests[json.dumps(rec["sha256"], sort_keys=True)] = tree
    same = len(digests) == 1
    print(json.dumps({"case": "untouched_equal", "trees": args,
                      "bit_for_bit": same}), flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
