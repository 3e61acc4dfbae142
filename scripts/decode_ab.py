#!/usr/bin/env python3
"""Time the GQA paged decode (kernel 1), the absorbed-MLA decode
(kernel 4) and the int8 paged decode (kernel 8) of two or more source
trees of this repository on one CUDA card, in turns (A, B, ..., then the
same trees in reverse order), at ``chip_smoke.py``'s ``kernels`` /
``mla_kernels``-phase shapes.

Kernel 1: llama3.2-1b's heads (32 / 8, hd 64) on 64 ragged rows over a
512-token window (``paged_decode``), every row full (``_full``), at
32-token pages (``_page32``), granite-moe's G 3 (``_g3``), the same call
with its log-sum-exp (``_lse``), every row one key and one tile
(``_len1``, ``_len64``: a block's cost beside its walk), and the dense
slot states of the VLM (4
rows of 1024 at hd 128), zamba2 (4 x 1024, G 1) and whisper-tiny (8 x
448, G 1), and the dry run's decode on one card (32 rows of 32768
tokens, ``_32k``).  Kernel 4: DeepSeek-V3's widths on 56 ragged rows up
to 2048 tokens (``mla_paged_decode``), 8 full rows (``_long``) and the
56 latent slots of 2048 tokens seen as pages (``_slots``), each also
with its kernels' device ms from the profiler (the walk and the
combine, L2 warm: ``profiler_ms``).  Kernel 8: llama3.2-1b's heads over
64 slots of 512 tokens seen as 64-token pages (``paged_decode_int8``),
every row full (``_full``), one key (``_len1``) and one tile
(``_len64``), and the int8_decode path's 4 rows at its eighth step
(``paged_decode_int8_path``).

    python3 scripts/decode_ab.py TREE [TREE ...]

Each TREE is a checkout of the repository: ``.`` for this one, another
commit unpacked with ``git archive`` into a git-ignored directory (e.g.
``build/parent``).  Each turn is one process that builds that tree's
kernels into the tree's own ``build/`` and times its wrappers with this
tree's ``chip_smoke.time_ms`` (CUDA-event windows of L2-flushed
launches) on the same seeded inputs.  A tree with kernel 1's Hopper body
(``decode_split_plan``) is also timed at 1, 2, 4 and 8 splits a (row, KV
head) and kernel 4 at 256-, 512- and 1024-token splits beside its
default, each held to the plain version first.  One JSON line a (turn,
case): the tree, the card's name and power limit, the body, ``ms`` and
each variant's ms; first, a turn's ``launch_floor``: one launch of a
one-element kernel timed the same way, and the sha256 of the outputs of
kernels 1-7 and 7b, which this comparison does not redesign, on the
kernels phases' inputs (``untouched``); last, whether every turn gave the
same digests (``untouched_equal``; the exit code is 1 if not).
"""
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# kernel 1's plans timed beside the default: this many splits a (row, KV
# head), of the fewest whole tiles that cover the window
VARIANT_SPLITS = (1, 2, 4, 8)
# kernel 4's split lengths timed beside the default
MLA_SPLITS = (256, 512, 1024)


def gqa_cases(torch, cs, ops):
    """(name, kwargs) of kernel 1's timed cases, on seeded inputs."""
    from repro_torch.models import attention as attn
    gen = torch.Generator(device="cuda").manual_seed(1234)
    dec = cs.make_kernel_inputs(torch, gen)[0]
    window = dec["block_tables"].shape[1] * dec["k_pages"].shape[1]
    out = [("paged_decode", dec),
           ("paged_decode_full",
            dict(dec, lengths=torch.full_like(dec["lengths"], window))),
           ("paged_decode_page32",
            cs.make_kernel_inputs(torch, gen, page=32, offset=336)[0]),
           ("paged_decode_g3", cs.make_kernel_inputs(torch, gen, B=32,
                                                     Hq=24)[0]),
           ("paged_decode_lse", dict(dec, with_lse=True)),
           # every row one key, then one tile: what a block costs beside
           # its walk
           ("paged_decode_len1",
            dict(dec, lengths=torch.ones_like(dec["lengths"]))),
           ("paged_decode_len64",
            dict(dec, lengths=torch.full_like(dec["lengths"], 64)))]
    vlm, zamba, whisper = (32, 8, 128), (32, 32, 64), (6, 6, 64)
    for name, s, heads, lens in (
            ("paged_decode_vlm", cs.VLM_MAX_LEN, vlm,
             [n + cs.VLM_STEPS // 2 for n in cs.VLM_PROMPTS]),
            ("paged_decode_zamba2", cs.RECURRENT_MAX_LEN, zamba,
             [n + cs.RECURRENT_STEPS // 2 for n in cs.RECURRENT_PROMPTS]),
            ("paged_decode_whisper", cs.ENCDEC_MAX_LEN, whisper,
             [n + cs.ENCDEC_STEPS // 2 for n in cs.ENCDEC_PROMPTS])):
        hq, hkv, hd = heads
        k, v = (torch.randn((len(lens), s, hkv, hd), generator=gen,
                            device="cuda").to(torch.bfloat16)
                for _ in range(2))
        (kp, vp), tables = attn.slot_pages(k, v)
        out.append((name, dict(
            q=torch.randn((len(lens), hq, hd), generator=gen,
                          device="cuda").to(torch.bfloat16),
            k_pages=kp, v_pages=vp, block_tables=tables,
            lengths=torch.tensor(lens, dtype=torch.int32, device="cuda"))))
    # the dry run's decode cell on one card: 32 slots of 32768 tokens,
    # every row full
    b, s, hkv, hd = 32, 32768, 8, 64
    kp, vp = (torch.randn((b * s // 64, 64, hkv, hd), generator=gen,
                          device="cuda").to(torch.bfloat16)
              for _ in range(2))
    out.append(("paged_decode_32k", dict(
        q=torch.randn((b, 32, hd), generator=gen,
                      device="cuda").to(torch.bfloat16),
        k_pages=kp, v_pages=vp,
        block_tables=torch.arange(b * s // 64, dtype=torch.int32,
                                  device="cuda").reshape(b, s // 64),
        lengths=torch.full((b,), s - 1, dtype=torch.int32,
                           device="cuda"))))
    return out


def mla_cases(torch, cs, ops):
    """(name, kwargs) of kernel 4's timed cases, on seeded inputs."""
    cfg = cs.mla_config()
    gen = torch.Generator(device="cuda").manual_seed(4321)
    dec = cs.make_mla_kernel_inputs(torch, gen, cfg)[0]
    b8, p = 8, dec["block_tables"].shape[1]
    lat = dec["latent_pages"]
    window = p * lat.shape[1]
    hq, dl = dec["q_lat"].shape[1:]
    dr = dec["q_rope"].shape[-1]
    perm = torch.randperm(lat.shape[0] - 1, generator=gen,
                          device="cuda")[:b8 * p] + 1

    def rn(*shape):
        return torch.randn(shape, generator=gen,
                           device="cuda").to(torch.bfloat16)
    long = dict(dec, q_lat=rn(b8, hq, dl), q_rope=rn(b8, hq, dr),
                block_tables=perm.reshape(b8, p).to(torch.int32),
                lengths=torch.full((b8,), window, dtype=torch.int32,
                                   device="cuda"))
    slots = cs.mla_dense_cases(torch, gen, cfg, ops)[1][2]
    return [("mla_paged_decode", dec), ("mla_paged_decode_long", long),
            ("mla_paged_decode_slots", slots)]


def int8_cases(torch, cs):
    """(name, kwargs) of kernel 8's timed cases, on seeded inputs."""
    from repro_torch.models import attention as attn
    gen = torch.Generator(device="cuda").manual_seed(5678)
    dec = cs.make_int8_decode_inputs(torch, gen, attn)
    lengths = dec["lengths"]
    return [("paged_decode_int8", dec),
            ("paged_decode_int8_path", cs.make_int8_decode_inputs(
                torch, gen, attn, lengths=cs.INT8_PATH_LENGTHS)),
            # every row full, one key, one tile: the bytes of a batch with
            # no short row, and what a block costs beside its walk
            ("paged_decode_int8_full", dict(dec, lengths=torch.full_like(
                lengths, 512))),
            ("paged_decode_int8_len1", dict(dec, lengths=torch.ones_like(
                lengths))),
            ("paged_decode_int8_len64", dict(dec, lengths=torch.full_like(
                lengths, 64)))]


def untouched_outputs(torch, cs, ops) -> dict:
    """sha256 of the outputs of the kernels this comparison does not
    redesign -- 1 (the GQA decode, with its log-sum-exp), 2 and 3 (the
    chunk and segment prefill), 4 (the MLA decode), 5 and 6 (the MLA
    chunk and segment prefill), 7 (flash prefill with its log-sum-exp)
    and 7b (its backward) -- on the kernels phases' seeded inputs: two
    trees that agree here agree bit for bit."""
    import hashlib

    from repro_torch.kernels.flash_prefill import (flash_prefill,
                                                   flash_prefill_bwd)

    def digest(*ts):
        h = hashlib.sha256()
        for t in ts:
            h.update(t.contiguous().view(torch.uint8).cpu().numpy()
                     .tobytes())
        return h.hexdigest()
    dec, pre, seg = cs.make_kernel_inputs(
        torch, torch.Generator(device="cuda").manual_seed(1234))
    mdec, mpre, mseg = cs.make_mla_kernel_inputs(
        torch, torch.Generator(device="cuda").manual_seed(4321),
        cs.mla_config())
    gen = torch.Generator(device="cuda").manual_seed(5678)
    q, k, v, do = (torch.randn((1, 384, h, 64), generator=gen,
                               device="cuda").to(torch.bfloat16)
                   for h in (32, 8, 8, 32))
    o, lse = flash_prefill(q, k, v, backend="cuda", with_lse=True)
    grads = flash_prefill_bwd(q, k, v, o, do, lse, backend="cuda")
    return {"paged_decode": digest(*ops.paged_decode(**dec, with_lse=True)),
            "paged_prefill": digest(ops.paged_prefill(**pre)),
            "paged_prefill_seg": digest(ops.paged_prefill_seg(**seg)),
            "mla_paged_decode": digest(ops.mla_decode(**mdec)),
            "mla_paged_prefill": digest(ops.mla_prefill(**mpre)),
            "mla_paged_prefill_seg": digest(ops.mla_prefill_seg(**mseg)),
            "flash_prefill": digest(o, lse),
            "flash_prefill_bwd": digest(*grads)}


def gqa_body(pa, a) -> str:
    import ctypes

    from repro_torch.kernels import build
    from repro_torch.kernels.paged_attention import DTYPE_CODES
    q, kp = a["q"], a["k_pages"]
    codes = (DTYPE_CODES[q.dtype], DTYPE_CODES[kp.dtype])
    if hasattr(pa, "body"):
        return pa.body(q.shape[-2], kp.shape[2], q.shape[-1], kp.shape[1],
                       a["block_tables"].shape[1], *codes)
    fn = build.entry("paged_decode", "paged_decode_tensor_core",
                     [ctypes.c_int] * 5)
    tc = fn(q.shape[-2], kp.shape[2], q.shape[-1], *codes)
    return "tensor_core" if tc else "cuda_core"


def mla_body(mpd, a) -> str:
    from repro_torch.kernels.paged_attention import DTYPE_CODES
    codes = (DTYPE_CODES[a["q_lat"].dtype],
             DTYPE_CODES[a["latent_pages"].dtype])
    dl, dr = a["q_lat"].shape[-1], a["q_rope"].shape[-1]
    if hasattr(mpd, "body"):
        return mpd.body(dl, dr, a["latent_pages"].shape[1], *codes)
    return "tensor_core" if mpd.tensor_core(dl, dr, *codes) else "cuda_core"


def one(tree: Path) -> None:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(tree / "src"))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import cost, ops
    from repro_torch.kernels import mla_paged_decode as mpd
    from repro_torch.kernels import paged_attention as pa
    if not Path(pa.__file__).is_relative_to(tree):
        raise AssertionError(f"repro_torch was not imported from {tree}")
    cs.cost = cost
    card = cs.nvidia_smi()
    one = torch.zeros(1, device="cuda")
    print(json.dumps({"tree": str(tree), "card": card, "case": "launch_floor",
                      "ms": cs.time_ms(torch, lambda: one.add_(1))["ms"]}),
          flush=True)

    def check(name, out, plain):
        out = out[0] if isinstance(out, tuple) else out
        plain = plain[0] if isinstance(plain, tuple) else plain
        err = float((out.float() - plain.float()).abs().max())
        if not err <= cs.KERNEL_ATOL:
            raise AssertionError(f"{name}: max_abs_err {err}")

    print(json.dumps({"tree": str(tree), "card": card, "case": "untouched",
                      "sha256": untouched_outputs(torch, cs, ops)}),
          flush=True)
    for name, a in gqa_cases(torch, cs, ops):
        rec = {"tree": str(tree), "card": card, "case": name,
               "body": gqa_body(pa, a),
               "ms": cs.time_ms(torch, lambda: ops.paged_decode(
                   **a, backend="cuda"))["ms"]}
        if hasattr(pa, "decode_split_plan") and rec["body"] == "hopper":
            b, hq, hd = a["q"].shape
            _, page, hkv, _ = a["k_pages"].shape
            p = a["block_tables"].shape[1]
            plan = pa.decode_split_plan(b, hq, hkv, hd, page, p)
            rec["plan"] = plan._asdict()
            n_tiles = -(-p * page // pa.KEY_TILE)
            plain = ops.paged_decode(**a, backend="torch")
            lse = (torch.empty((b, hq), dtype=torch.float32, device="cuda")
                   if a.get("with_lse") else None)
            args = [a[k] for k in ("q", "k_pages", "v_pages",
                                   "block_tables", "lengths")] + [lse]
            for splits in VARIANT_SPLITS:
                tiles = -(-n_tiles // splits)
                v = plan._replace(tiles=tiles, splits=-(-n_tiles // tiles))
                check(f"{name} splits {splits}",
                      pa._launch_decode(*args, plan=v), plain)
                rec[f"splits_{v.splits}_ms"] = cs.time_ms(
                    torch, lambda: pa._launch_decode(*args, plan=v))["ms"]
        print(json.dumps(rec), flush=True)

    default = mpd.SPLIT_TOKENS
    for name, a in mla_cases(torch, cs, ops):
        rec = {"tree": str(tree), "card": card, "case": name,
               "body": mla_body(mpd, a),
               "split_tokens": mpd.decode_split_tokens(
                   a["block_tables"].shape[1] * a["latent_pages"].shape[1]),
               "ms": cs.time_ms(torch, lambda: ops.mla_decode(
                   **a, backend="cuda"))["ms"],
               "profiler_ms": cs.kernel_split_ms(torch, lambda: ops.mla_decode(
                   **a, backend="cuda"))}
        if hasattr(mpd, "body"):
            plain = ops.mla_decode(**a, backend="torch")
            for tokens in MLA_SPLITS:
                mpd.SPLIT_TOKENS = tokens
                try:
                    check(f"{name} split {tokens}",
                          ops.mla_decode(**a, backend="cuda"), plain)
                    rec[f"split_{tokens}_ms"] = cs.time_ms(
                        torch, lambda: ops.mla_decode(
                            **a, backend="cuda"))["ms"]
                finally:
                    mpd.SPLIT_TOKENS = default
        print(json.dumps(rec), flush=True)

    for name, a in int8_cases(torch, cs):
        check(name, ops.paged_decode_int8(**a, backend="cuda"),
              ops.paged_decode_int8(**a, backend="torch"))
        rec = {"tree": str(tree), "card": card, "case": name,
               "body": cs.kernel_body(name, a)
               if hasattr(pa, "int8_body") else "tensor_core",
               "ms": cs.time_ms(torch, lambda: ops.paged_decode_int8(
                   **a, backend="cuda"))["ms"]}
        if rec["body"] == "hopper":
            b, hq, hd = a["q"].shape
            _, page, hkv, _ = a["k_pages"].shape
            rec["plan"] = pa.decode_split_plan(
                b, hq, hkv, hd, page, a["block_tables"].shape[1])._asdict()
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
        print("decode_ab: needs a CUDA card and at least one tree",
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
