"""The port's training math against the JAX package's, on the CPU: the
flash prefill backward (``FlashCausal`` with its plain backward) against
``jax.vjp`` of JAX ``causal_attention``; every non-MLA family's
``train_loss`` value and gradients against ``jax.value_and_grad`` on
float32 params from the JAX ``init_params`` tree crossed through numpy
(``tests/test_torch_train_loss.py`` holds every family; MLA is in
``tests/test_torch_mla_train.py``); MLA's ``train_loss`` attending
through ``FlashCausal``; one AdamW step against
``apply_updates``; ``lr_schedule``; ``compress_int8`` bit for bit.
Tolerance 1e-4 (the port's CPU parity bar) unless a test states
another."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import reduce_config  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training import train as jtrain  # noqa: E402
from repro_torch.config import reduce_config as t_reduce  # noqa: E402
from repro_torch.configs import get_config as t_get  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training import train as ttrain  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
VLM_GATE = 0.7      # the seeded zero gate would switch the cross blocks off


def _np(t):
    return t.detach().float().numpy()


def flat(tree, path=()):
    """{path: leaf} of nested dicts."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flat(tree[k], path + (k,)))
        return out
    return {path: tree}


def jax_tree(arch, seed=0):
    """(JAX model, the float32 init tree as numpy) of a reduced config."""
    jm = jax_build(reduce_config(get_config(arch)))
    tree = jax.tree.map(lambda a: np.array(a, np.float32),
                        jax.jit(jm.init_params)(jax.random.PRNGKey(seed)))
    if "cross" in tree:
        tree["cross"]["gate"] = np.full_like(tree["cross"]["gate"], VLM_GATE)
    return jm, tree


def make_batch(cfg, b=2, s=24, seed=0):
    rs = np.random.RandomState(seed)
    batch = {"tokens": rs.randint(0, cfg.vocab_size, (b, s)).astype(np.int32),
             "labels": rs.randint(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patches"] = rs.standard_normal(
            (b, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = rs.standard_normal(
            (b, cfg.enc_len, cfg.d_model)).astype(np.float32)
    return batch


# ---------------------------------------------------------------------------
# the flash prefill backward
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("s,hq,hkv", [(64, 8, 2), (50, 8, 2), (64, 4, 4),
                                      (50, 4, 4)])
def test_flash_causal_backward_matches_jax_vjp(s, hq, hkv):
    """dq, dk, dv of ``ops.flash_causal`` (``FlashCausal``: the plain
    forward and backward on CPU tensors) against ``jax.vjp`` of JAX
    ``causal_attention`` at G 4 and G 1, S 64 and the ragged 50."""
    rs = np.random.RandomState(s + hq)
    b, hd = 2, 16
    q, k, v = (rs.standard_normal((b, s, h, hd)).astype(np.float32)
               for h in (hq, hkv, hkv))
    do = rs.standard_normal((b, s, hq, hd)).astype(np.float32)
    out, vjp = jax.vjp(lambda *a: jattn.causal_attention(*a), q, k, v)
    jgrads = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    o = ops.flash_causal(tq, tk, tv)
    assert o.grad_fn is not None
    np.testing.assert_allclose(_np(o), np.asarray(out), **TOL)
    tgrads = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
    for t, j in zip(tgrads, jgrads):
        np.testing.assert_allclose(_np(t), np.asarray(j), **TOL)


# (B, S, Hq, Hkv) -> (query tiles a dK/dV block, chunks of the longest
# walk): chip_smoke.py's backward rows and train_families' attention
@pytest.mark.parametrize("shape,chunk,parts", [
    ((4, 1024, 32, 8), 64, 1),      # the train micro-step: 512 blocks
    ((4, 1000, 32, 8), 64, 1),
    ((1, 512, 32, 8), 5, 7),        # llama-3.2-vision: 64 blocks unsplit
    ((2, 448, 6, 6), 2, 4),         # whisper-tiny, G 1: 84 unsplit
    ((2, 512, 32, 32), 8, 1),       # zamba2's shared attention, G 1
])
def test_bwd_kv_plan_at_smoke_shapes(shape, chunk, parts):
    """The tensor-core dK/dV kernel's split plan at the card run's
    shapes: no split where one block a key tile fills the card twice."""
    from repro_torch.kernels.flash_prefill import bwd_kv_chunk, bwd_kv_parts
    assert (bwd_kv_chunk(*shape), bwd_kv_parts(*shape)) == (chunk, parts)


# (B, S, Hq, Hkv) -> (chunk, parts) of the hd 128 and 192 / 128 `wgmma`
# dK/dV body (64-key tiles, one 384-thread block an SM): the card run's
# shapes, llama-3.2-vision's at S 2048, and MLA's micro-step
@pytest.mark.parametrize("shape,chunk,parts", [
    ((1, 512, 32, 8), 5, 7),        # llama-3.2-vision: 64 blocks unsplit
    ((2, 1024, 32, 8), 64, 1),      # 256 blocks: no split (264 at two
                                    # blocks an SM would split it)
    ((1, 2048, 32, 8), 128, 1),
    ((2, 1024, 128, 128), 16, 1),   # DeepSeek-V3's micro-step, G 1
    ((1, 100, 16, 1), 2, 16),
])
def test_bwd_kv_plan_at_smoke_shapes_pair_body(shape, chunk, parts):
    """The split plan of the `wgmma` dK/dV kernel at 64-key tiles: one
    block an SM (``bwd_per_sm``), so no split from 132 blocks; below
    that, chunks for about 2 x 132 blocks."""
    from repro_torch.kernels.flash_prefill import (bwd_kv_chunk,
                                                   bwd_kv_parts, bwd_per_sm)
    assert bwd_per_sm(128, 128, 1) == bwd_per_sm(192, 128, 1) == 1
    assert bwd_per_sm(64, 64, 1) == 1 and bwd_per_sm(16, 16, 1) == 2
    assert bwd_per_sm(64, 64, 0) == 2
    assert (bwd_kv_chunk(*shape, 64, 1), bwd_kv_parts(*shape, 64, 1)) == \
        (chunk, parts)


@pytest.mark.parametrize("b,hq,hkv", [(1, 32, 8), (2, 6, 6), (3, 8, 1),
                                      (8, 32, 8)])
def test_bwd_kv_plan_covers_every_walk(b, hq, hkv):
    """At every S up to 2048: the chunks of each key tile's walk (G (n -
    kt) query tiles) cover it, the longest walk needs exactly
    ``bwd_kv_parts`` chunks, and a split grid gives the 132 SMs at least
    one block each or runs chunks of the least length."""
    _covers_every_walk(b, hq, hkv, 2)


@pytest.mark.parametrize("b,hq,hkv", [(1, 32, 8), (2, 6, 6), (3, 8, 1),
                                      (2, 128, 128)])
def test_bwd_kv_plan_covers_every_walk_one_block_an_sm(b, hq, hkv):
    """The same at one block an SM (the `wgmma` body at 64-key tiles)."""
    _covers_every_walk(b, hq, hkv, 1)


def _covers_every_walk(b, hq, hkv, per_sm):
    from repro_torch.kernels.flash_prefill import (BWD_MIN_CHUNK, BWD_SMS,
                                                   bwd_kv_chunk,
                                                   bwd_kv_parts)
    g = hq // hkv
    for s in range(1, 2049, 7):
        n = -(-s // 64)
        chunk, parts = (bwd_kv_chunk(b, s, hq, hkv, 64, per_sm),
                        bwd_kv_parts(b, s, hq, hkv, 64, per_sm))
        assert 1 <= chunk <= g * n
        used = [-(-g * (n - kt) // chunk) for kt in range(n)]
        assert max(used) == parts and all(u * chunk >= g * (n - kt)
                                          for kt, u in enumerate(used))
        if parts > 1:
            assert (b * hkv * sum(used) >= BWD_SMS
                    or chunk == BWD_MIN_CHUNK)


# (B, S, Hq, Hkv) -> (chunk, parts) of the hd 64 `wgmma` dK/dV body's
# 128-key tiles (one 384-thread block an SM): the card run's shapes, the
# long train micro-batch (4 x 4096) and the GPU tests' split walks
@pytest.mark.parametrize("shape,chunk,parts", [
    ((4, 1024, 32, 8), 64, 1),      # 256 blocks: no split
    ((4, 4096, 32, 8), 256, 1),
    ((1, 512, 32, 8), 3, 11),       # 32 blocks unsplit
    ((2, 448, 6, 6), 2, 4),         # whisper-tiny, G 1: 48 unsplit
    ((2, 512, 32, 32), 8, 1),       # zamba2's shared attention, G 1
    ((1, 320, 8, 2), 2, 10),
])
def test_bwd_kv_plan_at_smoke_shapes_128_key_tiles(shape, chunk, parts):
    """The `wgmma` dK/dV kernel's split plan (128-key tiles, query tiles
    of 64) at the card run's shapes."""
    from repro_torch.kernels.flash_prefill import bwd_kv_chunk, bwd_kv_parts
    assert (bwd_kv_chunk(*shape, 128, 1),
            bwd_kv_parts(*shape, 128, 1)) == (chunk, parts)


@pytest.mark.parametrize("b,hq,hkv", [(1, 32, 8), (2, 6, 6), (3, 8, 1),
                                      (8, 32, 8), (2, 16, 1)])
def test_bwd_kv_plan_covers_every_walk_128_key_tiles(b, hq, hkv):
    """At every S up to 2048, with 128-key tiles: key tile kt walks G (n
    - 2 kt) query tiles of 64; its chunks cover that walk, the longest
    needs exactly ``bwd_kv_parts`` of them, and a split grid gives the
    132 SMs a block each or runs chunks of the least length; the C
    entries agree (``flash_prefill_bwd_kv_tile``, checked on the card)."""
    from repro_torch.kernels.flash_prefill import (BWD_MIN_CHUNK, BWD_SMS,
                                                   bwd_kv_chunk,
                                                   bwd_kv_parts, bwd_kv_tile)
    assert bwd_kv_tile(64, 64, 1) == 128
    assert bwd_kv_tile(128, 128, 1) == bwd_kv_tile(192, 128, 1) == 64
    assert bwd_kv_tile(16, 16, 1) == 64
    assert bwd_kv_tile(64, 64, 0) == 64
    g = hq // hkv
    for s in range(1, 2049, 7):
        n, m = -(-s // 64), -(-s // 128)
        chunk, parts = (bwd_kv_chunk(b, s, hq, hkv, 128, 1),
                        bwd_kv_parts(b, s, hq, hkv, 128, 1))
        assert 1 <= chunk <= g * n
        used = [-(-g * (n - 2 * kt) // chunk) for kt in range(m)]
        assert max(used) == parts and all(
            u * chunk >= g * (n - 2 * kt) for kt, u in enumerate(used))
        if parts > 1:
            assert (b * hkv * sum(used) >= BWD_SMS
                    or chunk == BWD_MIN_CHUNK)


def test_serving_attention_builds_no_graph():
    """Without grad (serving) the flash op stays on the plain forward
    wrapper: no ``FlashCausal`` node, no saved tensors."""
    x = torch.randn(1, 8, 2, 16, requires_grad=True)
    with torch.no_grad():
        assert ops.flash_causal(x, x[:, :, :1], x[:, :, :1]).grad_fn is None
    assert ops.flash_causal(x.detach(), x.detach()[:, :, :1],
                            x.detach()[:, :, :1]).grad_fn is None


def test_mla_train_loss_attends_through_flash_causal(monkeypatch):
    """MLA's ``train_loss`` attends in the non-absorbed form through
    ``FlashCausal`` (the flash prefill kernel and its backward on the
    card): every layer's attention output carries its backward node
    (twice a layer: the forward, then its recompute under remat), at
    Q/K hd + dr over V hd, and no MLA latent kernel runs."""
    from repro_torch.configs.paper_models import DEEPSEEK_V3
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.models import attention as tattn
    cfg = t_reduce(DEEPSEEK_V3)
    model = build_model(cfg)
    params = model.init_params(0, device="cpu", dtype=torch.float32)
    for t in flat(params).values():
        t.requires_grad_(True)
    outs = []

    def record(q, k, v, **kw):
        o = ops.flash_causal(q, k, v, backend=kw.get("backend"))
        outs.append((q.shape[-1], v.shape[-1], o.grad_fn))
        return o
    monkeypatch.setattr(tattn, "causal_attention", record)
    monkeypatch.setattr(ops, "mla_prefill", None)
    toks = torch.zeros((1, 8), dtype=torch.int32)
    loss, _ = model.train_loss(params, {"tokens": toks, "labels": toks})
    loss.backward()
    assert len(outs) == 2 * cfg.n_layers
    for dk, dv, fn in outs:
        assert (dk, dv) == (cfg.hd + cfg.d_rope, cfg.hd)
        assert type(fn).__name__ == fp.FlashCausal.__name__ + "Backward"
    assert float(params["layers"]["attn"]["w_uk"].grad.abs().max()) > 0


def test_cross_entropy_matches_jax():
    """With and without a mask, and its gradient (the max detached)."""
    from repro.models import common as jcommon
    rs = np.random.RandomState(1)
    logits = (3 * rs.standard_normal((3, 5, 40))).astype(np.float32)
    labels = rs.randint(0, 40, (3, 5)).astype(np.int32)
    mask = (rs.rand(3, 5) > 0.3).astype(np.float32)
    for m in (None, mask):
        def jloss(lg):
            return jcommon.cross_entropy(lg, jnp.asarray(labels),
                                         None if m is None else jnp.asarray(m))
        jl, jgr = jax.value_and_grad(jloss)(jnp.asarray(logits))
        t = torch.from_numpy(logits).requires_grad_(True)
        tl = common.cross_entropy(t, torch.from_numpy(labels),
                                  None if m is None else torch.from_numpy(m))
        tl.backward()
        np.testing.assert_allclose(float(tl.detach()), float(jl), **TOL)
        np.testing.assert_allclose(_np(t.grad), np.asarray(jgr), **TOL)


# ---------------------------------------------------------------------------
# the optimizer and gradient compression
# ---------------------------------------------------------------------------
def test_adamw_step_matches_apply_updates():
    """One update from a mid-run state (step 4, nonzero moments, a
    gradient norm past the clip): new bf16 params bit for bit, step, lr
    and grad norm, and the float32 master and moments within float32
    rounding (1e-6 of their scale: both run the same float32 formula)."""
    rs = np.random.RandomState(2)
    shapes = {"a": (4, 6), "b": {"c": (5,), "d": (3, 2, 2)}}
    mk = {}

    def tree(fn, sh=shapes):
        return {k: tree(fn, v) if isinstance(v, dict) else fn(v)
                for k, v in sh.items()}
    mk["grads"] = tree(lambda s: (2 * rs.standard_normal(s)).astype(
        np.float32))
    mk["master"] = tree(lambda s: rs.standard_normal(s).astype(np.float32))
    mk["m"] = tree(lambda s: (0.1 * rs.standard_normal(s)).astype(np.float32))
    mk["v"] = tree(lambda s: (0.05 * rs.rand(*s)).astype(np.float32))
    cfg = dict(lr=1e-3, warmup_steps=3, total_steps=20)
    jstate = jopt.AdamWState(jnp.asarray(4, jnp.int32),
                             *(jax.tree.map(jnp.asarray, mk[k])
                               for k in ("master", "m", "v")))
    jparams = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jstate.master)
    jp, js, jmet = jopt.apply_updates(jopt.AdamWConfig(**cfg), jparams,
                                      jax.tree.map(jnp.asarray, mk["grads"]),
                                      jstate)
    tt = {k: params_from_numpy(mk[k], device="cpu") for k in mk}
    tstate = topt.AdamWState(torch.tensor(4, dtype=torch.int32), tt["master"],
                             tt["m"], tt["v"])
    tparams = common.tree_map(lambda a: a.to(torch.bfloat16), tt["master"])
    tp, ts, tmet = topt.apply_updates(topt.AdamWConfig(**cfg), tparams,
                                      tt["grads"], tstate)
    assert float(jmet["grad_norm"]) > 1.0          # the clip is active
    assert int(ts.step) == int(js.step) == 5 and ts.step.dtype == torch.int32
    for key in ("lr", "grad_norm"):
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                   rtol=1e-6)
    jf = {k: flat(jax.tree.map(np.asarray, getattr(js, k)))
          for k in ("master", "m", "v")}
    for key in ("master", "m", "v"):
        for path, t in flat(getattr(ts, key)).items():
            np.testing.assert_allclose(_np(t), jf[key][path], rtol=1e-6,
                                       atol=1e-6 * np.abs(jf[key][path]).max())
    jpf = flat(jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jp))
    for path, t in flat(tp).items():
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(_np(t), jpf[path])


def test_lr_schedule_matches_jax():
    cfg = dict(lr=1e-3, warmup_steps=10, total_steps=100)
    for s in (0, 5, 10, 50, 99):
        j = float(jopt.lr_schedule(jopt.AdamWConfig(**cfg), jnp.asarray(s)))
        t = topt.lr_schedule(topt.AdamWConfig(**cfg),
                             torch.tensor(s, dtype=torch.int32))
        assert t.dtype == torch.float32
        np.testing.assert_allclose(float(t), j, rtol=1e-6)


def test_init_state_matches_jax():
    jm, tree = jax_tree("llama3.2-1b")
    js = jopt.init_state(jax.tree.map(jnp.asarray, tree))
    ts = topt.init_state(params_from_numpy(tree, device="cpu"))
    assert ts.step.dtype == torch.int32 and int(ts.step) == 0
    for key in ("master", "m", "v"):
        jf = flat(jax.tree.map(np.asarray, getattr(js, key)))
        for path, t in flat(getattr(ts, key)).items():
            assert t.dtype == torch.float32
            np.testing.assert_array_equal(t.numpy(), jf[path])


def test_compress_int8_bit_equal_to_jax():
    """Values, scale and the round trip bit for bit, ties included
    (round half to even)."""
    rs = np.random.RandomState(4)
    g = rs.standard_normal((64, 33)).astype(np.float32)
    # exact halves after scaling: max |g| = 127 makes the scale 1
    ties = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.49, -126.5],
                    np.float32)
    for a in (g, ties, np.zeros(7, np.float32)):
        jq, js = jtrain.compress_int8(jnp.asarray(a))
        tq, ts = ttrain.compress_int8(torch.from_numpy(a))
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        assert np.float32(ts) == np.asarray(js)
        np.testing.assert_array_equal(
            ttrain.decompress_int8(tq, ts).numpy(),
            np.asarray(jtrain.decompress_int8(jq, js)))


def test_pick_n_microbatches_matches_jax():
    from repro.config import ShapeConfig as JShape
    from repro_torch.config import ShapeConfig as TShape
    for arch in ("llama3.2-1b", "llama-3.2-vision-11b"):
        for seq, gb, shards in ((1024, 8, 1), (4096, 64, 2), (128, 6, 1)):
            kw = dict(name="t", kind="train", seq_len=seq, global_batch=gb)
            assert ttrain.pick_n_microbatches(
                t_get(arch), TShape(**kw), shards) == \
                jtrain.pick_n_microbatches(get_config(arch), JShape(**kw),
                                           shards)
