"""MLA training in the port against the JAX package's, on the CPU.  The
port trains MLA in the non-absorbed form the JAX package trains
(``mla_attention_prefill``): per-head keys [c_kv W_uk ; k_rope] and
values c_kv W_uv through ``ops.flash_causal`` at Q/K wider than V.

- ``ops.flash_causal`` at dk 24 over dv 16 (G 1 and 4, S 64 and the
  ragged 50): output, dq, dk, dv against ``jax.vjp`` of JAX
  ``causal_attention``;
- reduced DeepSeek-V3 (q/k 24, v 16) with a dense FFN and with an MoE
  FFN (4 experts, top 2): loss, metrics and every gradient leaf against
  ``jax.value_and_grad(model.train_loss)``, params from the JAX
  ``init_params`` tree (float32) crossed through numpy;
- three ``make_train_step`` steps against the JAX jitted step in each
  accumulation mode (the bars of ``tests/test_torch_train_step.py``);
- the train forward's last-position logits against the port's absorbed
  ``prefill`` (kernel 5's plain version) in float32: one function;
- an MLA checkpoint round trip, bit for bit;
- the kernels' width rule refusing a pair they do not take.

Tolerance 1e-4 (the port's CPU parity bar) unless a test states
another."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import reduce_config  # noqa: E402
from repro.configs.paper_models import DEEPSEEK_V3  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training import train as jtrain  # noqa: E402
from repro_torch.config import reduce_config as t_reduce  # noqa: E402
from repro_torch.configs.paper_models import \
    DEEPSEEK_V3 as T_DEEPSEEK_V3  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import flash_prefill as fp  # noqa: E402
from repro_torch.models.common import rms_norm  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.training import checkpoint as ckpt_mod  # noqa: E402
from repro_torch.training import data as data_mod  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training import train as ttrain  # noqa: E402
from test_torch_train_step import ADAMW, MODES, leaves_equal  # noqa: E402
from test_torch_training import TOL, _np, flat, make_batch  # noqa: E402

MOE = dict(n_experts=4, top_k=2, expert_d_ff=32)
FFNS = {"dense": {}, "moe": MOE}


def configs(ffn):
    """(JAX config, port config) of reduced DeepSeek-V3 with that FFN."""
    return (dataclasses.replace(reduce_config(DEEPSEEK_V3), **FFNS[ffn]),
            dataclasses.replace(t_reduce(T_DEEPSEEK_V3), **FFNS[ffn]))


_TREES = {}


def mla_setup(ffn):
    """(JAX model, port model, the float32 JAX init tree as numpy)."""
    if ffn not in _TREES:
        jcfg, tcfg = configs(ffn)
        jm = jax_build(jcfg)
        tree = jax.tree.map(lambda a: np.array(a, np.float32),
                            jax.jit(jm.init_params)(jax.random.PRNGKey(0)))
        _TREES[ffn] = (jm, build_model(tcfg), tree)
    return _TREES[ffn]


def test_reduced_config_widths():
    """The reduced config trains at Q/K wider than V, as DeepSeek-V3's
    192 over 128."""
    _, tcfg = configs("dense")
    assert (tcfg.hd + tcfg.d_rope, tcfg.hd) == (24, 16)
    assert (T_DEEPSEEK_V3.hd + T_DEEPSEEK_V3.d_rope,
            T_DEEPSEEK_V3.hd) == fp.MLA_WIDTHS


@pytest.mark.parametrize("s,hq,hkv", [(64, 4, 4), (50, 4, 4), (64, 8, 2),
                                      (50, 8, 2)])
def test_flash_causal_narrow_values_match_jax_vjp(s, hq, hkv):
    """Output, dq, dk, dv of ``ops.flash_causal`` (``FlashCausal``: the
    plain forward and backward on CPU tensors) at dk 24 over dv 16
    against ``jax.vjp`` of JAX ``causal_attention`` (scale 1/sqrt(24))."""
    rs = np.random.RandomState(s + hq)
    b, dk, dv = 2, 24, 16
    q = rs.standard_normal((b, s, hq, dk)).astype(np.float32)
    k = rs.standard_normal((b, s, hkv, dk)).astype(np.float32)
    v = rs.standard_normal((b, s, hkv, dv)).astype(np.float32)
    do = rs.standard_normal((b, s, hq, dv)).astype(np.float32)
    out, vjp = jax.vjp(lambda *a: jattn.causal_attention(*a), q, k, v)
    jgrads = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    o = ops.flash_causal(tq, tk, tv)
    assert o.grad_fn is not None and o.shape == (b, s, hq, dv)
    np.testing.assert_allclose(_np(o), np.asarray(out), **TOL)
    tgrads = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
    for t, j in zip(tgrads, jgrads):
        assert t.shape == j.shape
        np.testing.assert_allclose(_np(t), np.asarray(j), **TOL)


@pytest.mark.parametrize("ffn", sorted(FFNS))
def test_mla_train_loss_and_grads_match_jax(ffn):
    """Loss, metrics (``aux_loss`` with the MoE FFN) and the gradient of
    every leaf against ``jax.value_and_grad(model.train_loss)``; every
    port leaf gets a gradient."""
    jm, tm, tree = mla_setup(ffn)
    batch = make_batch(tm.cfg)
    (jl, jmet), jg = jax.value_and_grad(jm.train_loss, has_aux=True)(
        jax.tree.map(jnp.asarray, tree),
        {k: jnp.asarray(v) for k, v in batch.items()})
    tp = params_from_numpy(tree, device="cpu")
    for t in flat(tp).values():
        t.requires_grad_(True)
    tl, tmet = tm.train_loss(tp, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    assert set(tmet) == set(jmet) and ("aux_loss" in tmet) == (ffn == "moe")
    for key in jmet:
        np.testing.assert_allclose(float(tmet[key].detach()),
                                   float(jmet[key]), **TOL)
    tl.backward()
    jflat = flat(jax.tree.map(np.asarray, jg))
    tflat = flat(tp)
    assert set(tflat) == set(jflat)
    for path, t in tflat.items():
        assert t.grad is not None, path
        np.testing.assert_allclose(_np(t.grad), jflat[path],
                                   err_msg=str(path), **TOL)
    for w in ("wq", "w_dkv", "w_kr", "w_uk", "w_uv", "wo"):
        assert float(tflat[("layers", "attn", w)].grad.abs().max()) > 0, w


_JAX_STEPS = {}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_mla_train_steps_match_jax(mode):
    """Three steps of reduced DeepSeek-V3 (dense FFN) from the same
    float32 params and batches against the JAX jitted step, with the
    bars of ``test_torch_train_step.test_train_steps_match_jax``: step 1
    in float32 (loss, grad norm and every master within 1e-4), steps 2-3
    in bf16 (loss within 1e-4 relative, grad norm within 2e-3 relative,
    the masters after step 3 within 1e-5 on average and 2 lr at most)."""
    jm, tm, tree = mla_setup("dense")
    data = data_mod.SyntheticLM(data_mod.DataConfig(
        vocab_size=tm.cfg.vocab_size, seq_len=32, global_batch=4))
    if mode not in _JAX_STEPS:
        _JAX_STEPS[mode] = jax.jit(jtrain.make_train_step(
            jm, adamw=jopt.AdamWConfig(**ADAMW), **MODES[mode]))
    step = _JAX_STEPS[mode]
    jp = jax.tree.map(jnp.asarray, tree)
    jo = jopt.init_state(jp)
    tp = params_from_numpy(tree, device="cpu")
    to = topt.init_state(tp)
    t_step = ttrain.make_train_step(tm, adamw=topt.AdamWConfig(**ADAMW),
                                    **MODES[mode])
    for s in range(3):
        raw = data.batch(s)
        jp, jo, jmet = step(jp, jo, {k: jnp.asarray(v) for k, v in raw.items()})
        tp, to, tmet = t_step(tp, to, {k: torch.from_numpy(v)
                                       for k, v in raw.items()})
        assert set(tmet) == set(jmet)
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(tmet["grad_norm"]),
                                   float(jmet["grad_norm"]),
                                   rtol=1e-4 if s == 0 else 2e-3)
        jmast = flat(jax.tree.map(np.asarray, jo.master))
        gaps = [np.abs(t.numpy() - jmast[path])
                for path, t in flat(to.master).items()]
        if s == 0:
            assert max(g.max() for g in gaps) <= 1e-4
    gaps = np.concatenate([g.ravel() for g in gaps])
    assert gaps.mean() <= 1e-5
    assert gaps.max() <= 2 * ADAMW["lr"]
    assert int(to.step) == int(jo.step) == 3


@pytest.mark.parametrize("ffn", sorted(FFNS))
def test_train_forward_equals_absorbed_prefill(ffn):
    """The train path's last-position logits (non-absorbed, through
    ``FlashCausal``) against the port's absorbed ``prefill`` (kernel 5's
    plain version at offset 0) on the same float32 params and tokens."""
    _, tm, tree = mla_setup(ffn)
    tp = params_from_numpy(tree, device="cpu")
    tokens = torch.from_numpy(make_batch(tm.cfg, b=2, s=20)["tokens"])
    positions = torch.arange(tokens.shape[1])[None]
    x, _ = tm._train_layers(tp, {"tokens": tokens},
                            tm._embed(tp, tokens), positions, None)
    x = rms_norm(x, tp["ln_f"], tm.cfg.norm_eps)
    train_logits = tm._logits(tp, x[:, -1])
    serve_logits, _ = tm.prefill(tp, {"tokens": tokens})
    np.testing.assert_allclose(_np(train_logits), _np(serve_logits), **TOL)


def test_mla_checkpoint_roundtrip_bitexact(tmp_path):
    """Two steps of reduced DeepSeek-V3, then params and AdamW state
    through ``CheckpointManager``: every leaf equal bit for bit."""
    _, tm, tree = mla_setup("moe")
    data = data_mod.SyntheticLM(data_mod.DataConfig(
        vocab_size=tm.cfg.vocab_size, seq_len=16, global_batch=2))
    step = ttrain.make_train_step(tm, adamw=topt.AdamWConfig(**ADAMW))
    params = params_from_numpy(tree, device="cpu")
    state = topt.init_state(params)
    for s in range(2):
        params, state, _ = step(params, state, {
            k: torch.from_numpy(v) for k, v in data.batch(s).items()})
    mgr = ckpt_mod.CheckpointManager(str(tmp_path))
    mgr.save(2, (params, state))
    restored, manifest = mgr.restore((params, state))
    assert manifest["step"] == 2
    assert leaves_equal((params, state), restored)


@pytest.mark.parametrize("dk,dv,backward", [(96, 64, False), (96, 64, True),
                                            (128, 192, False),
                                            (32, 32, True)])
def test_kernel_width_rule_refuses_other_pairs(dk, dv, backward):
    """The card's wrappers refuse every (dk, dv) pair but dk == dv
    (forward) or the backward's (16, 16) / (64, 64) / (128, 128), and
    MLA's (192, 128); the refusal names the pairs they take."""
    with pytest.raises(ValueError, match="192, 128"):
        fp.check_widths("flash_prefill", dk, dv, backward=backward)


@pytest.mark.parametrize("dk,dv,backward", [(192, 128, False),
                                            (192, 128, True),
                                            (64, 64, True), (128, 128, True),
                                            (256, 256, False),
                                            (16, 16, False),
                                            (16, 16, True)])
def test_kernel_width_rule_takes_its_pairs(dk, dv, backward):
    fp.check_widths("flash_prefill", dk, dv, backward=backward)
