"""The plain versions behind kernels 7 and 7b (``ref.flash_prefill`` and
``FlashCausal``'s plain backward) against the JAX package's
``causal_attention`` and ``jax.vjp`` of it, at the 128-row tiles of the
`wgmma` bodies: S = 127 / 128 / 129 / 255, G = Hq / Hkv of 1 and 16
(glm4's), at each width pair those bodies take, (64, 64), (128, 128)
and MLA's Q/K 192 over V 128.  The same seeded numpy inputs go to both;
float32, tolerance 1e-4 (the flash tests' CPU parity bar)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as jattn  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
PAIRS = [(64, 64), (128, 128), (192, 128)]
EDGES = [127, 128, 129, 255]
HQ = 16


def _inputs(s, g, dk, dv, seed):
    rs = np.random.RandomState(seed)
    hkv = HQ // g
    q = rs.standard_normal((1, s, HQ, dk)).astype(np.float32)
    k = rs.standard_normal((1, s, hkv, dk)).astype(np.float32)
    v = rs.standard_normal((1, s, hkv, dv)).astype(np.float32)
    do = rs.standard_normal((1, s, HQ, dv)).astype(np.float32)
    return q, k, v, do


@pytest.mark.parametrize("g", [1, 16])
@pytest.mark.parametrize("s", EDGES)
@pytest.mark.parametrize("dk,dv", PAIRS)
def test_flash_prefill_at_tile_edges_matches_jax(dk, dv, s, g):
    """``ref.flash_prefill`` (the wrapper's plain version on the CPU)
    against JAX ``causal_attention``."""
    q, k, v, _ = _inputs(s, g, dk, dv, seed=s + g + dk)
    want = jattn.causal_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v))
    got = ref.flash_prefill(*(torch.from_numpy(a) for a in (q, k, v)))
    assert got.shape == (1, s, HQ, dv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("g", [1, 16])
@pytest.mark.parametrize("s", EDGES)
@pytest.mark.parametrize("dk,dv", PAIRS)
def test_flash_causal_grads_at_tile_edges_match_jax(dk, dv, s, g):
    """dq, dk, dv of ``ops.flash_causal`` (``FlashCausal``'s plain forward
    and backward on CPU tensors) against ``jax.vjp`` of JAX
    ``causal_attention`` on the same cotangent."""
    q, k, v, do = _inputs(s, g, dk, dv, seed=s + g + dv + 1)
    _, vjp = jax.vjp(lambda *a: jattn.causal_attention(*a), q, k, v)
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = ops.flash_causal(tq, tk, tv)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    for t, j in zip(got, want):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)
