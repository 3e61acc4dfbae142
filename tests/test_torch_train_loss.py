"""Every non-MLA family's ``train_loss`` against the JAX package's: the
loss, its metrics (granite-moe's ``aux_loss`` too) and the gradient of
every param leaf against ``jax.value_and_grad(model.train_loss)``, on
float32 params from the JAX ``init_params`` tree crossed through numpy
and a numpy-made batch (reduced configs: llama3.2-1b,
granite-moe-3b-a800m, llama-3.2-vision-11b with cross gates at 0.7,
whisper-tiny, zamba2-1.2b, rwkv6-1.6b).  Every port leaf must get a
gradient.  Tolerance 1e-4, the port's CPU parity bar."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import reduce_config  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro_torch.config import reduce_config as t_reduce  # noqa: E402
from repro_torch.configs import get_config as t_get  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from test_torch_training import (TOL, _np, flat, jax_tree,  # noqa: E402
                                 make_batch)

FAMILIES = ["llama3.2-1b", "granite-moe-3b-a800m", "llama-3.2-vision-11b",
            "whisper-tiny", "zamba2-1.2b", "rwkv6-1.6b"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_loss_and_grads_match_jax(arch):
    """Loss, metrics and the gradient of every leaf against
    ``jax.value_and_grad(model.train_loss)``; every port leaf gets a
    gradient (none is ``None``)."""
    jm, tree = jax_tree(arch)
    cfg = reduce_config(get_config(arch))
    batch = make_batch(cfg)
    (jl, jmet), jg = jax.value_and_grad(jm.train_loss, has_aux=True)(
        jax.tree.map(jnp.asarray, tree),
        {k: jnp.asarray(v) for k, v in batch.items()})
    tm = build_model(t_reduce(t_get(arch)))
    tp = params_from_numpy(tree, device="cpu")
    for t in flat(tp).values():
        t.requires_grad_(True)
    tl, tmet = tm.train_loss(tp, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    assert set(tmet) == set(jmet)
    for key in jmet:
        np.testing.assert_allclose(float(tmet[key].detach()), float(jmet[key]), **TOL)
    tl.backward()
    jflat = flat(jax.tree.map(np.asarray, jg))
    tflat = flat(tp)
    assert set(tflat) == set(jflat)
    for path, t in tflat.items():
        assert t.grad is not None, path
        np.testing.assert_allclose(_np(t.grad), jflat[path], err_msg=str(path),
                                   **TOL)


