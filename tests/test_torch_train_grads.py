"""Port parity: the loss and every gradient of the ten architectures'
smoke configs against ``jax.value_and_grad`` of the reference's
``loss_fn``.

Weights come from the reference's init through
``convert.params_from_jax``; a stacked reference gradient is unstacked the
same way.  Each gradient is held at 1e-4 of its leaf's largest element
(float32: two layers of products and their transposes summed in other
orders; rwkv6's WKV in chunks against the reference's own chunks).  Its
own file, so that the reference's ten compiles run on a worker of their
own.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import base as jbase
from repro.distributed.context import single_device_ctx
from repro.models import model as jmodel
from repro_torch.configs import base as tbase
from repro_torch.models import convert
from repro_torch.models.model import Model

TOL = 1e-4
B, S = 2, 16


@pytest.mark.parametrize("arch", tbase.ARCH_IDS)
def test_loss_and_grads_match_reference(arch):
    cfg, jcfg = tbase.get_smoke_config(arch), jbase.get_smoke_config(arch)
    jm = jmodel.build_model(jcfg)
    jparams = jax.jit(jm.init)(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:],
             "mask": (rng.random((B, S)) < 0.9).astype(np.float32)}
    if cfg.is_encdec:
        batch["frames"] = rng.normal(
            size=(B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    ctx = single_device_ctx()
    with ctx.mesh:
        (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
            lambda p, b: jm.loss_fn(p, b, ctx), has_aux=True))(
                jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    model = Model(cfg, device="cpu")
    params = model.load(convert.params_from_jax(
        cfg, jax.tree.map(np.asarray, jparams)))
    loss, metrics = model.loss_fn(params, {k: torch.from_numpy(v) for k, v
                                           in batch.items()})
    loss.backward()
    for got, want in ((loss, jloss), (metrics["ce"], jmetrics["ce"]),
                      (metrics["aux"], jmetrics["aux"])):
        np.testing.assert_allclose(float(got.detach()), float(want),
                                   rtol=TOL, atol=TOL)
    want = convert.params_from_jax(cfg, jax.tree.map(np.asarray, jgrads))
    grads = {k: p.grad for k, p in params.named_parameters()}
    assert grads.keys() == want.keys()
    for k, g in grads.items():
        assert g is not None and g.shape == want[k].shape, k
        w = want[k].double().numpy()
        err = np.abs(g.double().numpy() - w).max() / max(np.abs(w).max(),
                                                         1e-30)
        assert err <= TOL, f"{arch} {k}: {err:.3g} of the largest element"
