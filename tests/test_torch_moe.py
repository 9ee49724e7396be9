"""Port parity: the mixture-of-experts layer and layernorm
(repro_torch.models.moe, .layers) vs the JAX package.

Weights come from the reference's ``init_moe`` through numpy; both
packages run the same seeded float32 tokens on the CPU, the reference on
its (1, 1) mesh (``single_device_ctx``), where its ``all_to_all`` and
``psum`` paths are single-device math.  ``y`` and the aux loss are held
at atol = rtol = 1e-5 (float32 products summed in other orders); router
expert ids, the dispatch (token, slot, expert, position) and ``keep``
must be equal.  Capacity factors 1.0 and 0.5 at T = 64, E = 4 drop
tokens under both capacity rules (floor for the full sequence, ceiling
for decode).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import base as jbase
from repro.distributed.context import single_device_ctx
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models import transformer as jtr
from repro_torch.configs import base as tbase
from repro_torch.models import layers, moe, transformer
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import Model

TOL = 1e-5
D, F_FF, E = 32, 48, 4
B, S = 4, 16                       # T = 64 tokens

# (name, router, top_k)
ROUTERS = [("sigmoid_top1", "sigmoid", 1), ("softmax_top2", "softmax", 2)]


@pytest.fixture(scope="module")
def ctx():
    return single_device_ctx()


def _spec(router_type, top_k, cf, pkg):
    return pkg.MoESpec(d_model=D, d_ff=F_FF, num_experts=E, top_k=top_k,
                       capacity_factor=cf, router_type=router_type)


def _weights(spec, seed=0):
    tree = jmoe.init_moe(jax.random.PRNGKey(seed), spec)
    return tree, {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _tokens(seed=1, shape=(B, S, D)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol, err_msg=msg)


@pytest.mark.parametrize("decode", [False, True], ids=["full", "decode"])
@pytest.mark.parametrize("cf", [1.0, 0.5, 8.0])
@pytest.mark.parametrize("name,router_type,top_k", ROUTERS,
                         ids=[r[0] for r in ROUTERS])
def test_moe_apply_matches_reference(name, router_type, top_k, cf, decode,
                                     ctx):
    jspec = _spec(router_type, top_k, cf, jmoe)
    tspec = _spec(router_type, top_k, cf, moe)
    jw, tw = _weights(jspec)
    x = _tokens()
    with ctx.mesh:
        jy, jaux = jmoe.moe_apply(jw, jnp.asarray(x), jspec, ctx,
                                  decode=decode)
    y, aux = moe.moe_apply(tw, torch.from_numpy(x), tspec, decode=decode)
    assert y.dtype == torch.float32 and y.shape == x.shape
    assert aux.dtype == torch.float32 and aux.shape == ()
    _close(y, jy, msg="y")
    _close(aux, jaux, msg="aux")

    # The routing and dispatch themselves, at the capacity this path uses.
    t = B * S
    want_cap = (max(1, int(-(-t * top_k * cf // E))) if decode
                else max(1, int(t * top_k * cf / E)))
    cap = moe.expert_capacity(t, tspec, decode=decode)
    assert cap == want_cap
    tok = x.reshape(t, D)
    jg, jidx, jprobs = jmoe._route(jnp.asarray(tok), jw["router"], jspec)
    g, idx, probs = moe._route(torch.from_numpy(tok), tw["router"], tspec)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    _close(g, jg)
    _close(probs, jprobs)
    want = jmoe._dispatch_indices(jidx, jspec, cap)
    got = moe._dispatch_indices(idx, tspec, cap)
    for field, a, b in zip(("token", "slot", "expert", "pos", "keep"),
                           want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                      err_msg=field)
    keep = got[4]
    if cf < 8.0:                 # tokens really drop at these factors
        assert not bool(keep.all())
    else:
        assert bool(keep.all())


@pytest.mark.parametrize("decode", [False, True], ids=["full", "decode"])
@pytest.mark.parametrize("name,router_type,top_k", ROUTERS,
                         ids=[r[0] for r in ROUTERS])
def test_router_ties_take_the_lower_expert_first(name, router_type, top_k,
                                                 decode, ctx):
    """Equal router columns tie every expert: the lower ids win, as
    ``jax.lax.top_k`` orders them, and the whole layer still matches."""
    jspec = _spec(router_type, top_k, 1.0, jmoe)
    tspec = _spec(router_type, top_k, 1.0, moe)
    jw, tw = _weights(jspec, seed=3)
    col = np.asarray(jw["router"])[:, :1]
    router = np.repeat(col, E, axis=1)
    # Experts 1 and 2 also tie each other, one step below expert 3.
    router[:, 3] *= 2.0
    jw["router"] = jnp.asarray(router)
    tw["router"] = torch.from_numpy(router.copy())
    x = np.abs(_tokens(seed=4))
    tok = x.reshape(-1, D)
    _, jidx, _ = jmoe._route(jnp.asarray(tok), jw["router"], jspec)
    _, idx, _ = moe._route(torch.from_numpy(tok), tw["router"], tspec)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    scores = tok @ router
    top = np.where(scores[:, 3] > scores[:, 0], 3, 0)
    assert (idx[:, 0].numpy() == top).all()
    if top_k == 2:
        # The runner-up among the tied experts 0-2 is the lowest id left.
        assert (idx[:, 1].numpy() == np.where(top == 3, 0, 1)).all()
    with ctx.mesh:
        jy, jaux = jmoe.moe_apply(jw, jnp.asarray(x), jspec, ctx,
                                  decode=decode)
    y, aux = moe.moe_apply(tw, torch.from_numpy(x), tspec, decode=decode)
    _close(y, jy)
    _close(aux, jaux)


def test_top_k_is_a_stable_descending_sort():
    scores = torch.tensor([[0.5, 0.5, 0.5, 0.5], [0.1, 0.7, 0.7, 0.2],
                           [0.3, 0.9, 0.3, 0.9]])
    values, idx = moe._top_k(scores, 3)
    assert idx.tolist() == [[0, 1, 2], [1, 2, 3], [1, 3, 0]]
    jv, jidx = jax.lax.top_k(jnp.asarray(scores.numpy()), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(values.numpy(), np.asarray(jv))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_reference(dtype):
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(3, 7, 64)) * 3 + 1.5).astype(np.float32)
    scale = rng.normal(size=(64,)).astype(np.float32) * 0.1
    bias = rng.normal(size=(64,)).astype(np.float32) * 0.1
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = jlayers.layernorm({"scale": jnp.asarray(scale, jdt),
                              "bias": jnp.asarray(bias, jdt)},
                             jnp.asarray(x, jdt))
    got = layers.layernorm(torch.from_numpy(scale).to(tdt),
                           torch.from_numpy(bias).to(tdt),
                           torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    tol = 1e-5 if dtype == "float32" else 1e-2
    _close(got.float(), np.asarray(want, np.float32), tol)
    # Zero scale and bias (their init) is the plain normalisation.
    zero = torch.zeros(64)
    plain = torch.nn.functional.layer_norm(torch.from_numpy(x), (64,),
                                           eps=1e-5)
    _close(layers.layernorm(zero, zero, torch.from_numpy(x)), plain, 1e-5)


@pytest.mark.parametrize("arch", ["llama4_scout_17b_a16e", "dbrx_132b"])
def test_router_stays_float32_in_a_bfloat16_config(arch):
    """``init_params`` draws the router in float32 (fan-in d_model), and
    ``Model.load`` keeps the reference's float32 router bitwise, while
    every other leaf takes the config's bfloat16."""
    tcfg = tbase.get_smoke_config(arch).replace(dtype="bfloat16")
    jcfg = jbase.get_smoke_config(arch).replace(dtype="bfloat16")
    model = Model(tcfg, device="cpu")
    drawn = model.init(torch.Generator().manual_seed(0))
    jtree = jax.tree.map(np.asarray, jtr.init_params(jax.random.PRNGKey(2),
                                                     jcfg))
    loaded = model.load(params_from_jax(tcfg, jtree))
    for params in (drawn, loaded):
        for name, t in params.state_dict().items():
            want = torch.float32 if name.endswith("moe.router") \
                else torch.bfloat16
            assert t.dtype == want, name
    router = drawn.blocks[0].moe["router"].detach()
    assert router.shape == (tcfg.d_model, tcfg.num_experts)
    std = float(router.std())
    assert 0.6 * tcfg.d_model ** -0.5 < std < 1.2 * tcfg.d_model ** -0.5
    for i in range(tcfg.num_layers):
        np.testing.assert_array_equal(
            loaded.blocks[i].moe["router"].detach().numpy(),
            np.asarray(jtree["blocks"]["moe"]["router"][i], np.float32))
    # A bfloat16 forward with the float32 router runs on the host.
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, tcfg.vocab_size, (2, 8)))
    with torch.no_grad():
        loss, metrics = model.loss_fn(loaded, {
            "inputs": toks, "targets": torch.roll(toks, -1, 1),
            "mask": torch.ones(2, 8)})
    assert np.isfinite(float(loss)) and float(metrics["aux"]) > 0


@pytest.mark.parametrize("arch", ["llama4_scout_17b_a16e", "dbrx_132b"])
def test_moe_and_layernorm_leaves_convert_by_name(arch):
    """``params_from_jax`` unstacks the scanned MoE and layernorm leaves
    by name: each layer's router, expert stacks, shared expert and norm
    bias equal the reference's slice bitwise."""
    jcfg = jbase.get_smoke_config(arch)
    tcfg = tbase.get_smoke_config(arch)
    jtree = jax.tree.map(np.asarray, jtr.init_params(jax.random.PRNGKey(1),
                                                     jcfg))
    state = params_from_jax(tcfg, jtree)
    assert set(state) == set(transformer.param_shapes(tcfg))
    names = [f"moe.{k}" for k in ("router", "w_gate", "w_up", "w_down")]
    if tcfg.moe_shared_expert:
        names += [f"shared.{k}" for k in ("w_gate", "w_up", "w_down")]
    if tcfg.norm_type == "layernorm":
        names += ["norm1.scale", "norm1.bias", "norm2.scale", "norm2.bias"]
        np.testing.assert_array_equal(state["final_norm.bias"].numpy(),
                                      jtree["final_norm"]["bias"])
    for i in range(tcfg.num_layers):
        for name in names:
            node = jtree["blocks"]
            for part in name.split("."):
                node = node[part]
            np.testing.assert_array_equal(state[f"blocks.{i}.{name}"].numpy(),
                                          node[i], err_msg=name)
