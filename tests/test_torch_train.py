"""Port parity: the LM training step (repro_torch.optim.adamw,
.data.tokens, .launch.steps, .launch.train) vs the JAX package.

Weights come from the reference's init, go through numpy and
``convert.params_from_jax`` into the port; both packages take the same
seeded batches on the CPU.  The reference's own ``train()`` builds its
mesh with ``jax.make_mesh``, whose ``Explicit`` axes its embedding gather
refuses on this jax, so its loop is driven here from its pieces
(``train_bundle`` on ``single_device_ctx()``, ``TokenStream``, ``AdamW``).

Tolerances: AdamW alone 1e-6 relative in float32 and at most one
bfloat16 ulp (the global norm sums each leaf in another order, a last-ulp
difference, and the last rounding can flip).  ``mu`` mixes its old value
with the clipped gradient, terms of either sign, so its 1e-6 is relative
to the sum of their magnitudes, which bounds the error that ulp leaves;
``nu`` and the parameters are relative to each leaf's largest element.
Two train steps: 1e-5 (float32 smoke configs: two layers of matmuls and
their gradients, summed in other orders), held as
``_torch_train_parity`` says.
"""
import shutil

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import base as jbase
from repro.data import tokens as jtokens
from repro.distributed.context import single_device_ctx
from repro.launch import steps as jsteps
from repro.models import model as jmodel
from repro.optim import adamw as jadamw
from repro_torch.checkpoint import ckpt
from repro_torch.configs import base as tbase
from repro_torch.data import tokens
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch import steps
from repro_torch.launch.train import train
from repro_torch.models import convert
from repro_torch.models.model import Model
from repro_torch.optim.adamw import AdamW, OptState, decayed_names

from _torch_train_parity import check_train_step, port_state, rel_close


def _np(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _t2np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _within_bf16_ulp(got, want, msg=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-38))) - 7)
    bad = np.abs(got - want) > ulp
    assert not bad.any(), f"{msg}: {int(bad.sum())} elements over 1 ulp"


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

OPTS = [AdamW(), AdamW(lr=1e-3, warmup_steps=10, total_steps=50,
                       min_lr_ratio=0.2)]


@pytest.mark.parametrize("opt", OPTS, ids=["defaults", "short"])
def test_schedule_matches_reference(opt):
    ref = jadamw.AdamW(**{f: getattr(opt, f) for f in
                          opt.__dataclass_fields__})
    mid = (opt.warmup_steps + opt.total_steps) // 2
    for count in (1, opt.warmup_steps, mid, opt.total_steps,
                  opt.total_steps + 5):
        got = opt.schedule(torch.tensor(count, dtype=torch.int32))
        want = ref.schedule(jnp.asarray(count, jnp.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        rel_close(_t2np(got), _np(want), 1e-6, f"count {count}")


def _ref_flat(tree) -> dict:
    """A nested tree's leaves by their dotted paths."""
    return {".".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _random_tree(rng, dtype, grad_scale):
    """(reference params, grads) and the port's flat dicts of the same
    values: ranks 0-3, nested names the port joins with dots."""
    shapes = {"w": (8, 6), "b": (6,), "s": (), "deep": {"k": (3, 4, 5),
                                                         "v": (5,)}}
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32

    def draw(scale):
        host = jax.tree.map(
            lambda shape: np.asarray(rng.normal(size=shape) * scale,
                                     np.float32), shapes,
            is_leaf=lambda x: isinstance(x, tuple))
        # Copies: the port updates its tensors in place, and a jax array
        # on the host may alias the numpy buffer it was made from.
        flat = {k: torch.tensor(v, dtype=dtype)
                for k, v in _ref_flat(host).items()}
        return jax.tree.map(lambda a: jnp.asarray(a, jdt), host), flat

    (jp, tp), (jg, tg) = draw(1.0), draw(grad_scale)
    return jp, jg, tp, tg


@pytest.mark.parametrize("clip", ["active", "inactive"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_update_matches_reference(dtype, clip):
    rng = np.random.default_rng(3)
    grad_scale = 10.0 if clip == "active" else 0.01
    jp, jg, tp, tg = _random_tree(rng, dtype, grad_scale)
    opt = AdamW(lr=1e-2, warmup_steps=2, total_steps=6)
    ref = jadamw.AdamW(lr=1e-2, warmup_steps=2, total_steps=6)
    jstate, state = ref.init(jp), opt.init(tp)
    ref_update = jax.jit(ref.update)      # as the reference's step runs it
    for step in range(3):
        prev_mu, grads = _ref_flat(jstate.mu), _ref_flat(jg)
        jp, jstate, jm = ref_update(jp, jg, jstate)
        state, m = opt.update(tp, tg, state)
        gnorm = float(_np(jm["grad_norm"]))
        assert (gnorm > 1.0) == (clip == "active")
        rel_close(_t2np(m["grad_norm"]), gnorm, 1e-6, "grad_norm")
        rel_close(_t2np(m["lr"]), _np(jm["lr"]), 1e-6, "lr")
        assert int(state.count) == int(jstate.count) == step + 1
        for name, want in _ref_flat(jp).items():
            got = tp[name]
            assert got.dtype == dtype, name
            if dtype == torch.bfloat16:
                _within_bf16_ulp(_t2np(got), _np(want), f"{name} {step}")
            else:
                rel_close(_t2np(got), _np(want), 1e-6, f"{name} {step}")
        clip_scale = min(1.0, ref.grad_clip / max(gnorm, 1e-9))
        for name, want in _ref_flat(jstate.nu).items():
            assert state.nu[name].dtype == torch.float32
            rel_close(_t2np(state.nu[name]), _np(want), 1e-6, f"nu {name}")
        for name, want in _ref_flat(jstate.mu).items():
            terms = ref.b1 * np.abs(_np(prev_mu[name])) + (1 - ref.b1) \
                * np.abs(_np(grads[name])) * clip_scale
            err = np.abs(_t2np(state.mu[name]) - _np(want)) / terms
            assert state.mu[name].dtype == torch.float32
            assert err.max() <= 1e-6, f"mu {name}: {err.max():.3g}"
        # Next step's grads: new draws, the same in both packages.
        _, jg, _, tg = _random_tree(rng, dtype, grad_scale)


def _nonzero_reference_tree(tree, rng):
    """Every leaf redrawn nonzero (norm scales and biases too: from their
    zero init, decay would be invisible)."""
    return jax.tree.map(lambda a: jnp.asarray(
        rng.uniform(0.5, 1.5, np.shape(a)) * rng.choice([-1.0, 1.0],
                                                        np.shape(a)),
        a.dtype), tree)


DECAY_ARCHS = ["qwen1_5_0_5b", "rwkv6_3b", "whisper_small",
               "recurrentgemma_2b"]


@pytest.mark.parametrize("arch", DECAY_ARCHS)
def test_decay_rule_matches_reference(arch):
    """One update of a whole smoke model's tree, every leaf nonzero, at a
    rate where decay moves each leaf by 1 %: each leaf equals the
    reference's after unstacking.  Stacked per-layer vectors decay
    (qwen, rwkv6, whisper); recurrentgemma's per-layer list does not."""
    rng = np.random.default_rng(4)
    cfg = tbase.get_smoke_config(arch)
    jcfg = jbase.get_smoke_config(arch)
    jp = _nonzero_reference_tree(
        jax.jit(jmodel.build_model(jcfg).init)(jax.random.PRNGKey(0)), rng)
    jg = _nonzero_reference_tree(jp, rng)
    params = Model(cfg, device="cpu").load(
        convert.params_from_jax(cfg, jax.tree.map(np.asarray, jp)))
    grads = {k: v for k, v in convert.params_from_jax(
        cfg, jax.tree.map(np.asarray, jg)).items()}
    opt = AdamW(lr=0.1, warmup_steps=1)
    ref = jadamw.AdamW(lr=0.1, warmup_steps=1)
    jp, _, _ = jax.jit(ref.update)(jp, jg, ref.init(jp))
    opt.update(params, grads, opt.init(params))
    want = convert.params_from_jax(cfg, jax.tree.map(np.asarray, jp))
    got = params.state_dict()
    assert got.keys() == want.keys()
    for name in want:
        rel_close(_t2np(got[name]), want[name].float().numpy(), 1e-6, name)
    vectors = {k for k, p in got.items() if p.ndim == 1}
    decayed_vectors = vectors & decayed_names(params)
    if arch == "recurrentgemma_2b":
        assert not decayed_vectors
    else:
        assert decayed_vectors and all(
            convert.reference_stacked(cfg, k) for k in decayed_vectors)
        assert "final_norm.scale" not in decayed_vectors


# ---------------------------------------------------------------------------
# Token stream
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,seq,batch,seed", [(512, 32, 4, 0),
                                                  (151936, 17, 3, 5)])
def test_token_stream_bitwise_equal_reference(vocab, seq, batch, seed):
    mine = tokens.TokenStream(vocab, seq, batch, seed=seed)
    ref = jtokens.TokenStream(vocab, seq, batch, seed=seed)
    for step in (0, 1, 7, 1000):
        got, want = mine.batch_at(step), ref.batch_at(step)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_pack_documents_equals_reference():
    rng = np.random.default_rng(6)
    for m in (1, 3, 8):
        lengths = rng.integers(1, 4096, 37).tolist()
        assert tokens.pack_documents(lengths, 4096, m) == \
            jtokens.pack_documents(lengths, 4096, m)


# ---------------------------------------------------------------------------
# Train steps against the reference's train_bundle
# ---------------------------------------------------------------------------

def _batch(b: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


@pytest.mark.parametrize("arch", ["qwen1_5_0_5b", "mistral_nemo_12b"])
def test_train_steps_match_reference_train_bundle(arch):
    """Two steps of ``train_bundle`` against the reference's, held as
    ``_torch_train_parity.check_train_step`` says (Adam's per-element
    normalization makes the parameters ill-conditioned in the gradients
    where a gradient is near ``eps``)."""
    cfg, jcfg = tbase.get_smoke_config(arch), jbase.get_smoke_config(arch)
    shape_t = tbase.ShapeConfig("custom", 32, 4, "train")
    shape_j = jbase.ShapeConfig("custom", 32, 4, "train")
    opt = AdamW(lr=1e-2, warmup_steps=1, total_steps=4)
    jopt = jadamw.AdamW(lr=1e-2, warmup_steps=1, total_steps=4)
    ctx = single_device_ctx()
    jbundle = jsteps.train_bundle(jcfg, shape_j, ctx, jopt)
    bundle = steps.train_bundle(cfg, shape_t, opt, device="cpu")
    jparams = jax.jit(jmodel.build_model(jcfg).init)(jax.random.PRNGKey(0))
    params = Model(cfg, device="cpu").load(convert.params_from_jax(
        cfg, jax.tree.map(np.asarray, jparams)))
    jstate, state = jopt.init(jparams), opt.init(params)
    stream = tokens.TokenStream(cfg.vocab_size, 32, 4)
    for step in range(2):
        host = stream.batch_at(step)
        before = port_state(params)
        with ctx.mesh:
            jparams, jstate, jm = jbundle.fn(
                jparams, jstate, {k: jnp.asarray(v) for k, v in host.items()})
        params, state, m = bundle.fn(params, state, _batch(host))
        check_train_step(opt, params, state, m, before, jparams, jstate, jm,
                         f"{arch} step {step}")


def test_bundle_args_are_meta_tensors_of_the_reference_shapes():
    cfg, jcfg = (tbase.get_smoke_config("qwen1_5_0_5b"),
                 jbase.get_smoke_config("qwen1_5_0_5b"))
    shape = tbase.ShapeConfig("custom", 32, 4, "train")
    params, opt_state, batch = steps.train_bundle(cfg, shape,
                                                  device="cpu").args
    want = convert.params_from_jax(cfg, jax.tree.map(
        lambda sds: np.zeros(sds.shape, np.float32),
        jmodel.build_model(jcfg).param_shapes()))
    assert {k: tuple(v.shape) for k, v in params.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    assert all(t.is_meta for t in params.values())
    assert isinstance(opt_state, OptState) and opt_state.count.shape == ()
    assert all(t.dtype == torch.float32 for t in opt_state.mu.values())
    assert {k: (tuple(v.shape), v.dtype) for k, v in batch.items()} == {
        "inputs": ((4, 32), torch.int32), "targets": ((4, 32), torch.int32),
        "mask": ((4, 32), torch.float32)}
    for kind, name in (("train", "train_step"), ("prefill", "prefill"),
                       ("decode", "serve_step")):
        b = steps.bundle_for(cfg, tbase.ShapeConfig("c", 32, 4, kind),
                             device="cpu")
        assert b.description.startswith(name)
    whisper = tbase.get_smoke_config("whisper_small")
    _, token, (self_caches, cross) = steps.decode_bundle(
        whisper, tbase.ShapeConfig("c", 32, 2, "decode"), device="cpu").args
    assert token.shape == (2, 1) and len(self_caches) == whisper.num_layers
    assert cross[0].k.shape == (2, whisper.encoder_seq,
                                whisper.num_kv_heads, whisper.head_dim)


def test_prefill_and_decode_bundles_match_serve_path():
    cfg = tbase.get_smoke_config("qwen1_5_0_5b")
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 8)))
    pre = steps.prefill_bundle(cfg, tbase.ShapeConfig("p", 16, 2, "prefill"),
                               device="cpu")
    first, caches = pre.fn(params, {"tokens": toks})
    logits, _ = model.prefill(params, {"tokens": toks}, max_len=16)
    assert first.dtype == torch.int32
    assert torch.equal(first, torch.argmax(logits, -1).int())
    dec = steps.decode_bundle(cfg, tbase.ShapeConfig("d", 16, 2, "decode"),
                              device="cpu")
    nxt, caches = dec.fn(params, first, caches)
    assert nxt.shape == (2, 1) and caches[0].length == 9


# ---------------------------------------------------------------------------
# Rematerialisation and resume
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen1_5_0_5b", "rwkv6_3b"])
def test_remat_full_equals_none_bitwise(arch, monkeypatch):
    """Recomputing each block in the backward pass changes no bit of the
    loss or any gradient; the flash op runs twice per attention layer with
    ``remat="full"`` (the forward and its recompute), once without."""
    calls = []
    forward = fa_ops._forward
    monkeypatch.setattr(fa_ops, "_forward",
                        lambda *a: calls.append(1) or forward(*a))
    base = tbase.get_smoke_config(arch)
    jparams = jmodel.build_model(jbase.get_smoke_config(arch)).init(
        jax.random.PRNGKey(0))
    state = convert.params_from_jax(base, jax.tree.map(np.asarray, jparams))
    batch = _batch(tokens.TokenStream(base.vocab_size, 45, 2).batch_at(0))
    out = {}
    for remat in ("full", "none"):
        cfg = base.replace(remat=remat)
        params = Model(cfg, device="cpu").load(state)
        calls.clear()
        loss, _ = Model(cfg, device="cpu").loss_fn(params, batch)
        loss.backward()
        out[remat] = (loss.detach(), {k: p.grad for k, p in
                                      params.named_parameters()}, len(calls))
    attn_layers = sum(cfg.block_kind(i) == "attn"
                      for i in range(cfg.num_layers))
    assert out["full"][2] == 2 * attn_layers
    assert out["none"][2] == attn_layers
    assert torch.equal(out["full"][0], out["none"][0])
    for k, g in out["none"][1].items():
        assert torch.equal(out["full"][1][k], g), k


def test_train_resumed_after_kill_equals_uninterrupted(tmp_path):
    """A run killed after its first checkpoint and rerun equals the run
    that went through, bitwise: losses of the resumed steps, the final
    checkpoint's every leaf."""
    kw = dict(steps=6, seq_len=32, global_batch=4, ckpt_every=3,
              log_every=1, device="cpu", verbose=False)
    whole = train("qwen1_5_0_5b", ckpt_dir=str(tmp_path / "a"), **kw)
    killed = tmp_path / "b"
    killed.mkdir()
    shutil.copytree(tmp_path / "a" / "step_00000003",
                    killed / "step_00000003")
    resumed = train("qwen1_5_0_5b", ckpt_dir=str(killed), **kw)
    assert [h["step"] for h in whole] == list(range(6))
    assert [h["step"] for h in resumed] == [3, 4, 5]
    for a, b in zip(whole[3:], resumed):
        for k in ("loss", "ce", "aux", "grad_norm", "lr"):
            assert a[k] == b[k], (a["step"], k)
    want, meta, step = ckpt.read(tmp_path / "a")
    got, _, _ = ckpt.read(killed)
    assert step == 6 and meta == {"arch": "qwen1_5_0_5b", "done": True}
    assert got.keys() == want.keys()
    assert "1/count" in want and int(want["1/count"]) == 6
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_train_rejects_encdec_and_foreign_params():
    with pytest.raises(NotImplementedError):
        train("whisper_small", steps=1, device="cpu", verbose=False)
    other = Model(tbase.get_smoke_config("mistral_nemo_12b"),
                  device="cpu").init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="params are of"):
        train("qwen1_5_0_5b", steps=1, device="cpu", params=other,
              verbose=False)
