"""Port parity: the Whisper encoder-decoder (``repro_torch.models.encdec``)
vs the JAX package.

Weights come from the reference's ``encdec.init_params``, go through
numpy and ``convert.params_from_jax`` (which unstacks its ``enc_blocks``
and ``dec_blocks``), and both packages run the same seeded frames and
tokens on the CPU.  The float32 smoke config is held at the LM tests'
tolerances: 1e-4 on logits and the loss, 1e-5 on the encoder's output and
the caches.

The bfloat16 override with float32 frames (what ``serve`` passes to the
published bfloat16 config) follows jnp's promotion, and each stage's
dtype is asserted equal to the reference's: a float32 encoder and cross
K/V, a float32 decoder stream after the first cross-attention in a
prefill, bfloat16 self caches, a bfloat16 stream in decode.  The
reference's ``prefill`` and ``loss_fn`` raise on that input (their layer
``scan`` refuses a carry whose dtype changes), so there the port is held
to the reference's own blocks run layer by layer (``_dec_block``), and
to its ``decode_step`` (which scans: its stream keeps its dtype), at the
bfloat16 tolerance 2e-2.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import base as jbase
from repro.launch import serve_lm as jserve
from repro.models import attention as jattention
from repro.models import encdec as jed
from repro_torch.configs import base as tbase
from repro_torch.launch import serve_lm
from repro_torch.models import attention, encdec
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import Model

TOL = 1e-4
BF16_TOL = 2e-2
B, S = 2, 20
ARCH = "whisper_small"


def _close(got, want, tol=TOL, msg=""):
    if torch.is_tensor(got):
        got = got.detach().float()
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol, err_msg=msg)


def _same_dtype(t: torch.Tensor, a) -> bool:
    """A tensor's dtype against a JAX array's, by name."""
    return str(t.dtype).removeprefix("torch.") == str(a.dtype)


def _setup(dtype: str):
    jcfg = jbase.get_smoke_config(ARCH).replace(dtype=dtype)
    tcfg = tbase.get_smoke_config(ARCH).replace(dtype=dtype)
    jparams = jed.init_params(jax.random.PRNGKey(1), jcfg)
    model = Model(tcfg, device="cpu")
    params = model.load(params_from_jax(tcfg, jax.tree.map(np.asarray,
                                                           jparams)))
    rng = np.random.default_rng(2)
    frames = rng.normal(size=(B, jcfg.encoder_seq, jcfg.d_model)).astype(
        np.float32)
    toks = rng.integers(0, jcfg.vocab_size, (B, S))
    return jcfg, jparams, model, params, frames, toks


@pytest.fixture(scope="module")
def f32():
    return _setup("float32")


@pytest.fixture(scope="module")
def bf16():
    return _setup("bfloat16")


def _layer(tree, i):
    return jax.tree.map(lambda a: a[i], tree)


def test_converted_state_unstacks_both_stacks(f32):
    jcfg, jparams, _, params, _, _ = f32
    state = params.state_dict()
    n_enc = len(jax.tree.leaves(jparams["enc_blocks"]))
    n_dec = len(jax.tree.leaves(jparams["dec_blocks"]))
    assert len(state) == len(jax.tree.leaves(jparams)) - n_enc - n_dec \
        + jcfg.encoder_layers * n_enc + jcfg.num_layers * n_dec
    wk = np.array(jparams["dec_blocks"]["cross_attn"]["wk"][1])
    assert torch.equal(params.dec_blocks[1].cross_attn["wk"],
                       torch.from_numpy(wk))
    w_in = np.array(jparams["enc_blocks"]["mlp"]["w_in"][0])
    assert torch.equal(params.enc_blocks[0].mlp["w_in"],
                       torch.from_numpy(w_in))
    with pytest.raises(NotImplementedError, match="prefill"):
        Model(tbase.get_smoke_config(ARCH), device="cpu").init_caches(2, 8)


def test_sinusoidal_matches_reference():
    pos = np.arange(50, dtype=np.int32)
    for d in (2, 64, 768):
        got = encdec.sinusoidal(torch.from_numpy(pos), d)
        assert got.dtype == torch.float32 and got.shape == (50, d)
        _close(got, jed.sinusoidal(jnp.asarray(pos), d), 1e-5)


def test_encode_and_cross_caches_match(f32):
    jcfg, jparams, _, params, frames, _ = f32
    want = jed.encode(jparams, jnp.asarray(frames), jcfg)
    with torch.no_grad():
        got = encdec.encode(params, torch.from_numpy(frames))
    _close(got, want, 1e-5, "encoder output")
    jcross = jed.make_cross_caches(jparams, want, jcfg)
    with torch.no_grad():
        cross = encdec.make_cross_caches(params, got)
    assert len(cross) == jcfg.num_layers
    for i, c in enumerate(cross):
        assert c.length == jcfg.encoder_seq == int(jcross.length[i])
        _close(c.k, jcross.k[i], 1e-5, f"layer {i} cross k")
        _close(c.v, jcross.v[i], 1e-5, f"layer {i} cross v")


def test_loss_matches(f32):
    jcfg, jparams, model, params, frames, toks = f32
    jt = jnp.asarray(toks, jnp.int32)
    batch = {"frames": jnp.asarray(frames), "inputs": jt,
             "targets": jnp.roll(jt, -1, axis=1),
             "mask": jnp.ones((B, S), jnp.float32).at[1, -4:].set(0.0)}
    jloss, jmetrics = jed.loss_fn(jparams, batch, jcfg, None)
    with torch.no_grad():
        loss, metrics = model.loss_fn(
            params, {k: torch.from_numpy(np.array(v))
                     for k, v in batch.items()})
    _close(loss, jloss)
    _close(metrics["ce"], jmetrics["ce"])
    assert float(metrics["aux"]) == 0.0 == float(jmetrics["aux"])


def test_prefill_caches_and_teacher_forced_decode_match(f32):
    jcfg, jparams, model, params, frames, toks = f32
    jt = jnp.asarray(toks, jnp.int32)
    tt = torch.from_numpy(toks)
    half = S // 2
    jlogits, (jself, jcross) = jed.prefill(
        jparams, jnp.asarray(frames), jt[:, :half], jcfg, None, max_len=S)
    step = jax.jit(lambda p, t, c: jed.decode_step(p, t, c, jcfg, None))
    jsteps, jc = [], (jself, jcross)
    for t in range(half, S):
        lg, jc = step(jparams, jt[:, t:t + 1], jc)
        jsteps.append(np.asarray(lg[:, 0]))
    batch = {"frames": torch.from_numpy(frames), "tokens": tt[:, :half]}
    logits, (self_caches, cross) = model.prefill(params, batch, max_len=S)
    assert logits.shape == (B, 1, jcfg.padded_vocab)
    _close(logits, jlogits, msg="prefill logits")
    for i in range(jcfg.num_layers):
        assert self_caches[i].length == half
        _close(self_caches[i].k, jself.k[i], 1e-5, f"layer {i} self k")
        _close(self_caches[i].v, jself.v[i], 1e-5, f"layer {i} self v")
        _close(cross[i].k, jcross.k[i], 1e-5, f"layer {i} cross k")
    with torch.no_grad():
        enc = encdec.encode(params, batch["frames"])
        full = encdec.logits_from_hidden(
            params, encdec.decoder_hidden(params, enc, tt))
    caches = (self_caches, cross)
    for i, t in enumerate(range(half, S)):
        lg, caches = model.decode_step(params, tt[:, t:t + 1], caches)
        _close(lg[:, 0], jsteps[i], msg=f"decode step {t}")
        _close(lg[:, 0], full[:, t], msg=f"decode vs full at {t}")
    assert caches[0][0].length == S
    _close(caches[0][1].k, jc[0].k[1], 1e-5, "self k after decode")


def test_greedy_serve_matches_reference():
    """``serve`` draws the frames right after the prompts from the seed's
    generator, as the reference's does: the same greedy tokens."""
    kw = dict(batch=3, prompt_len=9, gen_len=7, max_len=16, seed=5)
    want, _ = jserve.serve(ARCH, smoke=True, verbose=False, **kw)
    jcfg = jbase.get_smoke_config(ARCH)
    tcfg = tbase.get_smoke_config(ARCH)
    tree = jax.tree.map(np.asarray, jed.init_params(jax.random.PRNGKey(0),
                                                    jcfg))
    params = Model(tcfg, device="cpu").load(params_from_jax(tcfg, tree))
    got, stats = serve_lm.serve(ARCH, device="cpu", params=params,
                                verbose=False, **kw)
    np.testing.assert_array_equal(got, np.asarray(want))
    inputs = serve_lm.make_inputs(tcfg.vocab_size, 3, 9, 5,
                                  (tcfg.encoder_seq, tcfg.d_model))
    rng = np.random.default_rng(5)
    rng.integers(0, tcfg.vocab_size, (3, 9), dtype=np.int32)
    assert inputs["frames"].dtype == np.float32
    np.testing.assert_array_equal(
        inputs["frames"], np.asarray(jnp.asarray(rng.normal(
            size=(3, tcfg.encoder_seq, tcfg.d_model)), jnp.float32)))


def _reference_prefill_by_layer(jcfg, jparams, frames, tokens, max_len):
    """The reference's prefill with its layer scan unrolled: its own
    ``encode``, ``make_cross_caches`` and ``_dec_block`` per layer."""
    enc = jed.encode(jparams, frames, jcfg)
    cross = jed.make_cross_caches(jparams, enc, jcfg)
    s = tokens.shape[1]
    x = jparams["embed"]["embedding"][tokens]
    x = x + jed.sinusoidal(jnp.arange(s), jcfg.d_model).astype(x.dtype)
    spec = jed._spec(jcfg, causal=True)
    streams, caches = [], []
    for i in range(jcfg.num_layers):
        sc = jattention.init_cache(tokens.shape[0], max_len, spec,
                                   dtype=jnp.dtype(jcfg.dtype))
        x, sc = jed._dec_block(_layer(jparams["dec_blocks"], i), x, jcfg,
                               enc, self_cache=sc, decode=False)
        streams.append(x)
        caches.append(sc)
    h = jed.layers.layernorm(jparams["final_norm"], x[:, -1:, :])
    logits = jed.layers.unembed(jparams["embed"], h)
    stacked = jax.tree.map(lambda *a: jnp.stack(a), *caches)
    return enc, cross, streams, logits, stacked


def test_bfloat16_promotion_follows_reference(bf16):
    jcfg, jparams, model, params, frames, toks = bf16
    jt = jnp.asarray(toks, jnp.int32)
    jf = jnp.asarray(frames)
    half = S // 2
    with pytest.raises(TypeError, match="carry"):
        jed.prefill(jparams, jf, jt[:, :half], jcfg, None, max_len=S)
    enc_j, cross_j, streams_j, logits_j, self_j = \
        _reference_prefill_by_layer(jcfg, jparams, jf, jt[:, :half], S)

    tf = torch.from_numpy(frames)
    tt = torch.from_numpy(toks)
    with torch.no_grad():
        enc = encdec.encode(params, tf)
    assert enc.dtype == torch.float32 and _same_dtype(enc, enc_j)
    _close(enc, enc_j, BF16_TOL, "encoder output")
    with torch.no_grad():
        cross = encdec.make_cross_caches(params, enc)
    assert cross[0].k.dtype == torch.float32 and _same_dtype(cross[0].k,
                                                             cross_j.k)
    # The stream after each layer of the prompt: layer 0's cross-attention
    # output is float32 (its K/V are), so the stream is float32 on.
    x = encdec._embed(params, tt[:, :half], torch.arange(half))
    assert x.dtype == torch.bfloat16
    for i, p in enumerate(params.dec_blocks):
        cache = attention.init_cache(B, S, encdec._spec(params.cfg,
                                                        causal=True),
                                     dtype=torch.bfloat16, device="cpu")
        with torch.no_grad():
            x, cache = encdec._dec_block(params.cfg, p, x, enc,
                                         self_cache=cache)
        assert x.dtype == torch.float32 and _same_dtype(x, streams_j[i])
        assert cache.k.dtype == torch.bfloat16 and _same_dtype(cache.k,
                                                               self_j.k)
        _close(x, streams_j[i], BF16_TOL, f"stream after layer {i}")
    logits, (self_caches, cross) = model.prefill(
        params, {"frames": tf, "tokens": tt[:, :half]}, max_len=S)
    assert logits.dtype == torch.float32 and _same_dtype(logits, logits_j)
    _close(logits, logits_j, BF16_TOL, "prefill logits")
    for i in range(jcfg.num_layers):
        _close(self_caches[i].k, self_j.k[i], BF16_TOL, f"layer {i} self k")

    # Decode: the reference's decode_step scans (its stream keeps the
    # embedding's bfloat16); the port's stream does the same.
    jc = (self_j, cross_j)
    step = jax.jit(lambda p, t, c: jed.decode_step(p, t, c, jcfg, None))
    caches = (self_caches, cross)
    for t in range(half, S):
        lg_j, jc = step(jparams, jt[:, t:t + 1], jc)
        lg, caches = model.decode_step(params, tt[:, t:t + 1], caches)
        assert lg.dtype == torch.float32 and _same_dtype(lg, lg_j)
        _close(lg, lg_j, BF16_TOL, f"decode step {t}")
    xd = encdec._embed(params, tt[:, :1], torch.tensor([S]))
    layer0 = (attention.KVCache(caches[0][0].k.clone(),
                                caches[0][0].v.clone(), S - 1), caches[1][0])
    with torch.no_grad():
        y, _ = encdec._dec_block(params.cfg, params.dec_blocks[0], xd,
                                 self_cache=layer0[0], cross_cache=layer0[1],
                                 decode=True)
    assert y.dtype == torch.bfloat16

