"""The recurrent and encoder-decoder families on LM meshes against the
reference's single-device results and the port's own single-device run.

Each family spawns four ``gloo`` ranks once (``_torch_mesh_ranks.family``)
and runs, on a (2, 2) and a (1, 4) ``("data", "model")`` mesh, with the
reference's float32 smoke weights (``convert.params_from_jax``):

* the loss of a batch against the reference's ``loss_fn`` at
  ``LOSS_RTOL``, and every gradient against the port's single-device
  backward (already held to the reference by ``test_torch_train_grads``)
  at ``GRAD_TOL`` of each leaf's largest element;
* greedy ``serve`` tokens equal to the port's single-device tokens, and
  the first two of them from the ``prefill_bundle`` and
  ``decode_bundle`` steps;
* every cache leaf those steps leave the block of its whole leaf that
  ``sharding.cache_specs`` gives the rank;
* one ``train_bundle`` step, its loss against the reference's.

The routes: rwkv6's WKV splits each head's key dim 2 and 4 ways (32 and
16 keys a rank); recurrentgemma's RG-LRU splits its 64 channels 2 and 4
ways, and its MQA local attention takes the heads route at model 2 and
the query-sequence route at model 4, with a 24-token prompt over its
16-slot window and decode past the wrap; whisper's 4 heads take the heads
route, and a (1, 4) override of 2 heads the query-sequence route, the
encoder's 32 frames and the cross caches split 8 a rank.

The two repaired faults of the mesh attention (cross-attention computed
as self-attention: ``apply_attention`` and ``decode_attention`` ignored
their source on a mesh) are held on a one-rank mesh in this process.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import base as tbase
from repro_torch.launch import serve_lm
from repro_torch.models.model import Model

import _torch_mesh_ranks as ranks
from test_torch_mesh import LOSS_RTOL, _batch, _ref_loss, _state, _torch

GRAD_TOL = 1e-4       # of each leaf's largest element

FAMILIES = {
    "rwkv6_3b": dict(
        meshes={"2x2": ((2, 2), {}), "1x4": ((1, 4), {})},
        seq=40, serve=dict(batch=4, prompt_len=12, gen_len=6, max_len=24)),
    "recurrentgemma_2b": dict(
        meshes={"2x2": ((2, 2), {}), "1x4": ((1, 4), {})},
        seq=40, serve=dict(batch=4, prompt_len=24, gen_len=8, max_len=32)),
    "whisper_small": dict(
        meshes={"2x2": ((2, 2), {}), "1x4": ((1, 4), {}),
                "1x4_query_split": ((1, 4), {"num_heads": 2,
                                             "num_kv_heads": 2,
                                             "head_dim": 32})},
        seq=32, serve=dict(batch=4, prompt_len=8, gen_len=5, max_len=16)),
}


def _frames(cfg, batch: int) -> np.ndarray:
    rng = np.random.default_rng(7)
    return rng.normal(size=(batch, cfg.encoder_seq, cfg.d_model)).astype(
        np.float32)


def _single(arch: str, overrides: dict, state: dict, batch: dict,
            serve: dict):
    """The port on one device: the loss's gradients and greedy tokens."""
    model = Model(tbase.get_smoke_config(arch).replace(**overrides),
                  device="cpu")
    params = model.load(state)
    loss, _ = model.loss_fn(params, batch)
    loss.backward()
    grads = {k: p.grad for k, p in params.named_parameters()}
    with torch.no_grad():
        tokens, _ = serve_lm.serve(arch, params=params, device="cpu",
                                   verbose=False, seed=3, **serve)
    return grads, tokens


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_family_on_meshes_matches_single_device(arch, tmp_path):
    fam = FAMILIES[arch]
    serve = dict(fam["serve"], seed=3)
    meshes, want = {}, {}
    for name, (shape, over) in fam["meshes"].items():
        jcfg, jparams, state = _state(arch, over)
        batch = _batch(jcfg.vocab_size, fam["seq"], 4)
        if jcfg.is_encdec:
            batch["frames"] = _frames(jcfg, 4)
        tbatch = _torch(batch)
        grads, tokens = _single(arch, over, state, tbatch, fam["serve"])
        want[name] = (_ref_loss(jcfg, jparams, batch)["ce"], grads, tokens)
        meshes[name] = (shape, over, state)
    out = ranks.run("family", tmp_path, {
        "arch": arch, "meshes": meshes, "batch": tbatch, "serve": serve})
    for name, (ce, grads, tokens) in want.items():
        got = out[name]
        msg = f"{arch} {name}"
        assert abs(float(got["ce"]) - ce) <= LOSS_RTOL * abs(ce), msg
        assert abs(float(got["step"]["ce"]) - ce) <= LOSS_RTOL * abs(ce), \
            msg
        assert got["grads"].keys() == grads.keys(), msg
        for k, g in grads.items():
            err = float((got["grads"][k] - g).abs().max())
            assert err <= GRAD_TOL * max(float(g.abs().max()), 1e-30), \
                (msg, k, err)
        np.testing.assert_array_equal(got["tokens"], tokens, err_msg=msg)
        np.testing.assert_array_equal(got["bundle_tokens"], tokens[:, :2],
                                      err_msg=msg)
        n, bad = got["cache_blocks"]
        assert n > 0 and not bad, (msg, bad)


@pytest.fixture()
def one_rank_mesh():
    import torch.distributed as dist
    from repro_torch.launch import mesh
    started = not dist.is_initialized()
    mesh.init_process_group("cpu")
    try:
        yield mesh.make_small_context(1, 1)
    finally:
        if started:
            dist.destroy_process_group()


def _cross_setup():
    from repro_torch.models import attention, encdec
    cfg = tbase.get_smoke_config("whisper_small")
    params = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(2, 6, cfg.d_model, generator=gen)
    src = torch.randn(2, cfg.encoder_seq, cfg.d_model, generator=gen)
    return cfg, params, encdec._spec(cfg, causal=False), x, src, attention


def _placed(params, ctx):
    """``params`` as DTensors on the one-rank mesh."""
    from repro_torch.models import transformer
    return transformer.shard_params(params, ctx)


@torch.no_grad()
def test_mesh_cross_attention_reads_its_source(one_rank_mesh):
    from repro_torch.distributed.parallel import Layout
    cfg, params, spec, x, src, attention = _cross_setup()
    p = params.dec_blocks[0].cross_attn
    want = attention.apply_attention(p, x, spec=spec, kv_src=src)
    self_attn = attention.apply_attention(p, x, spec=spec)
    p = _placed(params, one_rank_mesh).dec_blocks[0].cross_attn
    got = attention.apply_attention(p, x, spec=spec, kv_src=src,
                                    lay=Layout(one_rank_mesh))
    assert float((want - self_attn).abs().max()) > 1e-3
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@torch.no_grad()
def test_mesh_cross_decode_reads_its_cache(one_rank_mesh):
    from repro_torch.distributed.parallel import Layout
    from repro_torch.models import encdec
    cfg, params, _, x, src, attention = _cross_setup()
    spec_self = encdec._spec(cfg, causal=True)
    spec_cross = encdec._spec(cfg, causal=False)
    tok = x[:, :1]
    # one rank holds every source position: the whole cross cache
    cross = encdec.make_cross_caches(params, src)[0]

    def step(p, lay):
        cache = attention.init_cache(2, 8, spec_self, dtype=torch.float32,
                                     device="cpu", lay=lay)
        attention.prefill_attention(p.self_attn, x[:, 1:4], cache,
                                    spec=spec_self, lay=lay)
        before = cross.k.clone()
        out, same = attention.decode_attention(
            p.cross_attn, tok, cache, spec=spec_cross, kv_src_cache=cross,
            lay=lay)
        assert same is cache and cache.length == 3
        assert torch.equal(cross.k, before)       # never written
        self_out, _ = attention.decode_attention(
            p.cross_attn, tok, cache, spec=spec_cross, lay=lay)
        return out, self_out

    want, self_out = step(params.dec_blocks[0], None)
    got, _ = step(_placed(params, one_rank_mesh).dec_blocks[0],
                  Layout(one_rank_mesh))
    assert float((want - self_out).abs().max()) > 1e-3
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
