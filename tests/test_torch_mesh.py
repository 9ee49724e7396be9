"""The port's LM meshes against the reference's single-device results.

Each test spawns four ``gloo`` ranks once (``_torch_mesh_ranks``; a
(2, 2) ``("data", "model")`` mesh, a (4, 1) one for the restore) that
run the port alone, while this process runs the reference on one device.
What each holds:

* dbrx (MoE, the all_to_all path): the loss at capacity factor 8 (no
  token drops) against the reference's at ``LOSS_RTOL``; at capacity
  factor 1, where tokens drop, each rank's block of the sequence against
  the reference's ``_moe_a2a_path`` on that block's tokens alone
  (``ep_axis=None``), the psum path against ``_moe_psum_path`` on each
  data shard, and the aux loss as their mean, at ``MOE_TOL``;
* a phi3 ``train_bundle`` step: metrics, moments and the update rule as
  ``_torch_train_parity`` holds a single-device step;
* mistral greedy tokens (prefill, then decode against the caches split
  along the sequence over ``model``) equal to the reference's, for the
  heads split over ``model`` (H 4, KV 2), the heads split but not the KV
  heads (H 4, KV 1) and neither (H 3: the query sequence split, each
  rank's rows at their offset), with the loss at ``LOSS_RTOL``;
* a train state saved on (2, 2) and restored on (4, 1) bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.data import tokens as jtokens
from repro.distributed.context import single_device_ctx
from repro.launch import steps as jsteps
from repro.models import model as jmodel, moe as jmoe
from repro.models import transformer as jtransformer
from repro.optim import adamw as jadamw
from repro_torch.configs import base as tbase
from repro_torch.launch import serve_lm
from repro_torch.models import convert
from repro_torch.models.model import Model
from repro_torch.optim.adamw import AdamW, OptState

import _torch_mesh_ranks as ranks
from _torch_train_parity import check_train_step, port_state

LOSS_RTOL = 1e-5     # float32 smoke losses; the reference's own test: 1e-3
MOE_TOL = 1e-5       # of each output's largest element


def _state(arch: str, overrides: dict, key: int = 0):
    jcfg = jbase.get_smoke_config(arch).replace(**overrides)
    jparams = jmodel.build_model(jcfg).init(jax.random.PRNGKey(key))
    tcfg = tbase.get_smoke_config(arch).replace(**overrides)
    return jcfg, jparams, convert.params_from_jax(
        tcfg, jax.tree.map(np.asarray, jparams))


def _batch(vocab: int, seq: int, batch: int) -> dict:
    return jtokens.TokenStream(vocab, seq, batch).batch_at(0)


def _torch(b: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def _ref_loss(jcfg, jparams, batch):
    ctx = single_device_ctx()
    with ctx.mesh:
        _, m = jax.jit(lambda p, b: jmodel.build_model(jcfg).loss_fn(
            p, b, ctx))(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    return {k: float(v) for k, v in m.items()}


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                  1e-30)


def test_moe_paths_match_reference(tmp_path):
    jcfg, jparams, state = _state("dbrx_132b", {})
    batch = _batch(jcfg.vocab_size, 32, 8)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 32, jcfg.d_model)).astype(np.float32)
    drop_cf = 1.0
    out = ranks.run("moe", tmp_path, {
        "state": state, "batch": _torch(batch), "x": torch.from_numpy(x),
        "drop_cf": drop_cf})

    want = _ref_loss(jcfg, jparams, batch)
    assert abs(float(out["ce"]) - want["ce"]) <= LOSS_RTOL * abs(want["ce"])

    spec = jtransformer.moe_spec(jcfg.replace(capacity_factor=drop_cf))
    p = jax.tree.map(lambda t: t[0], jparams["blocks"]["moe"])
    args = (p["router"], p["w_gate"], p["w_up"], p["w_down"], spec, None, ())
    dropped = 0
    for d in range(2):                                  # data shards
        xd = jnp.asarray(x[4 * d:4 * d + 4])
        auxes = []
        for r in range(2):                              # sequence blocks
            y, aux = jmoe._moe_a2a_path(xd[:, 16 * r:16 * r + 16], *args)
            got = out["y_a2a"][4 * d:4 * d + 4, 16 * r:16 * r + 16]
            assert _rel(got, y) <= MOE_TOL, (d, r)
            auxes.append(float(aux))
            tokens = xd[:, 16 * r:16 * r + 16].reshape(-1, jcfg.d_model)
            _, idx, _ = jmoe._route(tokens, p["router"], spec)
            cap = max(1, int(tokens.shape[0] * spec.top_k
                             * spec.capacity_factor / spec.num_experts))
            dropped += int(jnp.sum(~jmoe._dispatch_indices(idx, spec,
                                                           cap)[-1]))
        assert abs(float(out["aux_a2a"][d]) - np.mean(auxes)) <= \
            MOE_TOL * np.mean(auxes)
        y, aux = jmoe._moe_psum_path(xd, *args)
        assert _rel(out["y_psum"][4 * d:4 * d + 4], y) <= MOE_TOL, d
        assert abs(float(out["aux_psum"][d]) - float(aux)) <= \
            MOE_TOL * float(aux)
    assert dropped > 0                    # the drop case drops tokens


def test_train_step_matches_single_device_reference(tmp_path):
    jcfg, jparams, state = _state("phi3_mini_3_8b", {})
    batch = _batch(jcfg.vocab_size, 64, 8)
    out = ranks.run("train_step", tmp_path,
                    {"state": state, "batch": _torch(batch)})

    jopt = jadamw.AdamW()
    ctx = single_device_ctx()
    jbundle = jsteps.train_bundle(jcfg, jbase.ShapeConfig("t", 64, 8,
                                                          "train"), ctx, jopt)
    jstate = jopt.init(jparams)
    cfg = tbase.get_smoke_config("phi3_mini_3_8b")
    before = port_state(Model(cfg, device="cpu").load(state))
    with ctx.mesh:
        jparams, jstate, jm = jbundle.fn(
            jparams, jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    params = Model(cfg, device="cpu").load(out["params"])
    check_train_step(AdamW(), params,
                     OptState(out["mu"], out["nu"], out["count"]),
                     out["metrics"], before, jparams, jstate, jm,
                     "phi3 (2, 2) step")
    # the FSDP/TP placements the rules give phi3 on (2, 2)
    assert "Shard(dim=1)" in out["placements"]["blocks.0.attn.wq"]
    assert "Shard(dim=0)" in out["placements"]["embed.embedding"]


def _ref_greedy(jcfg, jparams, prompts, gen_len, max_len):
    model = jmodel.build_model(jcfg)
    ctx = single_device_ctx()
    with ctx.mesh:
        logits, caches = model.prefill(jparams, {"tokens": jnp.asarray(
            prompts)}, ctx, max_len=max_len)
        tok = jnp.argmax(logits[:, -1:], -1).astype(jnp.int32)
        out = [np.asarray(tok)]
        for _ in range(gen_len - 1):
            logits, caches = model.decode_step(jparams, tok, caches, ctx)
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
            out.append(np.asarray(tok))
    return np.concatenate(out, axis=1)


ATTN_CASES = {"heads_kv_split": {},
              "heads_kv_replicated": {"num_kv_heads": 1},
              "query_offset": {"num_heads": 3, "num_kv_heads": 1}}


def test_attention_routes_greedy_tokens_and_loss(tmp_path):
    kw = dict(batch=4, prompt_len=8, gen_len=5, max_len=16, seed=3)
    batch = _batch(512, 32, 8)
    configs, want = {}, {}
    for name, over in ATTN_CASES.items():
        jcfg, jparams, state = _state("mistral_nemo_12b", over)
        configs[name] = (over, state)
        prompts = serve_lm.make_prompts(jcfg.vocab_size, kw["batch"],
                                        kw["prompt_len"], kw["seed"])
        want[name] = (_ref_greedy(jcfg, jparams, prompts, kw["gen_len"],
                                  kw["max_len"]),
                      _ref_loss(jcfg, jparams, batch)["ce"])
    out = ranks.run("attention", tmp_path, {
        "configs": configs, "serve": kw, "batch": _torch(batch)})
    for name, (tokens, ce) in want.items():
        got = out[name]
        np.testing.assert_array_equal(got["tokens"], tokens, err_msg=name)
        assert abs(float(got["ce"]) - ce) <= LOSS_RTOL * abs(ce), name
        # 16 slots split over the two ranks of ``model``
        assert got["cache_slots"] == 8 and got["cache_start"] == 0, name
    assert out["constrain"] == ("(Shard(dim=0), Shard(dim=1))",
                                "(Replicate(), Replicate())", True)


def test_checkpoint_saved_on_2x2_restores_on_4x1(tmp_path):
    _, _, state = _state("qwen1_5_0_5b", {})
    _, _, other = _state("qwen1_5_0_5b", {}, key=1)
    batch = _batch(tbase.get_smoke_config("qwen1_5_0_5b").vocab_size, 32, 4)
    out = ranks.run("checkpoint", tmp_path, {
        "state": state, "other_state": other, "batch": _torch(batch)})
    assert out["equal"] and out["step"] == 1 and out["count"] == 1
    assert out["mesh"] == [(4, 1)]
    # the embedding's moment: (V, D) split (model, data) on (2, 2), its D
    # split 4 ways on (4, 1)
    v, d = 512, 64
    assert out["local_shapes"] == ((v // 2, d // 2), (v, d // 4))
    # rank 0 holds the whole leaves on the host and writes them; ranks
    # 1-3 take part in the gathers and keep no host copy
    whole = {"0/embed/embedding": (v, d), "1/mu/embed/embedding": (v, d),
             "1/nu/embed/embedding": (v, d)}
    assert out["kept"] == [(whole, True)] + [(None, False)] * 3
    assert out["async_step"] == 2


def test_production_mesh_shrinks_as_the_reference():
    """``make_production_mesh``'s shapes by world size: the reference's
    rule (``src/repro/launch/mesh.py:15-25``)."""
    from repro_torch.launch.mesh import production_shape
    assert production_shape(256) == (16, 16)
    assert production_shape(512, multi_pod=True) == (2, 16, 16)
    for n in (8, 16, 255):
        assert production_shape(n) == (2, 4)
    for n in (8, 256, 511):
        assert production_shape(n, multi_pod=True) == (2, 2, 2)
    for n in (1, 4, 7):
        assert production_shape(n) == (1, 1)
        assert production_shape(n, multi_pod=True) == (1, 1, 1)
