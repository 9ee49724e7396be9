"""Port checkpoints (repro_torch.checkpoint.ckpt) on torch trees, and
across the two packages' files.

The reference's four ``tests/test_checkpoint.py`` cases run on torch
trees.  Its fifth, the elastic re-shard onto a 2x4 mesh in a subprocess,
has no counterpart on one card; restoring onto a given ``device=`` stands
in for it.  Then the two formats cross both ways, and a reference train
state (two ``train_bundle`` steps of qwen smoke, saved by the
reference's ``ckpt.save``) resumes in the port, held over its next two
steps as ``_torch_train_parity`` holds a step.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs import base as jbase
from repro.data import tokens as jtokens
from repro.distributed.context import single_device_ctx
from repro.launch import steps as jsteps
from repro.models import model as jmodel
from repro.optim import adamw as jadamw
from repro_torch.checkpoint import ckpt
from repro_torch.configs import base as tbase
from repro_torch.launch import steps
from repro_torch.launch.train import train
from repro_torch.models import convert
from repro_torch.models.model import Model
from repro_torch.optim.adamw import AdamW, OptState

from _torch_train_parity import STEP_TOL, check_train_step, port_state


def tree():
    return {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": {"w": torch.ones((4, 4), dtype=torch.bfloat16) * 1.5,
                  "n": torch.tensor(7, dtype=torch.int32)},
            "l": [torch.zeros((2,), dtype=torch.float32),
                  torch.full((2, 2), -3.0, dtype=torch.float32)]}


def jax_tree():
    return {"a": jnp.arange(12, dtype=jnp.float32).reshape(3, 4),
            "b": {"w": jnp.ones((4, 4), jnp.bfloat16) * 1.5,
                  "n": jnp.asarray(7, jnp.int32)},
            "l": [jnp.zeros((2,), jnp.float32),
                  jnp.full((2, 2), -3.0, jnp.float32)]}


def assert_tree_equal(x, y):
    a, b = dict((ckpt._key(p), v) for p, v in ckpt._items(x)), \
        dict((ckpt._key(p), v) for p, v in ckpt._items(y))
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def test_roundtrip_bf16_and_ints(tmp_path):
    t = tree()
    ckpt.save(tmp_path, 5, t, metadata={"k": "v"})
    restored, meta, step = ckpt.restore(tmp_path, t)
    assert step == 5 and meta == {"k": "v"}
    assert restored["b"]["w"].dtype == torch.bfloat16
    assert restored["b"]["n"].dtype == torch.int32
    assert_tree_equal(t, restored)


def test_rotation_keeps_latest(tmp_path):
    t = tree()
    for s in (1, 2, 3, 4, 5):
        ckpt.save(tmp_path, s, t, keep=2)
    steps_ = sorted(p.name for p in tmp_path.glob("step_*"))
    assert steps_ == ["step_00000004", "step_00000005"]
    assert ckpt.latest_step(tmp_path) == 5
    assert not list(tmp_path.glob(".tmp_step_*"))


def test_async_checkpointer(tmp_path):
    saver = ckpt.AsyncCheckpointer()
    t = tree()
    saver.save(tmp_path, 1, t)
    saver.save(tmp_path, 2, t)     # joins the previous write
    saver.join()
    assert ckpt.latest_step(tmp_path) == 2
    restored, _, _ = ckpt.restore(tmp_path, t)
    assert_tree_equal(t, restored)


def test_async_save_holds_values_before_an_in_place_update(tmp_path):
    """The train step updates its parameters in place right after a
    save: the checkpoint holds the values of the save's call."""
    saver = ckpt.AsyncCheckpointer()
    t = tree()
    want = {k: v.clone() for k, v in t.items() if k == "a"}
    saver.save(tmp_path, 1, t)
    t["a"].add_(100.0)
    t["b"]["w"].mul_(2)
    saver.join()
    restored, _, _ = ckpt.restore(tmp_path, tree())
    assert torch.equal(restored["a"], want["a"])
    assert torch.equal(restored["b"]["w"], tree()["b"]["w"])


def test_missing_leaf_and_shape_mismatch(tmp_path):
    t = tree()
    ckpt.save(tmp_path, 1, t)
    bad = dict(t, extra=torch.zeros((1,)))
    with pytest.raises(KeyError):
        ckpt.restore(tmp_path, bad)
    bad2 = dict(t, a=torch.zeros((9, 9)))
    with pytest.raises(ValueError):
        ckpt.restore(tmp_path, bad2)
    with pytest.raises(FileNotFoundError):
        ckpt.restore(tmp_path / "none", t)


def test_restore_onto_a_given_device(tmp_path):
    """Shapes on the meta device restore onto the host; a module target
    is loaded in place, its names ``/``-joined."""
    t = tree()
    ckpt.save(tmp_path, 1, t)
    meta = {k: v.to("meta") if isinstance(v, torch.Tensor) else v
            for k, v in t.items()}
    restored, _, _ = ckpt.restore(tmp_path, meta, device="cpu")
    assert restored["a"].device.type == "cpu"
    assert torch.equal(restored["a"], t["a"])

    cfg = tbase.get_smoke_config("qwen1_5_0_5b")
    model = Model(cfg, device="cpu")
    saved = model.init(torch.Generator().manual_seed(0))
    opt = AdamW()
    ckpt.save(tmp_path / "m", 3, (saved, opt.init(saved)))
    manifest = ckpt.read(tmp_path / "m")[0]
    assert "0/blocks/1/attn/wq" in manifest and "1/mu/blocks/1/attn/wq" \
        in manifest and "1/count" in manifest
    other = model.init(torch.Generator().manual_seed(1))
    (got, state), _, step = ckpt.restore(
        tmp_path / "m", (other, opt.init(other)), device="cpu")
    assert step == 3 and got is other and isinstance(state, OptState)
    for k, v in saved.state_dict().items():
        assert torch.equal(got.state_dict()[k], v), k
    assert all(p.requires_grad for p in got.parameters())


def test_reference_reads_port_files_and_port_reads_reference(tmp_path):
    ckpt.save(tmp_path / "port", 4, tree(), metadata={"from": "port"})
    restored, meta, step = jckpt.restore(tmp_path / "port", jax_tree())
    assert step == 4 and meta == {"from": "port"}
    assert restored["b"]["w"].dtype == jnp.bfloat16
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        np.asarray(a, np.float32), np.asarray(b, np.float32)),
        restored, jax_tree())

    jckpt.save(tmp_path / "ref", 9, jax_tree(), metadata={"from": "ref"})
    flat, meta, step = ckpt.read(tmp_path / "ref")
    assert step == 9 and meta == {"from": "ref"}
    assert sorted(flat) == ["a", "b/n", "b/w", "l/0", "l/1"]
    assert flat["b/w"].dtype == np.float32        # bfloat16, widened
    np.testing.assert_array_equal(flat["b/w"], np.full((4, 4), 1.5))
    assert flat["b/n"].dtype == np.int32 and int(flat["b/n"]) == 7
    got, _, _ = ckpt.restore(tmp_path / "ref", tree())
    assert_tree_equal(tree(), got)


def _reference_run(tmp_path):
    """Four reference ``train_bundle`` steps of qwen smoke from its init,
    the state after two saved by the reference's ``ckpt.save``; returns
    each step's (params, state, metrics)."""
    jcfg = jbase.get_smoke_config("qwen1_5_0_5b")
    jopt = jadamw.AdamW(total_steps=4, warmup_steps=10)
    ctx = single_device_ctx()
    bundle = jsteps.train_bundle(jcfg, jbase.ShapeConfig("custom", 32, 4,
                                                         "train"), ctx, jopt)
    params = jax.jit(jmodel.build_model(jcfg).init)(jax.random.PRNGKey(0))
    state = jopt.init(params)
    stream = jtokens.TokenStream(jcfg.vocab_size, 32, 4)
    history = []
    with ctx.mesh:
        for step in range(4):
            batch = {k: jnp.asarray(v) for k, v in
                     stream.batch_at(step).items()}
            params, state, m = bundle.fn(params, state, batch)
            # Host copies: the next step donates these buffers.
            history.append(jax.tree.map(np.array, (params, state, m)))
            if step == 1:
                jckpt.save(tmp_path, 2, (params, state),
                           metadata={"arch": "qwen1_5_0_5b"})
    return history


def test_reference_train_state_resumes_in_port(tmp_path):
    history = _reference_run(tmp_path / "ref")
    cfg = tbase.get_smoke_config("qwen1_5_0_5b")
    flat, meta, step = ckpt.read(tmp_path / "ref")
    assert step == 2 and meta == {"arch": "qwen1_5_0_5b"}
    nested = ckpt.nest(flat)
    state_dict, opt_state = convert.train_state_from_jax(
        cfg, nested["0"], nested["1"])
    assert int(opt_state.count) == 2 and opt_state.count.dtype == torch.int32
    params = Model(cfg, device="cpu").load(state_dict)

    # The port's train step from the converted state, against the
    # reference's steps 2 and 3.
    opt = AdamW(total_steps=4, warmup_steps=10)
    bundle = steps.train_bundle(cfg, tbase.ShapeConfig("custom", 32, 4,
                                                       "train"), opt,
                                device="cpu")
    stream = jtokens.TokenStream(cfg.vocab_size, 32, 4)
    state = opt_state
    resumed = Model(cfg, device="cpu").load(state_dict)
    ckpt.save(tmp_path / "port", 2, (resumed, opt_state))
    for step in (2, 3):
        batch = {k: torch.from_numpy(v) for k, v in
                 stream.batch_at(step).items()}
        before = port_state(params)
        params, state, m = bundle.fn(params, state, batch)
        jparams, jstate, jm = history[step]
        check_train_step(opt, params, state, m, before, jparams, jstate, jm,
                         f"resumed step {step}")

    # The same resume through train() from the port's own checkpoint.
    got = train("qwen1_5_0_5b", steps=4, seq_len=32, global_batch=4,
                ckpt_dir=str(tmp_path / "port"), log_every=1, device="cpu",
                params=resumed, verbose=False)
    assert [h["step"] for h in got] == [2, 3]
    np.testing.assert_allclose(got[0]["loss"], float(history[2][2]["loss"]),
                               rtol=STEP_TOL)
