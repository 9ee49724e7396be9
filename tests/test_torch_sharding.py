"""The port's sharding rules against the reference's, leaf by leaf.

For the ten ``ARCH_IDS`` at full config on fake (16, 16), (2, 4) and
(2, 16, 16) meshes: parameter, moment, batch, decode-cache and tile specs
of ``repro_torch.distributed.sharding`` equal ``repro.distributed.
sharding``'s on every trailing dim of every leaf.  The reference scans
stacked layers; the leaves where it puts an axis on that layer axis are
the port's stack-axis cases (the module docstring), asserted here one by
one.  Then the reference's three rule tests (``tests/test_distribution.py``)
on the port.
"""
import collections

import jax
import pytest
from jax.sharding import PartitionSpec as P

from repro.configs import base as jbase
from repro.distributed import sharding as rs
from repro.models.model import build_model
from repro_torch.configs import base as tbase
from repro_torch.distributed import sharding as ts
from repro_torch.launch import steps

Mesh = collections.namedtuple("Mesh", ["shape"])
MESHES = {"16x16": ({"data": 16, "model": 16}, ("data",)),
          "2x4": ({"data": 2, "model": 4}, ("data",)),
          "2x16x16": ({"pod": 2, "data": 16, "model": 16}, ("pod", "data"))}
STACKS = ("blocks", "enc_blocks", "dec_blocks")

# Leaves whose reference spec puts ``model`` on the layer axis: the expert
# rule on stacked dense MLP weights, where ``model`` divides the depth.
MLP = ("mlp.w_gate", "mlp.w_up", "mlp.w_down")
STACK_AXIS = {
    ("chameleon_34b", "16x16"): MLP, ("chameleon_34b", "2x4"): MLP,
    ("chameleon_34b", "2x16x16"): MLP,
    ("phi3_mini_3_8b", "16x16"): MLP, ("phi3_mini_3_8b", "2x4"): MLP,
    ("phi3_mini_3_8b", "2x16x16"): MLP,
    ("gemma_7b", "2x4"): MLP, ("mistral_nemo_12b", "2x4"): MLP,
    ("qwen1_5_0_5b", "2x4"): MLP,
}


def _key(k) -> str:
    for attr in ("key", "name", "idx"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    return str(k)


def _flat(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {tuple(_key(k) for k in kp): tuple(v) for kp, v in flat}


def _ref_path(cfg, name: str) -> tuple:
    """The reference's tree path of the port's leaf ``name``."""
    parts = tuple(name.split("."))
    if parts[0] in STACKS and ts.reference_shape(cfg, name, ()) != ():
        return (parts[0],) + parts[2:]          # stacked: no layer index
    return parts


def _trailing(spec: tuple, n: int) -> tuple:
    return tuple(spec)[len(spec) - n:]


def _same(spec) -> tuple:
    """``spec`` with one-axis tuples as the axis (``PartitionSpec`` keeps
    ``("data",)`` as ``"data"``)."""
    return tuple(p[0] if isinstance(p, tuple) and len(p) == 1 else p
                 for p in spec)


@pytest.fixture(scope="module")
def reference_specs():
    out = {}
    for arch in tbase.ARCH_IDS:
        shapes = build_model(jbase.get_config(arch)).param_shapes()
        for mesh_name, (shape, _) in MESHES.items():
            mesh = Mesh(shape)
            pspec = rs.param_specs(shapes, mesh, arch)
            out[arch, mesh_name] = (_flat(pspec), _flat(
                rs.opt_state_specs(pspec, shapes, mesh)))
    return out


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", tbase.ARCH_IDS)
def test_param_and_moment_specs_equal_reference(arch, mesh_name,
                                                reference_specs):
    cfg = tbase.get_config(arch)
    mesh = Mesh(MESHES[mesh_name][0])
    shapes = steps.param_specs(cfg)
    pspec = ts.param_specs(shapes, mesh, cfg)
    mspec = ts.opt_state_specs(pspec, shapes, mesh, cfg=cfg)
    rp, rm = reference_specs[arch, mesh_name]
    cases = ts.stack_axis_cases(cfg, shapes, mesh)
    for name, leaf in shapes.items():
        n = leaf.ndim
        want_p, want_m = rp[_ref_path(cfg, name)], rm[_ref_path(cfg, name)]
        assert pspec[name] == _trailing(want_p, n), (name, want_p)
        assert mspec[name] == _trailing(want_m, n), (name, want_m)
        assert len(pspec[name]) == len(mspec[name]) == n
        lead = tuple(want_p)[:len(want_p) - n]
        if any(lead):
            assert cases[name] == ("param", "model"), name
    want = {name for name in shapes
            if name.split(".", 2)[-1] in STACK_AXIS.get((arch, mesh_name), ())}
    assert set(cases) == want
    assert all(v == ("param", "model") for v in cases.values())


def test_moment_on_the_layer_axis_takes_the_per_layer_rule():
    """A depth larger than every trailing dim that ``data`` divides: the
    reference puts ``data`` on the layer axis of the replicated leaves;
    the port applies the rule to the per-layer leaf instead."""
    over = {"num_layers": 128}
    jcfg = jbase.get_smoke_config("qwen1_5_0_5b").replace(**over)
    cfg = tbase.get_smoke_config("qwen1_5_0_5b").replace(**over)
    mesh = Mesh({"data": 2, "model": 1})
    shapes = build_model(jcfg).param_shapes()
    rm = _flat(rs.opt_state_specs(rs.param_specs(shapes, mesh, jcfg.name),
                                  shapes, mesh))
    tshapes = steps.param_specs(cfg)
    pspec = ts.param_specs(tshapes, mesh, cfg)
    mspec = ts.opt_state_specs(pspec, tshapes, mesh, cfg=cfg)
    cases = ts.stack_axis_cases(cfg, tshapes, mesh)
    on_layer_axis = {}
    for name, leaf in tshapes.items():
        want = rm[_ref_path(cfg, name)]
        if len(want) > leaf.ndim and want[0] == "data":
            on_layer_axis[name] = want
            # the rule on the per-layer leaf: data on its largest dim that
            # 2 divides, as for an unstacked leaf
            dims = [(leaf.shape[i], i) for i in range(leaf.ndim)
                    if pspec[name][i] is None and leaf.shape[i] % 2 == 0]
            expect = list(pspec[name])
            if dims:
                expect[max(dims)[1]] = "data"
            assert mspec[name] == tuple(expect), name
            assert cases[name] == ("moment", "data"), name
        else:
            assert mspec[name] == _trailing(want, leaf.ndim), name
    # the norms' scales and attention biases (L, 64) and the attention
    # weights (L, 64, 64), whose only other candidate is 64
    assert {n.split(".", 2)[-1] for n in on_layer_axis} == {
        "norm1.scale", "norm2.scale", "attn.bq", "attn.bk", "attn.bv",
        "attn.wq", "attn.wk", "attn.wv", "attn.wo"}
    assert mspec["blocks.0.norm1.scale"] == ("data",)
    assert mspec["blocks.0.attn.wq"] == ("data", "model")
    assert {n for n, c in cases.items() if c[0] == "moment"} == \
        set(on_layer_axis)


def _ref_cache_specs(caches, spec) -> dict:
    """(group, layer or None for a stacked leaf, name) -> spec."""
    out = {}
    for path, p in _flat(spec).items():
        name = path[-1]
        if name == "length":
            continue
        if isinstance(caches, list):
            out[0, int(path[0]), name] = p
        elif type(caches) is tuple:                 # (self, cross)
            out[int(path[0]), None, name] = p
        else:
            out[0, None, name] = p
    return out


def _port_cache_specs(spec) -> dict:
    groups = spec if isinstance(spec, tuple) else (spec,)
    return {(g, i, name): p for g, layers in enumerate(groups)
            for i, layer in enumerate(layers) for name, p in layer.items()}


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", tbase.ARCH_IDS)
def test_cache_batch_tile_specs_equal_reference(arch, mesh_name):
    shape, dp = MESHES[mesh_name]
    mesh = Mesh(shape)
    jcfg, cfg = jbase.get_config(arch), tbase.get_config(arch)
    model = build_model(jcfg)
    for sname in ("decode_32k", "train_4k", "prefill_32k"):
        jshape = jbase.SHAPES[sname]
        tshape = tbase.ShapeConfig(sname, jshape.seq_len, jshape.global_batch,
                                   jshape.kind)
        jin, tin = model.input_specs(jshape), steps.input_specs(cfg, tshape)
        if jshape.kind == "decode":
            jc = jin["caches"]
            want = _ref_cache_specs(jc, rs.cache_specs(jc, mesh, dp_axes=dp))
            got = _port_cache_specs(ts.cache_specs(tin["caches"], mesh,
                                                   dp_axes=dp))
            assert got, arch
            for (g, i, name), spec in got.items():
                ref = want.get((g, i, name), want.get((g, None, name)))
                assert _same(spec) == _same(_trailing(ref, len(spec))), \
                    (g, i, name, ref)
            jin, tin = {"token": jin["token"]}, {"token": tin["token"]}
        want = rs.batch_specs(jin, mesh, dp)
        got = ts.batch_specs(tin, mesh, dp)
        assert got.keys() == want.keys()
        for k, spec in got.items():
            assert _same(spec) == _same(tuple(want[k])), (sname, k)
    for n in (1, 2, 8, 12, 16, 64, 100, 256, 512, 1024):
        assert _same(ts.tile_partition_spec(n, mesh, dp)) == \
            _same(tuple(rs.tile_partition_spec(n, mesh, dp))), n


# ---------------------------------------------------------------------------
# The reference's rule tests (tests/test_distribution.py:42-80) on the port
# ---------------------------------------------------------------------------

def test_param_specs_respect_divisibility():
    mesh = Mesh({"data": 16, "model": 16})
    cfg = tbase.get_config("llama4_scout_17b_a16e")
    shapes = steps.param_specs(cfg)
    specs = ts.param_specs(shapes, mesh, cfg)
    n_sharded = 0
    for name, leaf in shapes.items():
        for dim, part in zip(leaf.shape, specs[name]):
            if part is None:
                continue
            size = 16 if isinstance(part, str) else 256
            assert dim % size == 0, (name, leaf.shape, specs[name])
            n_sharded += 1
    assert n_sharded > 10


def test_moe_experts_on_model_axis():
    mesh = Mesh({"data": 16, "model": 16})
    cfg = tbase.get_config("dbrx_132b")
    specs = ts.param_specs(steps.param_specs(cfg), mesh, cfg)
    for i in range(cfg.num_layers):
        spec = specs[f"blocks.{i}.moe.w_gate"]            # (E, D, F)
        assert spec[0] == "model"
        assert "data" in spec                             # ZeRO-3


def test_kv_cache_seq_sharded():
    mesh = Mesh({"data": 16, "model": 16})
    cfg = tbase.get_config("mistral_nemo_12b")
    caches = steps.input_specs(cfg, tbase.ShapeConfig(
        "decode_32k", 32768, 128, "decode"))["caches"]
    spec = ts.cache_specs(caches, mesh)
    # (B, S, KV, hd): S over model (flash-decoding), B over data.
    assert all(layer["k"] == (("data",), "model", None, None)
               for layer in spec)


# ---------------------------------------------------------------------------
# Placement: specs as DTensor placements, a rank's block
# ---------------------------------------------------------------------------

class _Mesh:
    """A (pod, data, model) = (2, 3, 2) mesh seen from one coordinate."""

    mesh_dim_names = ("pod", "data", "model")
    shape = {"pod": 2, "data": 3, "model": 2}

    def __init__(self, coord):
        self.coord = coord

    def get_coordinate(self):
        return list(self.coord)

    def size(self, i):
        return (2, 3, 2)[i]


def test_placements_and_blocks_follow_jax_order():
    """A dim under ("pod", "data") is split over both, pod major: rank
    (p, d, m) holds block p * 3 + d, as JAX's ``NamedSharding`` gives
    device (p, d, m) of ``P(("pod", "data"), "model")``."""
    from torch.distributed.tensor import Replicate, Shard
    spec = (("pod", "data"), "model")
    place = ts.placements(spec, _Mesh.mesh_dim_names)
    assert place == [Shard(0), Shard(0), Shard(1)]
    assert ts.placements((None, "model"), _Mesh.mesh_dim_names) == \
        [Replicate(), Replicate(), Shard(1)]
    with pytest.raises(ValueError, match="mesh order"):
        ts.placements((("data", "pod"),), _Mesh.mesh_dim_names)
    import torch
    full = torch.arange(12 * 4).reshape(12, 4)
    for p in range(2):
        for d in range(3):
            for m in range(2):
                got = ts.local_shard(full, place, _Mesh((p, d, m)))
                rows = full.chunk(6, 0)[p * 3 + d]
                assert torch.equal(got, rows.chunk(2, 1)[m])
                assert got.is_contiguous() and \
                    got.untyped_storage().nbytes() == got.numel() * 8
    # replicated: the tensor itself, no copy
    whole = ts.local_shard(full, [Replicate()] * 3, _Mesh((1, 2, 1)))
    assert whole is full


def test_guard_drops_axes_that_do_not_divide():
    mesh = Mesh({"data": 16, "model": 16})
    assert ts.guarded(("data", "model"), (32, 40), mesh) == ("data", None)
    assert ts.guarded((("data", "model"), None), (256, 3), mesh) == \
        (("data", "model"), None)
    assert ts.guarded(("pod",), (32,), mesh) == (None,)
    # constrain is a no-op without a context or on a plain tensor
    import torch
    x = torch.ones(4, 4)
    assert ts.constrain(x, None, ("data", None)) is x
    assert ts.constrain(x, mesh, ("data", None)) is x
