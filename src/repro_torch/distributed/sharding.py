"""Sharding rules: parameters, optimizer moments, batches and caches to
spec trees; placement of tensors on an LM mesh by those specs.

Counterpart of ``repro.distributed.sharding``, with its strategy:

* TP over ``model``: column-parallel in-projections, row-parallel
  out-projections (Megatron); vocab over ``model``.
* EP over ``model``: the MoE expert dim.
* ZeRO/FSDP over ``data``: optimizer moments always; parameters too for
  the archs in ``FSDP_PARAM_ARCHS``.
* ``pod`` is pure data parallelism.
* Every rule is divisibility-guarded: an axis applies to a dim only when
  its size divides the dim.

Caches (decode): KV caches shard batch over the data axes and the
sequence over ``model`` (flash-decoding: each rank holds a slice of the
positions and the ranks combine partial softmaxes); recurrent states
shard their channel dims.

A spec is a tuple with one entry per dim: an axis name, a tuple of
names, or ``None`` (the reference's ``tuple(PartitionSpec)``).  A mesh
is anything whose ``shape`` maps axis names to sizes (an
:class:`~repro_torch.distributed.context.LMContext`, or a stand-in in the
tests).  The rules run over the port's flat state-dict names
(``blocks.3.attn.wq``) with the reference's own name rules.

**Stacked leaves.**  The reference scans homogeneous stacks of blocks: a
leaf there has a leading layer axis ``L`` that the port's per-layer
leaves lack.  The rules here are applied to the reference's shape (the
port's with ``L`` in front, ``convert.reference_stacked``), and the port
keeps the trailing entries, so every trailing dim is sharded as the
reference shards it.  An entry the reference puts on ``L`` has no dim to
go to:

* a parameter: the reference's expert rule also matches a stacked dense
  MLP weight (``w_gate``/``w_up``/``w_down`` with three dims), whose
  first dim is then ``L``; where ``model`` divides ``L`` it shards the
  layer axis over ``model``.  The port drops that entry, so the leaf is
  replicated over ``model`` (each rank's layer holds the whole weight).
* a moment: ``opt_state_specs`` puts ``data`` on the largest replicated
  dim that it divides, which can be ``L``.  The port then applies the same
  rule to the per-layer leaf: ``data`` on the largest replicated trailing
  dim that it divides, or nowhere.

``stack_axis_cases`` lists these leaves for a config and mesh.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.convert import reference_stacked

# Archs whose bf16 params exceed ~4 GB/chip with model-only sharding.
FSDP_PARAM_ARCHS = {"dbrx_132b", "llama4_scout_17b_a16e", "chameleon_34b"}

# trailing-dims rules: name -> ("col" | "row" | special)
_COL = {"wq", "wk", "wv", "wg", "wr", "w_gate", "w_up", "w_in", "wa", "wx",
        "tm_w1", "wd1", "conv_w"}
_ROW = {"wo", "w_down", "w_out", "wv_cm", "wd2"}


def axes_size(mesh, axis) -> int:
    """Size of one axis or the product over a tuple of axes."""
    if isinstance(axis, str):
        return mesh.shape[axis]
    return math.prod(mesh.shape[a] for a in axis)


def _fits(dim: int, mesh, axis) -> bool:
    if axis is None or dim is None:
        return False
    size = axes_size(mesh, axis)
    return dim % size == 0 and dim >= size


def _axis_if(dim, mesh, axis):
    return axis if _fits(dim, mesh, axis) else None


def _has(part, axis) -> bool:
    return part == axis or (isinstance(part, tuple) and axis in part)


def param_spec(path: tuple[str, ...], shape: tuple[int, ...], mesh,
               *, fsdp: bool, tp: str | None = "model",
               dp: str | None = "data") -> tuple:
    """Spec of one parameter leaf (leading stack dims -> None)."""
    name = path[-1]
    parent = path[-2] if len(path) >= 2 else ""
    nd = len(shape)
    fs = dp if fsdp else None

    def pad(trailing):  # fill leading (layer-stack) dims with None
        return tuple([None] * (nd - len(trailing)) + list(trailing))

    if name == "embedding":                      # (V, D)
        return pad([_axis_if(shape[-2], mesh, tp),
                    _axis_if(shape[-1], mesh, fs)])
    if name == "lm_head":                        # (D, V)
        return pad([_axis_if(shape[-2], mesh, fs),
                    _axis_if(shape[-1], mesh, tp)])
    if name == "router":                         # (D, E) tiny, replicated
        return pad([None, None])
    if parent == "moe" or (name in ("w_gate", "w_up", "w_down")
                           and nd >= 3 and path[-2] != "shared"):
        if name in ("w_gate", "w_up"):           # (E, D, F)
            return pad([_axis_if(shape[-3], mesh, tp), None,
                        _axis_if(shape[-1], mesh, dp)])
        if name == "w_down":                     # (E, F, D)
            return pad([_axis_if(shape[-3], mesh, tp),
                        _axis_if(shape[-2], mesh, dp), None])
    if parent == "cm" and name == "wv":          # channelmix (F, D): row
        return pad([_axis_if(shape[-2], mesh, tp),
                    _axis_if(shape[-1], mesh, fs)])
    if name in _COL and nd >= 2:                 # (.., in, out): col-parallel
        return pad([_axis_if(shape[-2], mesh, fs),
                    _axis_if(shape[-1], mesh, tp)])
    if name in _ROW and nd >= 2:                 # (.., in, out): row-parallel
        return pad([_axis_if(shape[-2], mesh, tp),
                    _axis_if(shape[-1], mesh, fs)])
    if name == "tm_w2":                          # (5, LORA, D)
        return pad([None, _axis_if(shape[-1], mesh, tp)] if nd == 2 else
                   [None, None, _axis_if(shape[-1], mesh, tp)])
    # norms, biases, gates, u, lam, maa*: replicated
    return (None,) * nd


def _stack(cfg: ModelConfig, name: str) -> int:
    """Length of the reference's layer axis in front of ``name``, 0 where
    it keeps the leaf per layer."""
    if not reference_stacked(cfg, name):
        return 0
    return cfg.encoder_layers if name.startswith("enc_blocks") \
        else cfg.num_layers


def reference_shape(cfg: ModelConfig, name: str, shape) -> tuple:
    """The reference's shape of the port's leaf ``name``."""
    lead = _stack(cfg, name)
    return ((lead,) if lead else ()) + tuple(shape)


def _param_spec_ref(cfg, name, shape, mesh, *, fsdp, tp, dp) -> tuple:
    return param_spec(tuple(name.split(".")),
                      reference_shape(cfg, name, shape), mesh, fsdp=fsdp,
                      tp=tp, dp=dp)


def param_specs(shapes: dict, mesh, cfg: ModelConfig, *, tp="model",
                dp="data", fsdp: bool | None = None) -> dict:
    """Spec of every parameter, by state-dict name.  ``shapes`` maps names
    to anything with a ``.shape`` (tensors, meta tensors) or to shape
    tuples."""
    if fsdp is None:
        fsdp = cfg.name in FSDP_PARAM_ARCHS
    out = {}
    for name, leaf in shapes.items():
        shape = _shape(leaf)
        full = _param_spec_ref(cfg, name, shape, mesh, fsdp=fsdp, tp=tp,
                               dp=dp)
        out[name] = full[len(full) - len(shape):]
    return out


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def _moment_spec(spec: tuple, shape: tuple, mesh, dp) -> tuple:
    """The reference's moment rule on one leaf: the parameter's spec plus
    ``dp`` on the largest still-replicated dim that it divides."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    if any(_has(p, dp) for p in parts):
        return tuple(parts)
    cands = [(shape[i], i) for i in range(len(parts))
             if parts[i] is None and _fits(shape[i], mesh, dp)]
    if cands:
        _, i = max(cands)
        parts[i] = dp
    return tuple(parts)


def opt_state_specs(pspecs: dict, shapes: dict, mesh, *, dp="data",
                    tp="model", cfg: ModelConfig | None = None) -> dict:
    """Moments: the parameter's spec + ``dp`` on the largest
    still-replicated dim.  With ``cfg`` the rule runs on the reference's
    stacked leaf, its layer axis carrying the reference's parameter entry
    (see the module docstring: where ``dp`` lands on the layer axis, the
    per-layer leaf gets the rule of its own dims)."""
    out = {}
    for name, spec in pspecs.items():
        shape = _shape(shapes[name])
        if cfg is None or not _stack(cfg, name):
            out[name] = _moment_spec(spec, shape, mesh, dp)
            continue
        lead = _param_spec_ref(cfg, name, shape, mesh,
                               fsdp=cfg.name in FSDP_PARAM_ARCHS, tp=tp,
                               dp=dp)[0]
        full = _moment_spec((lead,) + tuple(spec),
                            reference_shape(cfg, name, shape), mesh, dp)
        out[name] = full[1:] if full[0] == lead else \
            _moment_spec(spec, shape, mesh, dp)
    return out


def stack_axis_cases(cfg: ModelConfig, shapes: dict, mesh, *,
                     tp="model", dp="data") -> dict:
    """Leaves whose reference spec puts an axis on the layer axis:
    ``{name: ("param" | "moment", axis)}``."""
    fsdp = cfg.name in FSDP_PARAM_ARCHS
    out = {}
    for name, leaf in shapes.items():
        shape = _shape(leaf)
        if not _stack(cfg, name):
            continue
        full = _param_spec_ref(cfg, name, shape, mesh, fsdp=fsdp, tp=tp,
                               dp=dp)
        if full[0] is not None:
            out[name] = ("param", full[0])
            continue
        mom = _moment_spec(full, reference_shape(cfg, name, shape), mesh, dp)
        if mom[0] is not None:
            out[name] = ("moment", mom[0])
    return out


def batch_specs(batch: dict, mesh, dp_axes=("data",)) -> dict:
    """Input batches: dim 0 (global batch) over the dp axes when
    divisible."""
    out = {}
    for key, leaf in batch.items():
        shape = _shape(leaf)
        nd = len(shape)
        size = axes_size(mesh, tuple(dp_axes))
        if nd and shape[0] % size == 0 and shape[0] >= size:
            out[key] = (tuple(dp_axes),) + (None,) * (nd - 1)
        else:
            out[key] = (None,) * nd
    return out


def cache_leaf_spec(name: str, shape: tuple, mesh, *, tp="model",
                    dp_axes=("data",)) -> tuple:
    """Spec of one decode-cache leaf by its name (``k``/``v`` of a KV
    cache, ``wkv``/``tm_x``/``cm_x`` of an RWKV state, ``h``/``conv`` of
    an RG-LRU state)."""
    dp = tuple(dp_axes)
    dpsize = axes_size(mesh, dp)

    def dp_if(dim):
        return dp if dim % dpsize == 0 and dim >= dpsize else None

    nd = len(shape)
    if name in ("k", "v") and nd >= 4:
        # (..., B, S, KV, hd): B -> data, S -> model (flash-decoding)
        return (None,) * (nd - 4) + (dp_if(shape[-4]),
                                     _axis_if(shape[-3], mesh, tp),
                                     None, None)
    if name == "wkv" and nd >= 4:
        # (..., B, H, K, K): B -> data, K -> model
        return (None,) * (nd - 4) + (dp_if(shape[-4]), None,
                                     _axis_if(shape[-2], mesh, tp), None)
    if name in ("tm_x", "cm_x", "h") and nd >= 2:
        return (None,) * (nd - 2) + (dp_if(shape[-2]),
                                     _axis_if(shape[-1], mesh, tp))
    if name == "conv" and nd >= 3:
        return (None,) * (nd - 3) + (dp_if(shape[-3]), None,
                                     _axis_if(shape[-1], mesh, tp))
    return (None,) * nd


def cache_specs(caches, mesh, *, tp="model", dp_axes=("data",)):
    """Decode caches: the tree of ``caches`` (lists, tuples, dicts, a
    ``KVCache``'s ``k``/``v``) with each tensor leaf replaced by its spec
    (:func:`cache_leaf_spec`, by the leaf's own name); ``length`` and
    other non-tensor fields are left out."""
    if isinstance(caches, dict):
        return {k: (cache_leaf_spec(k, _shape(v), mesh, tp=tp,
                                    dp_axes=dp_axes)
                    if hasattr(v, "shape") else
                    cache_specs(v, mesh, tp=tp, dp_axes=dp_axes))
                for k, v in caches.items()}
    if isinstance(caches, (list, tuple)):
        return type(caches)(cache_specs(c, mesh, tp=tp, dp_axes=dp_axes)
                            for c in caches)
    if hasattr(caches, "k") and hasattr(caches, "v"):
        return {n: cache_leaf_spec(n, _shape(getattr(caches, n)), mesh,
                                   tp=tp, dp_axes=dp_axes)
                for n in ("k", "v")}
    raise TypeError(f"not a cache tree: {type(caches).__name__}")


def tile_partition_spec(n_tiles: int, mesh, dp_axes=("data",)) -> tuple:
    """Tile-axis spec for halo-tiled PH: the leading (row-major) tile axis
    over the data axes, so consecutive tile rows land on consecutive mesh
    devices; ``()`` (replicated) when the dp size does not divide the tile
    count."""
    if not all(a in mesh.shape for a in dp_axes):
        return ()
    size = axes_size(mesh, tuple(dp_axes))
    if n_tiles % size == 0 and n_tiles >= size:
        return (tuple(dp_axes),)
    return ()


# ---------------------------------------------------------------------------
# Placement on a DeviceMesh
# ---------------------------------------------------------------------------

def guarded(spec, shape, mesh) -> tuple:
    """``spec`` with each axis that does not divide its dim dropped (the
    reference's ``constrain`` guard), padded to one entry per dim."""
    out = []
    for dim, p in zip(shape, tuple(spec) + (None,) * len(shape)):
        if p is None:
            out.append(None)
            continue
        axes = p if isinstance(p, tuple) else (p,)
        ok = all(a in mesh.shape for a in axes)
        out.append(p if ok and _fits(dim, mesh, axes) else None)
    return tuple(out)


def placements(spec, mesh_dim_names) -> list:
    """DTensor placements of a spec: mesh dim ``a`` gets ``Shard(d)`` where
    dim ``d`` names ``a`` (alone or in a tuple), else ``Replicate()``.  A
    dim under a tuple of axes is split first axis major, as JAX orders
    them: that is DTensor's order of the mesh dims when the tuple lists
    them in mesh order."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate() for _ in mesh_dim_names]
    for d, p in enumerate(spec):
        if p is None:
            continue
        axes = p if isinstance(p, tuple) else (p,)
        idx = [mesh_dim_names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"axes {axes} of dim {d} are not in mesh order "
                             f"{mesh_dim_names}")
        for i in idx:
            out[i] = Shard(d)
    return out


def local_shard(t, place, mesh):
    """This rank's block of the full tensor ``t`` under ``place``, in
    storage of its own when it is a part of ``t`` (a view would keep the
    whole tensor alive)."""
    from torch.distributed.tensor import Shard
    coord = mesh.get_coordinate()
    part = t
    for i, p in enumerate(place):
        if isinstance(p, Shard) and mesh.size(i) > 1:
            part = part.chunk(mesh.size(i), p.dim)[coord[i]]
    return t if part is t else part.clone(
        memory_format=torch.contiguous_format)


def distribute(t, spec, ctx):
    """The full tensor ``t`` (the same on every rank) as a DTensor on
    ``ctx.mesh`` split by ``spec``: each rank keeps its block, nothing is
    sent."""
    from torch.distributed.tensor import DTensor
    place = placements(guarded(spec, t.shape, ctx), ctx.mesh.mesh_dim_names)
    local = local_shard(t.contiguous(), place, ctx.mesh)
    return DTensor.from_local(local, ctx.mesh, place, run_check=False,
                              shape=t.shape, stride=t.contiguous().stride())


def to_named(tensors: dict, specs: dict, ctx) -> dict:
    """Each tensor of ``tensors`` as a DTensor on ``ctx.mesh``, split by its
    spec (the reference's ``NamedSharding``s; every rank passes the same
    full tensor and keeps its shard)."""
    return {k: distribute(t, specs[k], ctx) for k, t in tensors.items()}


def constrain(x, ctx, parts):
    """The reference's ``with_sharding_constraint`` on a DTensor: ``x``
    redistributed to ``parts`` (one entry per dim: an axis name, a tuple
    of names or None), each axis that does not divide its dim dropped.
    ``ctx=None`` or a plain tensor is a no-op, so model code runs without
    a mesh."""
    from torch.distributed.tensor import DTensor
    if ctx is None or not isinstance(x, DTensor):
        return x
    spec = guarded(parts, x.shape, ctx)
    return x.redistribute(ctx.mesh, placements(spec,
                                               ctx.mesh.mesh_dim_names))
