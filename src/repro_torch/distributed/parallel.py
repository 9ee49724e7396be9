"""Tensor, sequence and expert parallelism of an LM forward on a mesh.

The reference writes its model once and lets XLA partition it by the
shardings of its inputs and the constraints in the model code.  The port
runs every rank's share as plain local tensors and issues the
collectives itself, Megatron-style, over the ``model`` axis of an
:class:`~repro_torch.distributed.context.LMContext`:

* Parameters live as DTensors, split by ``sharding.param_specs``.  A
  layer takes a weight through :meth:`Layout.weight`: the ``data`` shards
  are gathered (FSDP) and the ``model`` split is the one the layer
  computes with (a column or row block, the local experts, a vocab slice,
  or the whole weight).  Its gradient comes back through DTensor's
  redistribute: summed over the data axes and reduce-scattered onto the
  parameter's own split.
* The residual stream is either replicated over ``model`` or, at the
  reference's ``seq_shard`` layer boundary, split along the sequence
  (:attr:`Layout.seq`).  A tensor-parallel product enters with the whole
  sequence (:meth:`Layout.to_full`: an all-gather, or the identity whose
  backward all-reduces) and leaves as a sum over the ranks
  (:meth:`Layout.from_partial`: a reduce-scatter or an all-reduce).
* Every rank's loss is the same number over ``model`` and its share of
  the sum over the data axes: the backward pass then gives each weight
  its gradient without double counts.

Collectives over a group of one rank are skipped, as XLA elides them.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


@torch.no_grad()
def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A reduced copy of ``x``.  These four helpers record no autograd
    graph; the ``torch.autograd.Function``s below give the collectives
    their backward passes."""
    if group_size(group) == 1:
        return x
    out = x.clone()
    dist.all_reduce(out, op=op, group=group)
    return out


@torch.no_grad()
def all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order."""
    n = group_size(group)
    if n == 1:
        return x
    xs = x.movedim(dim, 0).contiguous()
    out = xs.new_empty((n * xs.shape[0], *xs.shape[1:]))
    dist.all_gather_into_tensor(out, xs, group=group)
    return out.movedim(0, dim)


@torch.no_grad()
def reduce_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The sum over the ranks of ``x``, this rank's block along ``dim``."""
    n = group_size(group)
    if n == 1:
        return x
    xs = x.movedim(dim, 0).contiguous()
    out = xs.new_empty((xs.shape[0] // n, *xs.shape[1:]))
    dist.reduce_scatter_tensor(out, xs, group=group)
    return out.movedim(0, dim)


def chunk(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim``."""
    n = group_size(group)
    if n == 1:
        return x
    return x.chunk(n, dim)[dist.get_rank(group)]


@torch.no_grad()
def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Block ``p`` of ``x``'s dim 0 goes to rank ``p``; block ``p`` of the
    result came from rank ``p``."""
    if group_size(group) == 1:
        return x
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _Copy(torch.autograd.Function):
    """Identity forward, all-reduce backward (Megatron's ``f``)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    """All-reduce forward, identity backward (Megatron's ``g``)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    """All-gather along ``dim``; the backward reduce-scatters (``reduce``:
    the gathered tensor feeds products whose gradients are partial sums)
    or keeps this rank's block (its gradient is already whole)."""

    @staticmethod
    def forward(ctx, x, group, dim, reduce):
        ctx.group, ctx.dim, ctx.reduce = group, dim, reduce
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.reduce:
            return reduce_scatter(g, ctx.group, ctx.dim), None, None, None
        return chunk(g, ctx.group, ctx.dim), None, None, None


class _Split(torch.autograd.Function):
    """This rank's block forward, all-gather backward."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return chunk(x, ctx.group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g.contiguous(), ctx.group, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    """Reduce-scatter forward, all-gather backward."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g.contiguous(), ctx.group, ctx.dim), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g, ctx.group), None


def copy_to(x, group):
    return x if group_size(group) == 1 else _Copy.apply(x, group)


def reduce_from(x, group):
    return x if group_size(group) == 1 else _Reduce.apply(x, group)


def gather(x, group, dim, *, reduce: bool):
    return x if group_size(group) == 1 else _Gather.apply(x, group, dim,
                                                          reduce)


def split(x, group, dim):
    return x if group_size(group) == 1 else _Split.apply(x, group, dim)


def reduce_scatter_grad(x, group, dim):
    return x if group_size(group) == 1 else _ReduceScatter.apply(x, group,
                                                                 dim)


def all_to_all_grad(x, group):
    return x if group_size(group) == 1 else _AllToAll.apply(x, group)


@dataclasses.dataclass(frozen=True)
class Layout:
    """How one forward pass lies on the mesh: ``ctx`` and whether the
    residual stream is split along the sequence over ``model`` (``seq``,
    the reference's ``seq_shard`` boundary; dim 1 of (B, S, D))."""

    ctx: object
    seq: bool = False

    @property
    def tp(self) -> int:
        return self.ctx.axis_size(self.ctx.tp_axis)

    @property
    def tp_group(self):
        return self.ctx.group(self.ctx.tp_axis) if self.tp > 1 else None

    @property
    def tp_rank(self) -> int:
        return self.ctx.rank(self.ctx.tp_axis) if self.tp > 1 else 0

    def dp_groups(self) -> list:
        return [self.ctx.group(a) for a in self.ctx.dp_axes
                if self.ctx.axis_size(a) > 1]

    def dp_sum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the batch axes (no autograd)."""
        for g in self.dp_groups():
            x = all_reduce(x, g)
        return x

    # -- weights ------------------------------------------------------------
    def weight(self, w, shard: int | None = None, *, whole: bool = True):
        """The local tensor of parameter ``w`` (a DTensor) for this rank's
        product: gathered over the data axes, split over ``model`` along
        dim ``shard`` (or whole with ``shard=None``).  Its gradient is
        summed over the data axes; over ``model`` it is this rank's block
        (``shard``), the same on every rank (``whole``: the rank's product
        sees every token, as the residual stream replicated over
        ``model`` gives it) or a part of a sum (``whole=False``: the rank
        saw its own tokens only)."""
        from torch.distributed.tensor import DTensor, Partial, Replicate, \
            Shard
        if not isinstance(w, DTensor):
            return w
        ctx = self.ctx
        place, grad = [], []
        for name in ctx.mesh.mesh_dim_names:
            n = ctx.axis_size(name)
            if name == ctx.tp_axis and shard is not None:
                place.append(Shard(shard))
                grad.append(Shard(shard))
            elif name == ctx.tp_axis:
                place.append(Replicate())
                grad.append(Partial() if n > 1 and not whole
                            else Replicate())
            else:
                place.append(Replicate())
                grad.append(Partial() if n > 1 else Replicate())
        return w.redistribute(ctx.mesh, place).to_local(grad_placements=grad)

    def local_weight(self, w):
        """A weight of per-token work on the residual stream as it lies
        (norms, replicated MLPs, biases added after a sum): whole on every
        rank; its gradient is whole when the stream is replicated and a
        part of a sum when each rank holds its own tokens."""
        return self.weight(w, None, whole=not self.seq)

    def model_dim(self, w) -> int | None:
        """The dim of ``w`` that its storage splits over ``model`` (of more
        than one rank), or None."""
        from torch.distributed.tensor import DTensor, Shard
        if not isinstance(w, DTensor) or self.tp == 1:
            return None
        p = w.placements[self.ctx.mesh.mesh_dim_names.index(
            self.ctx.tp_axis)]
        return p.dim if isinstance(p, Shard) else None

    def cache_dim(self, name: str, shape: tuple) -> int | None:
        """The dim of a decode-cache leaf ``name`` (``k``, ``wkv``, ``h``,
        ...) of whole ``shape`` that ``sharding.cache_specs`` splits over
        ``model`` (of more than one rank), or None."""
        if self.tp == 1:
            return None
        from repro_torch.distributed.sharding import cache_leaf_spec
        ctx = self.ctx
        spec = cache_leaf_spec(name, tuple(shape), ctx, tp=ctx.tp_axis,
                               dp_axes=ctx.dp_axes)
        return next((d for d, p in enumerate(spec) if p == ctx.tp_axis),
                    None)

    def cache_block(self, t: torch.Tensor, name: str, shape: tuple):
        """This rank's block of the whole cache leaf ``t`` (of ``shape``)
        as ``cache_specs`` splits it (``t`` itself where it does not)."""
        dim = self.cache_dim(name, shape)
        return t if dim is None else chunk(t, self.tp_group, dim)

    def cache_whole(self, t: torch.Tensor, name: str,
                    shape: tuple) -> torch.Tensor:
        """The whole cache leaf of ``shape`` from the ranks' blocks ``t``
        (no autograd: a state is read, never differentiated)."""
        dim = self.cache_dim(name, shape)
        return t if dim is None else all_gather(t, self.tp_group, dim)

    # -- activations --------------------------------------------------------
    def to_full(self, h: torch.Tensor) -> torch.Tensor:
        """The whole sequence for a product split over ``model``."""
        if self.seq:
            return gather(h, self.tp_group, 1, reduce=True)
        return copy_to(h, self.tp_group)

    def from_partial(self, y: torch.Tensor) -> torch.Tensor:
        """A product split over ``model`` (a partial sum) back onto the
        residual stream."""
        if self.seq:
            return reduce_scatter_grad(y, self.tp_group, 1)
        return reduce_from(y, self.tp_group)

    def to_chunk(self, h: torch.Tensor) -> torch.Tensor:
        """This rank's block of the sequence."""
        return h if self.seq else split(h, self.tp_group, 1)

    def from_chunk(self, y: torch.Tensor) -> torch.Tensor:
        """This rank's block of the sequence back onto the residual
        stream."""
        return y if self.seq else gather(y, self.tp_group, 1, reduce=False)
