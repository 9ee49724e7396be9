"""AdamW with float32 moments over (possibly bfloat16) parameters.

The port's counterpart of ``repro.optim.adamw``: the same defaults, warmup
+ cosine schedule, global-norm clip and update, in the reference's
arithmetic order (grads widened to float32; one global norm over all
leaves; ``scale = min(1, clip / max(gnorm, 1e-9))``; ``count + 1``; the
bias corrections; ``p.f32 - step`` rounded to the parameter's dtype).

* Parameters are an ``nn.Module`` (the model's tree, which carries its
  ``cfg``) or a dict of tensors; gradients and the moments ``mu``/``nu``
  are dicts keyed by the parameters' state-dict names, the moments
  float32 on the parameters' device.  ``count`` is a 0-d int32 tensor
  there too, and the learning rate is computed from it on the device, so
  an update causes no host sync.
* ``update`` writes the parameters in place under ``torch.no_grad()`` (the
  port's stand-in for the reference's buffer donation) and returns the
  new state with ``grad_norm`` and ``lr`` as 0-d tensors.
* Weight decay applies to the leaves whose reference counterpart has
  ndim >= 2 (the reference decays ``p.ndim >= 2``).  The reference scans
  stacked layers, so a per-layer vector there carries a layer axis and is
  decayed; :func:`repro_torch.models.convert.reference_ndim` gives that
  rank for a model's parameter.  A dict of tensors decays by its own
  ranks.

There is no fused kernel: each leaf runs the reference's dozen elementwise
operations in its order.

On an LM mesh the parameters and their gradients are DTensors placed by
``sharding.param_specs`` and the moments DTensors placed by
``sharding.opt_state_specs`` (``init(params, ctx)``: ZeRO over
``data``).  The global norm is one all-reduce of the ranks' sums of
squares, each element counted once (a rank's sum is divided by the
number of ranks holding the same block), so every rank gets the same
norm.  Each leaf is updated on the moments' blocks (the gradient and the
parameter sliced there, which sends nothing) and the new parameter is
gathered back onto its own placement.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
from torch import nn

from repro_torch.models.convert import reference_ndim


class OptState(NamedTuple):
    mu: dict              # float32, keyed like the parameters
    nu: dict              # float32, keyed like the parameters
    count: torch.Tensor   # 0-d int32


def named_leaves(params) -> dict:
    """The parameters by state-dict name (a module's) or as given (a
    dict)."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def decayed_names(params) -> set:
    """Names of the leaves that weight decay applies to: reference rank
    >= 2 for a model's parameters, own rank >= 2 for a dict."""
    leaves = named_leaves(params)
    cfg = getattr(params, "cfg", None)
    if cfg is None:
        return {k for k, p in leaves.items() if p.ndim >= 2}
    return {k for k, p in leaves.items() if reference_ndim(cfg, k, p) >= 2}


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1

    def init(self, params, ctx=None) -> OptState:
        """Zero moments; with ``ctx`` DTensors placed by
        ``sharding.opt_state_specs`` (``params`` a model placed on its
        mesh)."""
        leaves = named_leaves(params)
        device = ctx.device if ctx is not None else \
            next(iter(leaves.values())).device
        count = torch.zeros((), dtype=torch.int32, device=device)
        if ctx is not None:
            mu = _moments(params, ctx)
            return OptState(mu, _moments(params, ctx), count)
        zeros = {k: torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device) for k, p in leaves.items()}
        return OptState(zeros, {k: z.clone() for k, z in zeros.items()},
                        count)

    def schedule(self, step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = torch.clamp(step / max(self.warmup_steps, 1), max=1.0)
        prog = torch.clamp((step - self.warmup_steps)
                           / max(self.total_steps - self.warmup_steps, 1),
                           0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * prog))
        return self.lr * warm * (self.min_lr_ratio
                                 + (1 - self.min_lr_ratio) * cos)

    @torch.no_grad()
    def update(self, params, grads: dict, state: OptState):
        """One step: the parameters updated in place; returns (new state,
        {"grad_norm", "lr"})."""
        leaves = named_leaves(params)
        decayed = decayed_names(params) if self.weight_decay else set()
        gnorm = torch.zeros((), dtype=torch.float32,
                            device=state.count.device)
        mesh = _mesh_of(leaves)
        for k in leaves:             # widened leaf by leaf, not all at once
            g, copies = _local(grads[k])
            sq = torch.sum(torch.square(g.to(torch.float32)))
            gnorm = gnorm + (sq / copies if copies > 1 else sq)
        if mesh is not None:
            import torch.distributed as dist
            dist.all_reduce(gnorm)
        gnorm = torch.sqrt(gnorm)
        clip = torch.full((), self.grad_clip, dtype=torch.float32,
                          device=gnorm.device)
        scale = torch.clamp(clip / torch.clamp(gnorm, min=1e-9), max=1.0)
        count = state.count + 1
        lr = self.schedule(count)
        c1 = 1 - self.b1 ** count.to(torch.float32)
        c2 = 1 - self.b2 ** count.to(torch.float32)

        mu, nu = {}, {}
        for k, p in leaves.items():
            if mesh is None:
                new, mu[k], nu[k] = self._leaf(
                    p, grads[k], state.mu[k], state.nu[k], scale, lr, c1, c2,
                    k in decayed)
                p.copy_(new)
                continue
            from torch.distributed.tensor import DTensor
            place = state.mu[k].placements
            new, m, v = self._leaf(
                p.redistribute(mesh, place).to_local(),
                grads[k].redistribute(mesh, place).to_local(),
                state.mu[k].to_local(), state.nu[k].to_local(), scale, lr,
                c1, c2, k in decayed)
            new = DTensor.from_local(new.to(p.dtype), mesh, place,
                                     run_check=False, shape=p.shape,
                                     stride=p.stride())
            p.to_local().copy_(new.redistribute(mesh, p.placements)
                               .to_local())
            mu[k], nu[k] = (DTensor.from_local(t, mesh, place,
                                               run_check=False,
                                               shape=p.shape,
                                               stride=p.stride())
                            for t in (m, v))
        return OptState(mu, nu, count), {"grad_norm": gnorm, "lr": lr}

    def _leaf(self, p, g, mu, nu, scale, lr, c1, c2, decay: bool):
        """One leaf's update: (the new parameter in float32, mu, nu)."""
        g = g.to(torch.float32) * scale
        m = self.b1 * mu + (1 - self.b1) * g
        v = self.b2 * nu + (1 - self.b2) * g * g
        step = lr * (m / c1) / (torch.sqrt(v / c2) + self.eps)
        if decay:
            step = step + lr * self.weight_decay * p.to(torch.float32)
        return p.to(torch.float32) - step, m, v


def _mesh_of(leaves: dict):
    """The device mesh of DTensor parameters, None for plain tensors."""
    from torch.distributed.tensor import DTensor
    first = next(iter(leaves.values()))
    return first.device_mesh if isinstance(first, DTensor) else None


def _local(t):
    """(the local tensor, how many ranks hold the same block)."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(t, DTensor):
        return t, 1
    copies = 1
    for i, p in enumerate(t.placements):
        if isinstance(p, Replicate):
            copies *= t.device_mesh.size(i)
    return t.to_local(), copies


def _moments(params, ctx) -> dict:
    """float32 zeros placed by ``sharding.opt_state_specs``."""
    from torch.distributed.tensor import zeros
    from repro_torch.distributed import sharding
    leaves = named_leaves(params)
    pspecs = sharding.param_specs(leaves, ctx, params.cfg)
    mspecs = sharding.opt_state_specs(pspecs, leaves, ctx, cfg=params.cfg)
    names = ctx.mesh.mesh_dim_names
    return {k: zeros(p.shape, dtype=torch.float32, device_mesh=ctx.mesh,
                     placements=sharding.placements(
                         sharding.guarded(mspecs[k], p.shape, ctx), names))
            for k, p in leaves.items()}
