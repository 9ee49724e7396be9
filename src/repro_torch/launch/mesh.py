"""LM meshes over the ``torch.distributed`` process group.

Counterpart of ``repro.launch.mesh``: functions, so importing this module
touches no process group.  The target is a (16, 16) ``("data", "model")``
mesh of 256 ranks, or (2, 16, 16) ``("pod", "data", "model")`` of 512,
``pod`` being pure data parallelism.  With fewer ranks the production
mesh shrinks as the reference's does: (2, 4) or (2, 2, 2) from 8 ranks,
else all ones.  A mesh covers every rank of the group: a world larger
than the mesh raises, since its other ranks would have no place.

:func:`init_process_group` starts the group where nothing else has: on
the card ``nccl`` over a ``HashStore`` (one rank, no network), on the
host ``gloo`` with the caller's rank, world size and ``init_method``
(``file://...`` or ``tcp://localhost:<port>``).  There is no fallback
from one backend to the other: without CUDA it raises unless the CPU is
asked for.  ``launch/dryrun.py`` starts a ``fake`` group of 256 or 512
ranks in one process instead.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from repro_torch.distributed.context import LMContext

_DEVICE_TYPES = {"nccl": "cuda", "gloo": "cpu"}


def init_process_group(device=None, *, rank: int | None = None,
                       world_size: int | None = None,
                       init_method: str | None = None) -> None:
    """Start the default process group unless one is running.

    ``device`` ``None`` or ``"cuda"``: ``nccl``; ``"cpu"``: ``gloo``.  By
    default one rank over a ``HashStore``; several ranks need ``rank``,
    ``world_size`` and ``init_method`` (``env://`` under ``torchrun``)."""
    if dist.is_initialized():
        return
    if device is not None and torch.device(device).type == "cpu":
        if rank is None and world_size is None and init_method is None:
            dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                    world_size=1)
            return
        if None in (rank, world_size, init_method):
            raise ValueError("a gloo group of several ranks needs rank, "
                             "world_size and init_method")
        dist.init_process_group("gloo", init_method=init_method, rank=rank,
                                world_size=world_size)
        return
    if not torch.cuda.is_available():
        raise RuntimeError(
            "the LM mesh runs on the CUDA devices with nccl by default and "
            "no CUDA device is available; pass device='cpu' (gloo) to run "
            "on the host")
    if rank is None and world_size is None and init_method is None:
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                                world_size=1)
        return
    local = int(os.environ.get("LOCAL_RANK", rank))   # set by torchrun
    torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group("nccl", init_method=init_method, rank=rank,
                            world_size=world_size)


def _mesh(shape: tuple, names: tuple, device_type: str | None = None):
    from torch.distributed.device_mesh import init_device_mesh
    n = dist.get_world_size()
    size = 1
    for s in shape:
        size *= s
    if size != n:
        raise ValueError(f"a {shape} mesh needs {size} ranks; the process "
                         f"group has {n}")
    return init_device_mesh(device_type or _DEVICE_TYPES[dist.get_backend()],
                            shape, mesh_dim_names=names)


def production_shape(n: int, *, multi_pod: bool = False) -> tuple:
    """The production mesh's shape for a world of ``n`` ranks (the
    reference's shrink rule)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    if n < (512 if multi_pod else 256):
        shape = (2, 2, 2) if multi_pod else (2, 4)
        if n < 8:
            shape = (1, 1, 1) if multi_pod else (1, 1)
    return shape


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str | None = None):
    """``device_type`` places the mesh of a fake group (a dry run's); by
    default the group's backend gives it."""
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(production_shape(dist.get_world_size(),
                                  multi_pod=multi_pod), axes, device_type)


def make_context(*, multi_pod: bool = False,
                 device_type: str | None = None) -> LMContext:
    mesh = make_production_mesh(multi_pod=multi_pod, device_type=device_type)
    dp = ("pod", "data") if multi_pod else ("data",)
    return LMContext(mesh=mesh, dp_axes=dp, tp_axis="model")


def make_small_context(data: int = 1, model: int = 1) -> LMContext:
    """A (data, model) mesh over the group's ranks (tests, examples)."""
    return LMContext(mesh=_mesh((data, model), ("data", "model")),
                     dp_axes=("data",), tp_axis="model")


def auto_context() -> LMContext:
    """One data axis across every rank of the group, model axis 1."""
    return make_small_context(data=dist.get_world_size(), model=1)
