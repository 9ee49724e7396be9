"""Device context of the distributed PH pipeline.

Counterpart of ``repro.distributed.context`` (``DistContext``,
``single_device_ctx``) and of ``repro.launch.mesh.auto_context`` for the
PixHomology pipeline only (the LM meshes are not ported).  The reference
shards a round over the data axes of a JAX mesh; the port's context is a
list of ``torch.device``s, one executor each: a round's ``(M, Hb, Wb)``
batch gives each device its own rows (``M == dp_size`` in the pipeline,
so one image per device).  One H100 is a context of one device, and
``PHEngine.run_distributed`` defaults to the engine's device alone: a
context of several runs its devices one after another on one thread
(``PHEngine.sharded_plan``), so :func:`auto_context` is for an explicit
multi-card run only.
"""
from __future__ import annotations

import dataclasses

import torch


def canonical_device(device) -> torch.device:
    """``device`` with the CUDA index filled in (``cuda`` names the current
    device), so two names of one device compare equal."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass(frozen=True)
class DistContext:
    """The executors of a distributed run: one per device, in order."""

    devices: tuple[torch.device, ...]

    def __post_init__(self):
        devs = tuple(canonical_device(d) for d in self.devices)
        if not devs:
            raise ValueError("a DistContext needs at least one device")
        object.__setattr__(self, "devices", devs)

    @property
    def dp_size(self) -> int:
        """Data-parallel width: executors per round."""
        return len(self.devices)


def single_device_ctx(device=None) -> DistContext:
    """A context of one device (default: the CUDA device; raises without
    one)."""
    if device is None:
        _require_cuda()
        device = "cuda"
    return DistContext((device,))


def auto_context(device=None) -> DistContext:
    """Context over the devices that exist: every CUDA device, one executor
    each (asked for explicitly: the devices run one after another).
    ``device`` narrows it: ``"cpu"`` gives one host executor, ``"cuda:k"``
    the one card; plain ``"cuda"`` means every card.  Raises without CUDA
    unless the CPU is asked for."""
    if device is not None and torch.device(device) != torch.device("cuda"):
        return DistContext((device,))
    _require_cuda()
    return DistContext(tuple(torch.device("cuda", i)
                             for i in range(torch.cuda.device_count())))


def _require_cuda() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "the distributed pipeline runs on the CUDA devices by default "
            "and no CUDA device is available; pass device='cpu' to run on "
            "the host")
