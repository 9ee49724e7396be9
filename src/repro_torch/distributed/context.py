"""Device contexts: the PH pipeline's executors and the LM mesh.

Counterpart of ``repro.distributed.context``.  Two contexts:

* :class:`LMContext`, the reference's ``DistContext`` of the LM: a
  ``torch.distributed`` ``DeviceMesh`` with named dims (``("data",
  "model")`` or ``("pod", "data", "model")``), the batch axes
  (``dp_axes``) and the tensor/expert-parallel axis (``tp_axis``).  Its
  ``shape`` maps axis names to sizes, so the sharding rules
  (``distributed/sharding.py``) take it as their mesh.  ``launch/mesh.py``
  builds it over the process group.
* :class:`DistContext`, the PH pipeline's (with ``single_device_ctx``
  and ``auto_context`` here).  The reference shards a round over the
  data axes of a JAX mesh; the port's context is a list of
  ``torch.device``s, one executor each: a round's ``(M, Hb, Wb)`` batch
  gives each device its own rows (``M == dp_size`` in the pipeline, so
  one image per device).  One H100 is a context of one device, and
  ``PHEngine.run_distributed`` defaults to the engine's device alone: a
  context of several runs its devices one after another on one thread
  (``PHEngine.sharded_plan``), so :func:`auto_context` is for an explicit
  multi-card run only.
"""
from __future__ import annotations

import dataclasses
import math

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


@dataclasses.dataclass(frozen=True)
class LMContext:
    """An LM mesh: a ``DeviceMesh`` with named dims and the roles of its
    axes (the reference's ``DistContext(mesh, dp_axes, tp_axis)``)."""

    mesh: object                           # torch DeviceMesh
    dp_axes: tuple[str, ...] = ("data",)   # batch axes (pod + data)
    tp_axis: str | None = "model"          # tensor/expert-parallel axis
    shape: dict = dataclasses.field(init=False, compare=False)

    def __post_init__(self):
        # Axis name -> size, read once: the mesh keeps its ranks in a
        # tensor, which a fake-tensor trace (launch/dryrun.py) must not
        # touch.
        object.__setattr__(self, "shape", dict(zip(
            self.mesh.mesh_dim_names, self.mesh.mesh.shape)))

    def axis_size(self, name: str | None) -> int:
        if name is None:
            return 1
        return self.shape[name]

    @property
    def dp_size(self) -> int:
        return math.prod(self.shape[a] for a in self.dp_axes)

    @property
    def device(self) -> torch.device:
        """This rank's device: the current CUDA device on a CUDA mesh."""
        if self.mesh.device_type == "cuda":
            # a fake process group (launch/dryrun.py) may have no card
            return canonical_device("cuda") if torch.cuda.is_available() \
                else torch.device("cuda")
        return torch.device(self.mesh.device_type)

    def group(self, axis: str):
        return self.mesh.get_group(axis)

    def rank(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self.mesh.get_local_rank(axis)

    def dp_rank(self) -> int:
        """This rank's place along the batch axes, first axis major."""
        r = 0
        for a in self.dp_axes:
            r = r * self.shape[a] + self.rank(a)
        return r
