"""Checkpoints: save/restore trees of tensors with rotation, in the
reference's on-disk format (``repro.checkpoint.ckpt``), without JAX or
``ml_dtypes``.

Format: one directory per step, ``step_%08d/``, holding ``manifest.json``
(``step``, the caller's ``metadata`` and, per leaf, its ``file``,
``dtype`` by numpy's name and ``shape``) and one ``leaf_%05d.npy`` per
leaf; bfloat16 is stored as its uint16 bits.  A leaf's key is its tree
path joined by ``/``: dict keys, NamedTuple field names, list and tuple
indices; an ``nn.Module`` is flattened through its ``state_dict()`` with
``.`` turned into ``/`` (and so are the dots of a dict key, so the
moments keyed by state-dict names sit beside their parameters' paths).
Each side reads the other's files.

Writes are atomic (``.tmp_step_*`` then a rename); ``keep`` rotates the
oldest steps out.  Every save copies the tree to host memory before it
returns, so the caller may update the tensors in place at once: the
training step writes its parameters in place where the reference donates
them.  ``AsyncCheckpointer`` then serializes on a worker thread.

``restore`` puts each leaf on ``device`` (by default the target leaf's),
so a checkpoint written on the card restores onto the host and back;
``read`` needs no target and returns numpy arrays.

On an LM mesh the leaves are DTensors: a save gathers each whole tensor,
leaf by leaf (every rank takes part), and one rank (rank 0 of the
process group) copies it to host memory and writes it, as the reference
stores unsharded arrays; the other ranks drop their gathered copy at
once and keep nothing on the host.  The ranks then wait for the files.
``restore`` into DTensor leaves keeps each rank's block of the stored
tensor under the target's placements, so a checkpoint written on one
mesh restores onto any other.
"""
from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path

import numpy as np
import torch
from torch import nn


def _items(tree, path: tuple = ()):
    """(key path, leaf) pairs in the tree's order."""
    if isinstance(tree, nn.Module):
        for name, t in tree.state_dict(keep_vars=True).items():
            yield path + tuple(name.split(".")), t
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _items(v, path + tuple(str(k).split(".")))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k, v in zip(tree._fields, tree):
            yield from _items(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _items(v, path + (str(i),))
    else:
        yield path, tree


def _key(path: tuple) -> str:
    return "/".join(path) or "_root"


def _rebuild(tree, leaf_fn, path: tuple = ()):
    """``tree``'s structure with each leaf replaced by ``leaf_fn(key,
    leaf)``; a module is loaded in place (its tensors replaced) and
    returned."""
    if isinstance(tree, nn.Module):
        state = {name: leaf_fn(_key(path + tuple(name.split("."))), t)
                 for name, t in tree.state_dict(keep_vars=True).items()}
        tree.load_state_dict(state, assign=True)
        return tree
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaf_fn, path + tuple(str(k).split(".")))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(v, leaf_fn, path + (k,))
                            for k, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaf_fn, path + (str(i),))
                          for i, v in enumerate(tree))
    return leaf_fn(_key(path), tree)


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _writer() -> bool:
    """Whether this process writes (rank 0, or no process group)."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def _barrier() -> None:
    import torch.distributed as dist
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def _host(leaf) -> tuple[np.ndarray, str]:
    """A copy of ``leaf`` in host memory and its dtype's numpy name
    (bfloat16 as its uint16 bits)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.array(leaf)
    return arr, str(arr.dtype)


def _to_host(tree) -> list | None:
    """The writer's host copy of every leaf, a DTensor gathered whole one
    leaf at a time; ``None`` on the other ranks, which take part in each
    gather and keep nothing."""
    writer = _writer()
    host = []
    for path, leaf in _items(tree):
        if _is_dtensor(leaf):
            leaf = leaf.full_tensor()
        if writer:
            host.append((_key(path), *_host(leaf)))
    return host if writer else None


def save(ckpt_dir, step: int, tree, *, metadata: dict | None = None,
         keep: int = 3) -> None:
    """Synchronous checkpoint write (atomic)."""
    host = _to_host(tree)
    if host is not None:
        _write(Path(ckpt_dir), step, host, metadata or {}, keep)
    _barrier()


class AsyncCheckpointer:
    """Serialize to disk off-thread; ``join()`` before exit or reading.
    ``save`` returns once the tree is copied to host memory."""

    def __init__(self):
        self._thread: threading.Thread | None = None

    def save(self, ckpt_dir, step: int, tree, *, metadata=None, keep=3):
        host = _to_host(tree)
        self.join()
        if host is None:
            return
        self._thread = threading.Thread(
            target=_write,
            args=(Path(ckpt_dir), step, host, metadata or {}, keep),
            daemon=True)
        self._thread.start()

    def join(self) -> None:
        """Wait for the last write (on a mesh every rank waits for it)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        _barrier()


def _write(root: Path, step: int, host: list, metadata: dict,
           keep: int) -> None:
    final = root / f"step_{step:08d}"
    tmp = root / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {"step": step, "metadata": metadata, "leaves": {}}
    for i, (key, arr, dtype) in enumerate(host):
        fname = f"leaf_{i:05d}.npy"
        np.save(tmp / fname, arr, allow_pickle=False)
        manifest["leaves"][key] = {"file": fname, "dtype": dtype,
                                   "shape": list(arr.shape)}
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    steps = sorted(p for p in root.glob("step_*") if p.is_dir())
    for old in steps[:-keep] if keep else []:
        shutil.rmtree(old)


def latest_step(ckpt_dir) -> int | None:
    root = Path(ckpt_dir)
    if not root.exists():
        return None
    steps = sorted(root.glob("step_*"))
    if not steps:
        return None
    return int(steps[-1].name.split("_")[1])


def _manifest(ckpt_dir, step: int | None) -> tuple[Path, dict, int]:
    root = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {root}")
    d = root / f"step_{step:08d}"
    return d, json.loads((d / "manifest.json").read_text()), step


def _tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def read(ckpt_dir, step: int | None = None):
    """Every leaf of a checkpoint without a target: ``({key: numpy
    array}, metadata, step)``.  numpy has no bfloat16 of its own, so a
    bfloat16 leaf comes back widened to float32 (exactly)."""
    d, manifest, step = _manifest(ckpt_dir, step)
    out = {}
    for key, meta in manifest["leaves"].items():
        arr = np.load(d / meta["file"], allow_pickle=False)
        out[key] = _tensor(arr, meta["dtype"]).float().numpy() \
            if meta["dtype"] == "bfloat16" else arr
    return out, manifest["metadata"], step


def nest(flat: dict) -> dict:
    """Flat ``/``-joined keys (as :func:`read` returns them) as nested
    dicts."""
    tree: dict = {}
    for key, value in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree


def restore(ckpt_dir, target, *, step: int | None = None, device=None):
    """Restore into the structure of ``target`` (shapes must match; the
    stored dtypes are kept).  Each leaf goes to ``device``, by default
    the target leaf's device (the host for a non-tensor leaf); a module
    in ``target`` is loaded in place.  Returns (tree, metadata, step)."""
    d, manifest, step = _manifest(ckpt_dir, step)

    def load(key, leaf):
        meta = manifest["leaves"].get(key)
        if meta is None:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        t = _tensor(np.load(d / meta["file"], allow_pickle=False),
                    meta["dtype"])
        want = tuple(leaf.shape) if isinstance(leaf, torch.Tensor) \
            else np.shape(leaf)
        if tuple(t.shape) != tuple(want):
            raise ValueError(f"shape mismatch for {key}: "
                             f"{tuple(t.shape)} vs {tuple(want)}")
        if _is_dtensor(leaf):
            from torch.distributed.tensor import DTensor
            from repro_torch.distributed.sharding import local_shard
            local = local_shard(t, leaf.placements, leaf.device_mesh)
            return DTensor.from_local(
                local.to(leaf.to_local().device),
                leaf.device_mesh, leaf.placements, run_check=False,
                shape=t.shape, stride=t.stride())
        dev = device if device is not None else (
            leaf.device if isinstance(leaf, torch.Tensor) else "cpu")
        return t.to(dev)

    return _rebuild(target, load), manifest["metadata"], step
