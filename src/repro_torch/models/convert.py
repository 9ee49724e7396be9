"""JAX parameters to the port's state dict.

``params_from_jax(cfg, tree)`` takes the reference's parameter tree
(``repro.models.transformer.init_params`` or, for an encoder-decoder
config, ``repro.models.encdec.init_params``) with numpy leaves
(``jax.tree.map(np.asarray, params)``; bfloat16 leaves may carry
``ml_dtypes``' dtype) and returns the flat state dict that
``Model.load`` takes.

* Names: a key is the tree path joined by dots, with the layer index
  after the stack's name (``blocks.3.attn.wq``,
  ``blocks.3.attn.q_norm.scale``, ``dec_blocks.0.cross_attn.wk``).
* Layers: a scanned stack (:func:`reference_stacked`: ``blocks`` of
  ``cfg.scan_layers`` and one block kind, and the encoder-decoder's
  ``enc_blocks`` / ``dec_blocks``, which the reference always stacks:
  every leaf has a leading layer axis) is unstacked, layer ``i`` taking
  index ``i``; a list of per-layer trees (recurrentgemma's mixed kinds),
  or a dict keyed by the layer index as a checkpoint's keys nest it, is
  taken as it is.

``train_state_from_jax(cfg, params_tree, opt_state_tree)`` converts a
reference train state (its parameters and ``OptState``, e.g. nested from
``checkpoint.ckpt.read``) into the port's: the moments are unstacked as
the parameters are.
* Layout: dense weights are ``(in, out)`` in both packages (``x @ w``),
  the embedding ``(vocab, d_model)`` and the head ``(d_model, vocab)``, so
  nothing is transposed.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


def _tensor(a) -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.name == "bfloat16":          # numpy extension dtype
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _flatten(prefix: str, node, out: dict, index=None) -> None:
    if isinstance(node, dict):
        for key, child in node.items():
            _flatten(f"{prefix}.{key}", child, out, index)
    else:
        out[prefix] = _tensor(node if index is None else np.asarray(node)[index])


STACKS = ("blocks", "enc_blocks", "dec_blocks")


def reference_stacked(cfg: ModelConfig, name: str) -> bool:
    """Whether the reference keeps the parameter ``name`` (a state-dict
    name) in a stack it scans, with a leading layer axis: ``blocks`` of a
    homogeneous ``scan_layers`` config, and ``enc_blocks``/``dec_blocks``
    always."""
    stack = name.split(".", 1)[0]
    if stack == "blocks":
        return cfg.homogeneous and cfg.scan_layers
    return stack in ("enc_blocks", "dec_blocks")


def reference_ndim(cfg: ModelConfig, name: str, tensor) -> int:
    """The rank of the reference's leaf behind the port's ``name``: one
    more than the port's where the reference stacks it."""
    return tensor.ndim + reference_stacked(cfg, name)


def _depth(cfg: ModelConfig, stack: str) -> int:
    return cfg.encoder_layers if stack == "enc_blocks" else cfg.num_layers


def params_from_jax(cfg: ModelConfig, tree: dict) -> dict:
    state: dict = {}
    for key, node in tree.items():
        if key not in STACKS:
            _flatten(key, node, state)
        elif reference_stacked(cfg, key):
            for i in range(_depth(cfg, key)):
                _flatten(f"{key}.{i}", node, state, index=i)
        else:
            for i in range(_depth(cfg, key)):
                block = node[i] if isinstance(node, (list, tuple)) \
                    else node[str(i)]
                _flatten(f"{key}.{i}", block, state)
    return state


def _field(node, name: str):
    return node[name] if isinstance(node, dict) else getattr(node, name)


def train_state_from_jax(cfg: ModelConfig, params_tree: dict,
                         opt_state_tree):
    """(state dict for ``Model.load``, ``OptState``) from the reference's
    parameters and optimizer state (an ``OptState`` or a dict with its
    ``mu``, ``nu`` and ``count``), numpy leaves.  The moments are keyed
    by the port's state-dict names, float32 on the host; ``count`` is a
    0-d int32 tensor."""
    from repro_torch.optim.adamw import OptState
    mu, nu = (params_from_jax(cfg, _field(opt_state_tree, k))
              for k in ("mu", "nu"))
    count = _tensor(_field(opt_state_tree, "count")).to(torch.int32)
    return params_from_jax(cfg, params_tree), OptState(
        {k: v.float() for k, v in mu.items()},
        {k: v.float() for k, v in nu.items()}, count.reshape(()))
