"""JAX parameters to the port's state dict.

``params_from_jax(cfg, tree)`` takes the reference's parameter tree
(``repro.models.transformer.init_params``) with numpy leaves
(``jax.tree.map(np.asarray, params)``; bfloat16 leaves may carry
``ml_dtypes``' dtype) and returns the flat state dict that
``Model.load`` takes.

* Names: a key is the tree path joined by dots, with the layer index
  after ``blocks`` (``blocks.3.attn.wq``, ``blocks.3.attn.q_norm.scale``).
* Layers: a scanned stack (``cfg.scan_layers`` and one block kind: every
  leaf under ``blocks`` has a leading layer axis) is unstacked, layer ``i``
  taking index ``i``; a list of per-layer trees is taken as it is.
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


def params_from_jax(cfg: ModelConfig, tree: dict) -> dict:
    state: dict = {}
    for key, node in tree.items():
        if key != "blocks":
            _flatten(key, node, state)
        elif isinstance(node, (list, tuple)):
            for i, block in enumerate(node):
                _flatten(f"blocks.{i}", block, state)
        else:
            for i in range(cfg.num_layers):
                _flatten(f"blocks.{i}", node, state, index=i)
    return state
