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
* Layers: a scanned stack (``blocks`` of ``cfg.scan_layers`` and one
  block kind, and the encoder-decoder's ``enc_blocks`` / ``dec_blocks``,
  which the reference always stacks: every leaf has a leading layer axis)
  is unstacked, layer ``i`` taking index ``i``; a list of per-layer trees
  (recurrentgemma's mixed kinds) is taken as it is.
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
    depth = {"blocks": cfg.num_layers, "enc_blocks": cfg.encoder_layers,
             "dec_blocks": cfg.num_layers}
    state: dict = {}
    for key, node in tree.items():
        if key not in depth:
            _flatten(key, node, state)
        elif isinstance(node, (list, tuple)):
            for i, block in enumerate(node):
                _flatten(f"{key}.{i}", block, state)
        else:
            for i in range(depth[key]):
                _flatten(f"{key}.{i}", node, state, index=i)
    return state
