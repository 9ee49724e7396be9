"""Model facade: init / loss / prefill / decode_step / init_caches over the
decoder-only and encoder-decoder configs (selected by config), with the
reference facade's names.

Decoders run every block kind of ``cfg.block_pattern`` (``attn``,
``lattn``, ``moe``, ``rwkv``, ``rec``) under rmsnorm or layernorm
(``models/transformer.py``); ``cfg.is_encdec`` selects Whisper's
encoder-decoder (``models/encdec.py``), whose prefill takes
``batch["frames"]`` beside the tokens.

``params`` is the module tree holding the weights on the model's device
(:class:`~repro_torch.models.transformer.Transformer` or
:class:`~repro_torch.models.encdec.EncDec`).  The model runs on the CUDA
device unless the caller passes another ``device`` (the tests pass
``"cpu"``); without CUDA, ``Model(cfg)`` raises instead of falling back.
``plain=True`` selects the plain attention version on the card (the
on-card comparison's reference run); the default runs the flash kernel
on CUDA tensors whose head dim it takes (64, 128, 256) and the plain
version at other head dims.

``ctx`` (an ``LMContext``) runs a step on an LM mesh: the parameters
placed there by :meth:`Model.shard`, the batch this rank's share
(``transformer.loss_fn``, ``encdec.loss_fn``).  Every architecture runs
there: the decoders of every block kind and the encoder-decoder.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, transformer


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA device; raises when there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the LM runs on the CUDA device by default and no CUDA "
                "device is available; pass device='cpu' to run the plain "
                "PyTorch versions on the host")
        return torch.device("cuda")
    return torch.device(device)


class Model:
    def __init__(self, cfg: ModelConfig, *, device=None,
                 plain: bool = False):
        transformer.check_config(cfg)
        self.cfg = cfg
        self._mod = encdec if cfg.is_encdec else transformer
        self.device = resolve_device(device)
        self.plain = plain

    # -- parameters --------------------------------------------------------
    def init(self, generator: torch.Generator):
        """Random weights drawn on the model's device; ``generator`` must
        live there too."""
        return self._mod.init_params(self.cfg, generator=generator,
                                     device=self.device)

    def load(self, state: dict):
        """Weights from a state dict (e.g. ``convert.params_from_jax``)."""
        return self._mod.params_from_state(self.cfg, state,
                                           device=self.device)

    def shard(self, params, ctx):
        """``params`` placed on the mesh of ``ctx`` by the sharding rules
        (``transformer.shard_params``)."""
        return transformer.shard_params(params, ctx)

    # -- steps --------------------------------------------------------------
    def loss_fn(self, params, batch, ctx=None):
        return self._mod.loss_fn(params, batch, plain=self.plain, ctx=ctx)

    def prefill(self, params, batch, *, max_len: int, ctx=None):
        if self.cfg.is_encdec:
            return encdec.prefill(params, batch["frames"], batch["tokens"],
                                  max_len=max_len, plain=self.plain,
                                  ctx=ctx)
        return transformer.prefill(params, batch["tokens"], max_len=max_len,
                                   plain=self.plain, ctx=ctx)

    def decode_step(self, params, token, caches, ctx=None):
        return self._mod.decode_step(params, token, caches, ctx=ctx)

    def init_caches(self, batch: int, max_len: int, ctx=None):
        if self.cfg.is_encdec:
            raise NotImplementedError(
                "encoder-decoder caches come from prefill() (the cross "
                "caches need the encoder's output)")
        return transformer.init_caches(self.cfg, batch, max_len,
                                       device=self.device, ctx=ctx)
