"""**Language-model** serving: prefill + greedy decode over one batch.

Counterpart of ``repro.launch.serve_lm``.  As the reference's, it runs
on an LM mesh of the running process group when it has several ranks
(``make_small_context(data=world, model=1)``), or on the caller's
``ctx``; each rank then prefills and decodes its share of the batch
against its block of the caches and the tokens are gathered at the end.
Without a process group (or with one rank) it runs on one device.  The weights are
random, drawn on the model's device from a ``torch.Generator`` seeded
with ``seed`` (a 12 B-parameter model is never drawn on the host), unless
the caller hands in built ``params``; the prompts are drawn with numpy
from the same seed, as the reference draws them, and for an
encoder-decoder config (whisper_small) the float32 frames right after
them from the same generator.  The KV caches are
updated in place by each decode step (the reference's are functional).
Tokens stay on the device until the end, so decode does no per-step
readback.

    PYTHONPATH=src python -m repro_torch.launch.serve_lm --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve_lm --full-config \
        --arch mistral_nemo_12b          # on the card

Every registered architecture serves (``configs.base.ARCH_IDS``: the
decoders of attention, mixture-of-experts, RWKV-6 and RG-LRU blocks, and
the Whisper encoder-decoder).  On the card a prefill's
attention runs the flash kernel at head dims 64, 128 and 256, and the
plain version at any other (the smoke configs' 16), a route by shape, as
the reference's.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.steps import gather_batch, local_batch
from repro_torch.models.model import Model


def make_prompts(vocab_size: int, batch: int, prompt_len: int,
                 seed: int) -> np.ndarray:
    return make_inputs(vocab_size, batch, prompt_len, seed)["tokens"]


def make_inputs(vocab_size: int, batch: int, prompt_len: int, seed: int,
                frames_shape: tuple | None = None) -> dict:
    """The prompts (``"tokens"``) and, given ``frames_shape`` (S_enc,
    D), the encoder's frames (``"frames"``, float32) drawn next from the
    same generator, as the reference's ``serve`` draws them."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, vocab_size, (batch, prompt_len),
                                  dtype=np.int32)}
    if frames_shape is not None:
        out["frames"] = rng.normal(size=(batch, *frames_shape)).astype(
            np.float32)
    return out


def model_inputs(cfg, batch: int, prompt_len: int, seed: int,
                 device) -> dict:
    """:func:`make_inputs` for ``cfg`` as tensors on ``device``."""
    frames = (cfg.encoder_seq, cfg.d_model) if cfg.is_encdec else None
    host = make_inputs(cfg.vocab_size, batch, prompt_len, seed, frames)
    out = {"tokens": torch.from_numpy(host["tokens"]).to(device).long()}
    if frames is not None:
        out["frames"] = torch.from_numpy(host["frames"]).to(device)
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(arch: str, *, smoke: bool = True, batch: int = 4,
          prompt_len: int = 32, gen_len: int = 32, max_len: int = 128,
          seed: int = 0, device=None, params=None, verbose: bool = True,
          ctx=None):
    """Prefill ``batch`` random prompts and decode ``gen_len`` tokens
    greedily.  Returns (tokens (batch, gen_len) numpy, stats)."""
    if ctx is None and dist.is_initialized() and dist.get_world_size() > 1:
        ctx = mesh_lib.make_small_context(data=dist.get_world_size(),
                                          model=1)
    cfg = params.cfg if params is not None else \
        (get_smoke_config if smoke else get_config)(arch)
    if prompt_len + gen_len - 1 > max_len:
        raise ValueError(f"prompt_len + gen_len - 1 = "
                         f"{prompt_len + gen_len - 1} exceeds max_len "
                         f"{max_len}")
    model = Model(cfg, device=device if ctx is None else ctx.device)
    dev = model.device
    stats = {"arch": cfg.name, "device": str(dev), "batch": batch,
             "prompt_len": prompt_len, "gen_len": gen_len,
             "max_len": max_len}
    if params is None:
        t0 = time.perf_counter()
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = model.init(gen)
        _sync(dev)
        stats["init_s"] = time.perf_counter() - t0
    if ctx is not None:
        params = model.shard(params, ctx)
        stats["mesh"] = ctx.shape

    inputs = local_batch(model_inputs(cfg, batch, prompt_len, seed, dev),
                         ctx)
    _sync(dev)
    t0 = time.perf_counter()
    logits, caches = model.prefill(params, inputs, max_len=max_len, ctx=ctx)
    next_tok = torch.argmax(logits[:, -1:], -1)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    out_tokens = [next_tok]
    t0 = time.perf_counter()
    for _ in range(gen_len - 1):
        logits, caches = model.decode_step(params, next_tok, caches, ctx=ctx)
        next_tok = torch.argmax(logits, -1)
        out_tokens.append(next_tok)
    _sync(dev)
    t_decode = time.perf_counter() - t0

    gen = torch.cat(out_tokens, dim=1)
    if ctx is not None and inputs["tokens"].shape[0] != batch:
        gen = gather_batch(gen, ctx)
    gen = gen.cpu().numpy().astype(np.int32)
    stats.update(prefill_ms=t_prefill * 1e3,
                 decode_tokens_per_s=batch * (gen_len - 1)
                 / max(t_decode, 1e-9),
                 sample_output=gen[0][:16].tolist())
    if verbose and (ctx is None or dist.get_rank() == 0):
        print(json.dumps(stats, indent=1))
    return gen, stats


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1_5_0_5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args()
    serve(args.arch, smoke=not args.full_config, batch=args.batch,
          prompt_len=args.prompt_len, gen_len=args.gen_len,
          device=args.device)


if __name__ == "__main__":
    main()
