"""Config schema and registry for the LM architectures and input shapes.

The port's own copy of ``repro.configs.base``: the same fields, defaults and
numbers, so a config compares equal field by field across the packages.
The port runs eager layers: ``seq_shard`` splits the residual stream
along the sequence at the layer boundary on an LM mesh,
``scan_layers`` only decides which leaves the reference stacks (so which
ones its weight decay and its sharding rules see with a layer axis,
``models/convert.py``, ``distributed/sharding.py``), and ``remat ==
"full"`` recomputes each block in the backward pass.  ``cells`` lists the
dry-run's (arch, shape) cells (``launch/dryrun.py``).  ``ARCH_IDS`` lists the reference's ten architectures in its
order: decoders of attention, mixture-of-experts, RWKV-6 and RG-LRU
blocks, and the Whisper encoder-decoder.
"""
from __future__ import annotations

import dataclasses
import importlib

VOCAB_PAD = 256  # vocabs padded up so `model`-axis sharding divides evenly


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # block construction; cycled over layers
    block_pattern: tuple[str, ...] = ("attn",)   # attn|moe|rwkv|rec|lattn
    mlp_type: str = "swiglu"                     # swiglu | geglu | gelu
    norm_type: str = "rmsnorm"                   # rmsnorm | layernorm
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float | None = 10000.0
    local_window: int | None = None              # for "lattn" blocks
    embed_scale_sqrt_dim: bool = False
    tie_embeddings: bool = True
    # MoE
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_type: str = "softmax"
    moe_shared_expert: bool = False
    # recurrent (rglru)
    rnn_width: int = 0
    conv_width: int = 4
    # encoder-decoder (whisper): encoder layers + stub frontend length
    encoder_layers: int = 0
    encoder_seq: int = 0
    # implementation knobs of the reference
    wkv_impl: str = "chunked"                    # scan | chunked
    scan_layers: bool = True
    remat: str = "full"                          # none | full
    seq_shard: bool = True                       # SP: layer-boundary seq/TP
    dtype: str = "bfloat16"
    # long-context capability: sub-quadratic archs only
    supports_long_context: bool = False

    @property
    def padded_vocab(self) -> int:
        return -(-self.vocab_size // VOCAB_PAD) * VOCAB_PAD

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def block_kind(self, layer: int) -> str:
        return self.block_pattern[layer % len(self.block_pattern)]

    @property
    def homogeneous(self) -> bool:
        return len(self.block_pattern) == 1

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                                    # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

ARCH_IDS = [
    "rwkv6_3b",
    "llama4_scout_17b_a16e",
    "dbrx_132b",
    "chameleon_34b",
    "gemma_7b",
    "mistral_nemo_12b",
    "qwen1_5_0_5b",
    "phi3_mini_3_8b",
    "recurrentgemma_2b",
    "whisper_small",
]


def _module(arch: str):
    name = arch.replace("-", "_")
    if name not in ARCH_IDS:
        raise ValueError(f"unknown architecture {arch!r} (known: "
                         f"{ARCH_IDS})")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).config()


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()


def cells(archs=None, shapes=None):
    """All (arch, shape) dry-run cells with the reference's sanctioned
    skips: ``(arch, shape, skip reason or None)``."""
    out = []
    for a in archs or ARCH_IDS:
        cfg = get_config(a)
        for s in shapes or SHAPES:
            skip = None
            if SHAPES[s].name == "long_500k" and \
                    not cfg.supports_long_context:
                skip = ("full-attention arch: 500k dense KV pass is "
                        "quadratic; skipped as in the reference")
            out.append((a, s, skip))
    return out
