"""Shared neural-net layers of the LM path, as functions over tensors.

Counterpart of ``repro.models.layers``.  Dense weights keep the reference's
``(in, out)`` layout, so ``x @ w`` is the projection.  Every product
accumulates in float32 and is cast back to the activation dtype: a
bfloat16 ``torch.matmul`` does exactly that, and operands of two dtypes
are promoted as jnp promotes them (:func:`matmul`).  Initializers draw
from an explicit ``torch.Generator`` on the tensor's device.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def dense_init(shape, *, generator: torch.Generator, device,
               scale: float | None = None, dtype=torch.float32
               ) -> torch.Tensor:
    """Truncated-normal fan-in init (stddev 1/sqrt(fan_in) by default),
    drawn in float32 on ``device`` and cast to ``dtype``."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    std = scale if scale is not None else fan_in ** -0.5
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return w.mul_(std).to(dtype)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the activation dtype, accumulated in float32.

    Operands of two dtypes multiply in float32, as jnp promotes them (a
    float32 activation against bfloat16 weights: Whisper's float32
    frames), and the product is cast to ``x``'s dtype."""
    if x.dtype != w.dtype:
        return torch.matmul(x.float(), w.float()).to(x.dtype)
    return torch.matmul(x, w)


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with a float32 result (``preferred_element_type=f32``):
    bfloat16 products are exact in float32, so widening first is the same
    arithmetic."""
    return torch.matmul(x.float(), w.float())


def bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched ``a @ b`` with a float32 result (``preferred_element_type=
    f32``).  bfloat16 operands on the card go to one product with a
    float32 output (``out_dtype``), so no widened copy of the weights is
    made; elsewhere the operands are widened first, the same arithmetic."""
    if a.is_cuda and a.dtype == torch.bfloat16:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm(scale: torch.Tensor, x: torch.Tensor, *, eps: float = 1e-6
            ) -> torch.Tensor:
    """RMSNorm with the (1 + scale) parameterization (scale init 0)."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.float())).to(dt)


def layernorm(scale: torch.Tensor, bias: torch.Tensor, x: torch.Tensor, *,
              eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with the (1 + scale) parameterization and a bias (both
    init 0), computed in float32 and cast back."""
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.float()) + bias.float()).to(dt)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, *, theta: float = 10000.0
         ) -> torch.Tensor:
    """Apply RoPE. x: (..., S, H, hd); positions: (..., S) integer.  The
    angles are float32, as the reference computes them."""
    hd = x.shape[-1]
    half = hd // 2
    exponent = -torch.arange(0, half, dtype=torch.float32,
                             device=x.device) / half
    freq = torch.pow(torch.full((), theta, dtype=torch.float32,
                                device=x.device), exponent)
    angles = positions[..., None].float() * freq            # (..., S, half)
    angles = angles[..., None, :]                           # (..., S, 1, half)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_shapes(d_model: int, d_ff: int, mlp_type: str) -> dict:
    """Parameter shapes of an MLP, in the reference's names and order."""
    if mlp_type in ("swiglu", "geglu"):
        return {"w_gate": (d_model, d_ff), "w_up": (d_model, d_ff),
                "w_down": (d_ff, d_model)}
    if mlp_type == "gelu":
        return {"w_in": (d_model, d_ff), "b_in": (d_ff,),
                "w_out": (d_ff, d_model), "b_out": (d_model,)}
    raise ValueError(mlp_type)


def mlp_apply(p, x: torch.Tensor, mlp_type: str) -> torch.Tensor:
    """``p`` maps the names of :func:`mlp_shapes` to tensors."""
    if mlp_type == "swiglu":
        gate = F.silu(matmul(x, p["w_gate"]))
        return matmul(gate * matmul(x, p["w_up"]), p["w_down"])
    if mlp_type == "geglu":
        gate = F.gelu(matmul(x, p["w_gate"]), approximate="tanh")
        return matmul(gate * matmul(x, p["w_up"]), p["w_down"])
    if mlp_type == "gelu":
        h = F.gelu(matmul(x, p["w_in"]) + p["b_in"], approximate="tanh")
        return matmul(h, p["w_out"]) + p["b_out"]
    raise ValueError(mlp_type)


# ---------------------------------------------------------------------------
# Embeddings / unembedding / loss
# ---------------------------------------------------------------------------

def embed_apply(embedding: torch.Tensor, tokens: torch.Tensor, *,
                scale_by_sqrt_dim: bool = False) -> torch.Tensor:
    emb = embedding[tokens]
    if scale_by_sqrt_dim:
        emb = emb * torch.full((), emb.shape[-1] ** 0.5, dtype=emb.dtype,
                               device=emb.device)
    return emb


def unembed(embedding: torch.Tensor, x: torch.Tensor, *,
            head: torch.Tensor | None = None) -> torch.Tensor:
    """float32 logits: tied (embedding.T) unless a head matrix is given."""
    return matmul_f32(x, head if head is not None else embedding.T)


def remat(fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, recomputed in the backward pass instead of
    keeping its intermediates (the reference's ``jax.checkpoint`` with
    nothing saveable) when autograd records; a plain call otherwise."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False, **kwargs)
    return fn(*args, **kwargs)


def _xent_chunk(h, w, targets, mask, vocab_ok, z_loss: float):
    logits = matmul_f32(h, w)
    logits = torch.where(vocab_ok, logits, -1e30)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, 1, targets[:, None])[:, 0]
    nll = lse - gold
    if z_loss:
        nll = nll + z_loss * lse ** 2
    return torch.sum(nll * mask)


def chunked_softmax_xent(h: torch.Tensor, w: torch.Tensor,
                         targets: torch.Tensor, mask: torch.Tensor, *,
                         valid_vocab: int, chunk: int = 4096,
                         z_loss: float = 1e-4) -> torch.Tensor:
    """Mean masked cross-entropy (+ z-loss) without materializing the
    (tokens, V) float32 logits of the whole batch: tokens go in chunks,
    each recomputed in the backward pass (:func:`remat`), as the
    reference's are.

    h: (B, S, D) final hidden states; w: (D, V) unembedding.  The last
    chunk is shorter instead of padded (padding rows carry mask 0 in the
    reference, so the sum is the same)."""
    d = h.shape[-1]
    hf = h.reshape(-1, d)
    tf = targets.reshape(-1).long()
    mf = mask.reshape(-1).float()
    v = w.shape[-1]
    vocab_ok = torch.arange(v, device=h.device) < valid_vocab
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, hf.shape[0], chunk):
        total = total + remat(_xent_chunk, hf[i:i + chunk], w,
                              tf[i:i + chunk], mf[i:i + chunk], vocab_ok,
                              z_loss)
    return total / torch.clamp(torch.sum(mf), min=1.0)
