"""Shared neural-net layers of the LM path, as functions over tensors.

Counterpart of ``repro.models.layers``.  Dense weights keep the reference's
``(in, out)`` layout, so ``x @ w`` is the projection.  Every product
accumulates in float32 and is cast back to the activation dtype: a
bfloat16 ``torch.matmul`` does exactly that, and operands of two dtypes
are promoted as jnp promotes them (:func:`matmul`).  Initializers draw
from an explicit ``torch.Generator`` on the tensor's device.

On an LM mesh (``lay``, a ``parallel.Layout``) the MLP is column- then
row-parallel over ``model`` where the sharding rules split its hidden
dim, and per-token work on the residual stream otherwise; the embedding
and the cross-entropy are vocab-parallel where the rules split the vocab
(each rank looks up or scores its vocab slice; the lookups and the
softmax's maxima and sums are all-reduced).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import parallel


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


def mlp_apply(p, x: torch.Tensor, mlp_type: str, lay=None) -> torch.Tensor:
    """``p`` maps the names of :func:`mlp_shapes` to tensors.  With
    ``lay``, ``x`` is the rank's residual stream and so is the result."""
    if lay is not None:
        return _mesh_mlp(p, x, mlp_type, lay)
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
                scale_by_sqrt_dim: bool = False, lay=None) -> torch.Tensor:
    """Rows of ``embedding`` (V, D) for ``tokens`` (B, S).  With ``lay``
    the result is the rank's residual stream."""
    if lay is None:
        emb = embedding[tokens]
    elif lay.model_dim(embedding) == 0:
        rows = lay.weight(embedding, 0)
        local = tokens - lay.tp_rank * rows.shape[0]
        ok = (local >= 0) & (local < rows.shape[0])
        emb = rows[torch.clamp(local, 0, rows.shape[0] - 1)]
        emb = lay.from_partial(torch.where(ok[..., None], emb, 0))
    else:
        emb = lay.local_weight(embedding)[
            parallel.chunk(tokens, lay.tp_group, 1) if lay.seq else tokens]
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


def _xent_chunk(h, w, targets, mask, vocab_ok, z_loss: float,
                vocab_lo: int = 0, group=None):
    logits = matmul_f32(h, w)
    logits = torch.where(vocab_ok, logits, -1e30)
    if group is None:
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, 1, targets[:, None])[:, 0]
    else:
        # vocab-parallel: the rank's slice of every row.
        m = parallel.all_reduce(logits.detach().amax(-1), group,
                                torch.distributed.ReduceOp.MAX)
        se = parallel.reduce_from(torch.exp(logits - m[:, None]).sum(-1),
                                  group)
        lse = m + torch.log(se)
        local = targets - vocab_lo
        ok = (local >= 0) & (local < logits.shape[1])
        gold = torch.gather(logits, 1, torch.clamp(
            local, 0, logits.shape[1] - 1)[:, None])[:, 0]
        gold = parallel.reduce_from(torch.where(ok, gold, 0.0), group)
    nll = lse - gold
    if z_loss:
        nll = nll + z_loss * lse ** 2
    return torch.sum(nll * mask)


def chunked_softmax_xent(h: torch.Tensor, w: torch.Tensor,
                         targets: torch.Tensor, mask: torch.Tensor, *,
                         valid_vocab: int, chunk: int = 4096,
                         z_loss: float = 1e-4, vocab_lo: int = 0,
                         group=None, count=None) -> torch.Tensor:
    """Mean masked cross-entropy (+ z-loss) without materializing the
    (tokens, V) float32 logits of the whole batch: tokens go in chunks,
    each recomputed in the backward pass (:func:`remat`), as the
    reference's are.

    h: (B, S, D) final hidden states; w: (D, V) unembedding.  The last
    chunk is shorter instead of padded (padding rows carry mask 0 in the
    reference, so the sum is the same).

    On a mesh ``w`` is the rank's vocab slice from ``vocab_lo`` when
    ``group`` (the ranks of the slices) is given, and ``count`` is the
    mask's sum over the whole batch (the divisor)."""
    d = h.shape[-1]
    hf = h.reshape(-1, d)
    tf = targets.reshape(-1).long()
    mf = mask.reshape(-1).float()
    v = w.shape[-1]
    vocab_ok = torch.arange(vocab_lo, vocab_lo + v,
                            device=h.device) < valid_vocab
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, hf.shape[0], chunk):
        total = total + remat(_xent_chunk, hf[i:i + chunk], w,
                              tf[i:i + chunk], mf[i:i + chunk], vocab_ok,
                              z_loss, vocab_lo, group)
    if count is None:
        count = torch.sum(mf)
    return total / torch.clamp(count, min=1.0)


def _mesh_mlp(p, x, mlp_type: str, lay) -> torch.Tensor:
    """The MLP of the rank's residual stream: column- then row-parallel
    where the rules split the hidden dim over ``model`` (the first weight
    along its outputs), per-token with whole weights otherwise."""
    first = p["w_in"] if mlp_type == "gelu" else p["w_gate"]
    if lay.model_dim(first) != 1:
        local = {k: lay.local_weight(p[k]) for k in mlp_shapes(
            1, 1, mlp_type)}
        return mlp_apply(local, x, mlp_type)
    h = lay.to_full(x)
    if mlp_type == "gelu":
        u = F.gelu(matmul(h, lay.weight(p["w_in"], 1))
                   + lay.weight(p["b_in"], 0), approximate="tanh")
        y = lay.from_partial(matmul(u, lay.weight(p["w_out"], 0)))
        return y + lay.local_weight(p["b_out"])
    act = F.silu if mlp_type == "swiglu" else \
        (lambda t: F.gelu(t, approximate="tanh"))
    gate = act(matmul(h, lay.weight(p["w_gate"], 1)))
    u = gate * matmul(h, lay.weight(p["w_up"], 1))
    return lay.from_partial(matmul(u, lay.weight(p["w_down"], 0)))
