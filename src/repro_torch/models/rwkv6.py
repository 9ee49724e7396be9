"""RWKV-6 "Finch" blocks (arXiv:2404.05892): data-dependent decay linear
attention (TimeMix) and squared-relu channel mixing (ChannelMix).

Counterpart of ``repro.models.rwkv6``, in torch ops (the reference has no
TPU kernel for it; it computes the recurrence in jnp).  Two WKV forms,
chosen by ``cfg.wkv_impl``:

* :func:`wkv_scan` — the per-token recurrence ``S_t = diag(w_t) S_{t-1}
  + k_t v_t^T``, a loop over tokens (one token in decode);
* :func:`wkv_chunked` — the chunk-parallel form with the reference's
  arithmetic: chunks of 32 tokens (the tail padded with ``w = 1`` and
  zeros), log-space cumulative decays masked before ``exp`` (every factor
  is ``exp`` of a non-positive number, so nothing overflows), and a
  float32 state of (B, H, 64, 64) carried from chunk to chunk.  The
  reference scans its chunks; here everything but the carried state is
  computed for all chunks at once, and a loop over chunks carries the
  state (one product and one update per chunk).

State per layer (decode): ``{"tm_x": (B, D), "cm_x": (B, D), "wkv": (B,
H, 64, 64) float32}``; head size 64.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers

HEAD_K = 64
LORA_MIX = 32
LORA_DECAY = 64


def timemix_shapes(d: int) -> dict:
    """TimeMix parameter shapes by dotted name, in the reference's tree."""
    h = d // HEAD_K
    return {"maa_base": (d,), "maa": (5, d), "tm_w1": (d, 5 * LORA_MIX),
            "tm_w2": (5, LORA_MIX, d), "w0": (d,), "wd1": (d, LORA_DECAY),
            "wd2": (LORA_DECAY, d), "u": (h, HEAD_K), "wr": (d, d),
            "wk": (d, d), "wv": (d, d), "wg": (d, d), "wo": (d, d),
            "ln_x.scale": (d,), "ln_x.bias": (d,)}


def channelmix_shapes(d: int, d_ff: int) -> dict:
    return {"maa_k": (d,), "maa_r": (d,), "wk": (d, d_ff), "wv": (d_ff, d),
            "wr": (d, d)}


# The reference's initializers draw the LoRA second factors at
# 1/sqrt(rank); w0, u, the mixes and ln_x start at zero.
INIT_SCALES = {"tm_w2": LORA_MIX ** -0.5, "wd2": LORA_DECAY ** -0.5}


def _group_norm(p, x: torch.Tensor, h: int) -> torch.Tensor:
    """Per-head groupnorm of (B, T, D) as (B, T, H, 64), the population
    variance (``jnp.var``), in float32."""
    b, t, d = x.shape
    xs = x.reshape(b, t, h, HEAD_K).float()
    mu = torch.mean(xs, dim=-1, keepdim=True)
    var = torch.var(xs, dim=-1, keepdim=True, correction=0)
    xs = ((xs - mu) * torch.rsqrt(var + 1e-5)).reshape(b, t, d)
    out = xs * (1.0 + p["scale"].float()) + p["bias"].float()
    return out.to(x.dtype)


def _token_shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """shifted[t] = x[t-1]; slot 0 takes ``prev`` (zeros at the start)."""
    return torch.cat([prev[:, None, :], x[:, :-1, :]], dim=1)


def wkv_scan(r, k, v, w, u, state):
    """The recurrence token by token.  r/k/v/w: (B, T, H, K); u: (H, K);
    state: (B, H, K, K) float32.  Returns (out (B, T, H, K) in r's dtype,
    new state)."""
    rf, kf, vf, wf = (a.float() for a in (r, k, v, w))
    uf = u.float()[None, :, :, None]
    outs = []
    for t in range(r.shape[1]):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]     # (B, H, K, K)
        outs.append(torch.einsum("bhk,bhkv->bhv", rf[:, t],
                                 state + uf * kv))
        state = wf[:, t, :, :, None] * state + kv
    return torch.stack(outs, dim=1).to(r.dtype), state


def wkv_chunked(r, k, v, w, u, state, *, chunk: int = 32):
    """Chunk-parallel WKV, the same function as :func:`wkv_scan`.  Within
    a chunk of C tokens (``cum`` the inclusive prefix sums of log w)::

      out_t = r_t·(prod_{s<t} w_s)·S_in                       (inter)
            + sum_{j<t} (r_t·prod_{j<s<t} w_s·k_j) v_j        (intra)
            + (r_t·u·k_t) v_t                                 (diag)
      S_out = (prod_all w) S_in + sum_j (prod_{s>j} w_s) k_j v_j^T
    """
    b, t, h, kk = r.shape
    c = min(chunk, t)
    pad = -t % c
    if pad:
        r, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (r, k, v))
        w = F.pad(w, (0, 0, 0, 0, 0, pad), value=1.0)
    n = (t + pad) // c

    def chunks(a):                                 # (N, B, C, H, K)
        return a.float().reshape(b, n, c, h, kk).transpose(0, 1)

    rc, kc, vc, wc = (chunks(a) for a in (r, k, v, w))
    uf = u.float()
    logw = torch.log(torch.clamp(wc, 1e-30, 1.0))
    cum = torch.cumsum(logw, dim=2)
    ce = cum - logw                                # log prod_{s<t} w_s
    we = torch.exp(ce)
    wt = torch.exp(cum[:, :, -1:] - cum)           # prod_{s>t} w_s
    w_all = torch.exp(cum[:, :, -1])               # (N, B, H, K)
    # Intra-chunk: pairwise decays in log space, masked before exp.
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=r.device),
                     -1)
    delta = ce[:, :, :, None] - cum[:, :, None, :]  # (N, B, i, j, H, K)
    delta = torch.where(tri[:, :, None, None], delta, float("-inf"))
    scores = (rc[:, :, :, None] * torch.exp(delta) * kc[:, :, None]).sum(-1)
    intra = torch.einsum("nbijh,nbjhv->nbihv", scores, vc)
    diag = (rc * (uf * kc)).sum(-1, keepdim=True) * vc
    rwe = rc * we
    kv = torch.einsum("nbchk,nbchv->nbhkv", kc * wt, vc)
    inter = []
    for j in range(n):
        inter.append(torch.einsum("bchk,bhkv->bchv", rwe[j], state))
        state = w_all[j][..., None] * state + kv[j]
    out = torch.stack(inter) + intra + diag
    out = out.transpose(0, 1).reshape(b, n * c, h, kk)
    return out[:, :t].to(r.dtype), state


def timemix_apply(p, x, state_x, state_wkv, *, wkv_impl: str = "scan",
                  chunk: int = 32):
    """x: (B, T, D); state_x: (B, D) the previous token; state_wkv: (B, H,
    K, K).  Returns (out, x's last token, new WKV state)."""
    b, t, d = x.shape
    h = d // HEAD_K
    sx = _token_shift(x, state_x) - x

    xw = x + sx * p["maa_base"]
    lora = torch.tanh(layers.matmul(xw, p["tm_w1"]))       # (B, T, 5*32)
    lora = lora.reshape(b, t, 5, LORA_MIX).permute(2, 0, 1, 3)
    deltas = torch.einsum("sbtl,sld->sbtd", lora.float(),
                          p["tm_w2"].float()).to(x.dtype)
    mixed = x[None] + sx[None] * (p["maa"][:, None, None, :] + deltas)
    xr, xk, xv, xw_, xg = mixed.unbind(0)

    r = layers.matmul(xr, p["wr"]).reshape(b, t, h, HEAD_K)
    k = layers.matmul(xk, p["wk"]).reshape(b, t, h, HEAD_K)
    v = layers.matmul(xv, p["wv"]).reshape(b, t, h, HEAD_K)
    g = F.silu(layers.matmul(xg, p["wg"]))

    dec = (p["w0"].float()
           + torch.tanh(layers.matmul(xw_, p["wd1"])).float()
           @ p["wd2"].float())
    w = torch.exp(-torch.exp(dec)).reshape(b, t, h, HEAD_K)  # in (0, 1)
    # The decay is rounded to r's dtype before the WKV, as the reference
    # rounds it.
    if wkv_impl == "scan":
        out, new_wkv = wkv_scan(r, k, v, w.to(r.dtype), p["u"], state_wkv)
    elif wkv_impl == "chunked":
        out, new_wkv = wkv_chunked(r, k, v, w.to(r.dtype), p["u"],
                                   state_wkv, chunk=chunk)
    else:
        raise ValueError(wkv_impl)

    out = _group_norm(p["ln_x"], out.reshape(b, t, d), h)
    out = layers.matmul(out * g, p["wo"])
    return out, x[:, -1, :], new_wkv


def channelmix_apply(p, x, state_x):
    sx = _token_shift(x, state_x) - x
    xk = x + sx * p["maa_k"]
    xr = x + sx * p["maa_r"]
    kk = torch.square(torch.relu(layers.matmul(xk, p["wk"])))
    kv = layers.matmul(kk, p["wv"])
    return torch.sigmoid(layers.matmul(xr, p["wr"])) * kv, x[:, -1, :]


def init_rwkv_state(batch: int, d: int, *, dtype, device) -> dict:
    h = d // HEAD_K
    return {"tm_x": torch.zeros((batch, d), dtype=dtype, device=device),
            "cm_x": torch.zeros((batch, d), dtype=dtype, device=device),
            "wkv": torch.zeros((batch, h, HEAD_K, HEAD_K),
                               dtype=torch.float32, device=device)}
