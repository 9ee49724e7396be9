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

On an LM mesh (:func:`timemix_apply` with a layout,
:func:`channelmix_mesh`; the residual stream replicated over ``model``)
the WKV splits each head's key dim K over ``model``, as ``cache_specs``
splits the ``wkv`` state (B, H, K/tp, 64): its output is a sum over k of
terms that read r_k, k_k, the decay w_k and u_k with the whole v, so
each rank runs the recurrence on its keys and state block and one sum
over ``model`` completes the output; the state never moves.  The group
norm, the gate ``g`` (``wg``'s column block) and ``wo`` (its row block)
follow the sum.  The rules' column blocks of ``wr``, ``wk``, ``wd2`` and
``w0`` are whole heads, not key blocks, so those are taken whole and the
rank keeps its key columns; ``wv`` is taken whole (every rank needs every value
channel), and so are the small mixing weights ``tm_w1``, ``tm_w2`` and
``wd1``.  ChannelMix is column-parallel in ``wk`` and ``wr`` and
row-parallel in ``wv``, its output gathered over ``model``.  The
token-shift states ``tm_x``/``cm_x`` are stored as the rank's channel
block and gathered where they are read.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed import parallel
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


def _last(x: torch.Tensor) -> torch.Tensor:
    """x's last token (B, D) in storage of its own: a state that is a view
    would keep the whole sequence's activations alive."""
    return x[:, -1, :].clone()


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
        return a.float().reshape(b, n, c, h, -1).transpose(0, 1)

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
    out = out.transpose(0, 1).reshape(b, n * c, h, v.shape[-1])
    return out[:, :t].to(r.dtype), state


def _mix(p, x, state_x):
    """The token shift's five mixes of ``x`` (r, k, v, w, g)."""
    b, t, _ = x.shape
    sx = _token_shift(x, state_x) - x
    xw = x + sx * p["maa_base"]
    lora = torch.tanh(layers.matmul(xw, p["tm_w1"]))       # (B, T, 5*32)
    lora = lora.reshape(b, t, 5, LORA_MIX).permute(2, 0, 1, 3)
    deltas = torch.einsum("sbtl,sld->sbtd", lora.float(),
                          p["tm_w2"].float()).to(x.dtype)
    mixed = x[None] + sx[None] * (p["maa"][:, None, None, :] + deltas)
    return mixed.unbind(0)


def _wkv(impl: str, r, k, v, w, u, state, chunk: int):
    if impl == "scan":
        return wkv_scan(r, k, v, w, u, state)
    if impl == "chunked":
        return wkv_chunked(r, k, v, w, u, state, chunk=chunk)
    raise ValueError(impl)


def channelmix_apply(p, x, state_x):
    sx = _token_shift(x, state_x) - x
    xk = x + sx * p["maa_k"]
    xr = x + sx * p["maa_r"]
    kk = torch.square(torch.relu(layers.matmul(xk, p["wk"])))
    kv = layers.matmul(kk, p["wv"])
    return torch.sigmoid(layers.matmul(xr, p["wr"])) * kv, _last(x)


def _key_cols(w: torch.Tensor, h: int, lo: int, n: int) -> torch.Tensor:
    """Key columns ``lo .. lo + n - 1`` of every head of ``w`` (..., H *
    64)."""
    if n == HEAD_K:
        return w
    return w.reshape(*w.shape[:-1], h, HEAD_K)[..., lo:lo + n].reshape(
        *w.shape[:-1], h * n)


def timemix_apply(p, x, state_x, state_wkv, *, lay=None,
                  wkv_impl: str = "scan", chunk: int = 32):
    """x: (B, T, D); state_x: (B, D) the previous token; state_wkv: (B, H,
    K, K).  Returns (out, x's last token, new WKV state).  With ``lay`` (a
    mesh; see the module docstring) ``x`` is the residual stream, whole on
    every rank, and the states taken and returned are the rank's blocks;
    where K does not split, the rank takes the whole weights: the
    single-device arithmetic."""
    b, t, d = x.shape
    h = d // HEAD_K
    xdim = (b, d)
    split = lay is not None and lay.cache_dim(
        "wkv", (b, h, HEAD_K, HEAD_K)) is not None
    kl = HEAD_K // lay.tp if split else HEAD_K
    lo = lay.tp_rank * kl if split else 0
    whole = (lambda w: w) if lay is None else lay.local_weight
    if lay is not None:
        state_x = lay.cache_whole(state_x, "tm_x", xdim)
    xr, xk, xv, xw_, xg = _mix(
        {n: whole(p[n]) for n in ("maa_base", "maa", "tm_w1", "tm_w2")}, x,
        state_x)
    # The rank's keys: a part of a sum over ``model`` where K splits.
    enter = lay.to_full if split else (lambda a: a)
    mine = (lambda w: lay.weight(w, None, whole=False)) if split else whole
    r = layers.matmul(enter(xr), _key_cols(mine(p["wr"]), h, lo, kl))
    k = layers.matmul(enter(xk), _key_cols(mine(p["wk"]), h, lo, kl))
    v = layers.matmul(enter(xv), mine(p["wv"]))
    dec = (_key_cols(mine(p["w0"]), h, lo, kl).float()
           + torch.tanh(layers.matmul(enter(xw_), mine(p["wd1"]))).float()
           @ _key_cols(mine(p["wd2"]), h, lo, kl).float())
    w = torch.exp(-torch.exp(dec)).reshape(b, t, h, kl)  # in (0, 1)
    # The decay is rounded to r's dtype before the WKV, as the reference
    # rounds it.  Where K splits, the output stays float32 (both WKV forms
    # compute in float32) until the ranks' parts are summed.
    rk = r.reshape(b, t, h, kl)
    out, new_wkv = _wkv(wkv_impl, rk.float() if split else rk,
                        k.reshape(b, t, h, kl), v.reshape(b, t, h, HEAD_K),
                        w.to(r.dtype), mine(p["u"])[:, lo:lo + kl],
                        state_wkv, chunk)
    if split:
        out = lay.from_partial(out)
    ln_x = {n: whole(p["ln_x"][n]) for n in ("scale", "bias")}
    out = _group_norm(ln_x, out.to(r.dtype).reshape(b, t, d), h)
    if lay is not None and lay.model_dim(p["wg"]) == 1 \
            and lay.model_dim(p["wo"]) == 0:
        g = F.silu(layers.matmul(lay.to_full(xg), lay.weight(p["wg"], 1)))
        y = parallel.split(out, lay.tp_group, -1) * g
        out = lay.from_partial(layers.matmul(y, lay.weight(p["wo"], 0)))
    else:
        g = F.silu(layers.matmul(xg, whole(p["wg"])))
        out = layers.matmul(out * g, whole(p["wo"]))
    last = _last(x)
    if lay is not None:
        last = lay.cache_block(last, "tm_x", xdim)
    return out, last, new_wkv


def channelmix_mesh(p, x, state_x, lay):
    """:func:`channelmix_apply` of the residual stream ``x`` (whole on
    every rank) on a mesh: column-parallel ``wk`` and ``wr``, row-parallel
    ``wv`` where the rules split them, whole weights otherwise.
    ``state_x`` and the state returned are the rank's blocks."""
    b, _, d = x.shape
    xdim = (b, d)
    last = lay.cache_block(_last(x), "cm_x", xdim)
    prev = lay.cache_whole(state_x, "cm_x", xdim)
    if (lay.model_dim(p["wk"]), lay.model_dim(p["wv"]),
            lay.model_dim(p["wr"])) != (1, 0, 1):
        local = {k: lay.local_weight(p[k]) for k in channelmix_shapes(1, 1)}
        return channelmix_apply(local, x, prev)[0], last
    sx = _token_shift(x, prev) - x
    xk = x + sx * lay.local_weight(p["maa_k"])
    xr = x + sx * lay.local_weight(p["maa_r"])
    kk = torch.square(torch.relu(layers.matmul(lay.to_full(xk),
                                               lay.weight(p["wk"], 1))))
    # The ranks' partial products summed, each rank keeping its channels.
    kv = parallel.reduce_scatter_grad(
        layers.matmul(kk, lay.weight(p["wv"], 0)), lay.tp_group, -1)
    gate = torch.sigmoid(layers.matmul(lay.to_full(xr),
                                       lay.weight(p["wr"], 1)))
    return parallel.gather(gate * kv, lay.tp_group, -1, reduce=False), last


def init_rwkv_state(batch: int, d: int, *, dtype, device, lay=None) -> dict:
    """Zero states; with ``lay`` this rank's block of each
    (``cache_specs``)."""
    h = d // HEAD_K
    shapes = {"tm_x": (batch, d), "cm_x": (batch, d),
              "wkv": (batch, h, HEAD_K, HEAD_K)}
    out = {}
    for name, shape in shapes.items():
        shape = list(shape)
        dim = None if lay is None else lay.cache_dim(name, shape)
        if dim is not None:
            shape[dim] //= lay.tp
        out[name] = torch.zeros(shape, dtype=torch.float32 if name == "wkv"
                                else dtype, device=device)
    return out
