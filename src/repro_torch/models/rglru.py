"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

Counterpart of ``repro.models.rglru``, in torch ops (the reference has no
TPU kernel for it).  Block: x -> [W_in -> causal conv1d (width 4) ->
RG-LRU] * gelu(W_gate x) -> W_out, with the diagonal gated recurrence

    r_t = sigmoid(x_t W_a + b_a),  i_t = sigmoid(x_t W_x + b_x)
    log a_t = -c * softplus(lam) * r_t            (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

evaluated for a sequence by a log-depth (Hillis-Steele) scan with the
reference's ``combine`` (ceil(log2 T) steps; XLA's associative scan sums
in another order, so the two agree to float32 rounding, not bitwise), and
by one step in decode.

Decode state per layer: ``{"conv": (B, W-1, R), "h": (B, R) float32}``.

On an LM mesh (:func:`recurrent_block_apply` with a layout, the stream
replicated over ``model``) the rank holds a block of the R channels, as
the sharding rules split ``w_in``, ``w_gate``, ``conv_w``, ``wa``, ``wx``
(columns), ``w_out`` (rows) and the ``conv``/``h`` states: the conv, the
gates' biases, ``lam``, the scan and the decode step run on the rank's
channels; the gates read every channel, so the conv's output is
all-gathered before ``wa``/``wx`` (their column blocks); ``w_out`` sums
the ranks' products.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed import parallel
from repro_torch.models import layers

RGLRU_C = 8.0


def recurrent_shapes(d_model: int, rnn_width: int, conv_width: int) -> dict:
    """Parameter shapes by name, in the reference's tree.  ``lam`` is
    float32 in every config."""
    r = rnn_width
    return {"w_in": (d_model, r), "w_gate": (d_model, r),
            "w_out": (r, d_model), "conv_w": (conv_width, r),
            "conv_b": (r,), "wa": (r, r), "ba": (r,), "wx": (r, r),
            "bx": (r,), "lam": (r,)}


def init_lam(rnn_width: int, *, generator: torch.Generator,
             device) -> torch.Tensor:
    """The reference's Lambda init in float32: u ~ U(0.9, 0.999),
    lam = -log(u^(-1/c) - 1)."""
    u = torch.empty(rnn_width, dtype=torch.float32, device=device)
    u.uniform_(0.9, 0.999, generator=generator)
    return torch.log(u ** (-1.0 / RGLRU_C) - 1.0) * -1.0


def _causal_conv1d(p, x: torch.Tensor, state: torch.Tensor):
    """y_t = sum_w x_{t-W+1+w} * conv_w[w] + conv_b, summed in the order of
    w.  x: (B, T, R); state: (B, W-1, R), the previous inputs (zeros at
    the start).  Returns (y, new state)."""
    wlen = p["conv_w"].shape[0]
    full = torch.cat([state.to(x.dtype), x], dim=1)          # (B, T+W-1, R)
    t = x.shape[1]
    y = torch.zeros_like(x)
    for i in range(wlen):
        y = y + full[:, i:i + t, :] * p["conv_w"][i]
    y = y + p["conv_b"]
    # the state in storage of its own, not a view keeping ``full`` alive
    new_state = full[:, -(wlen - 1):, :].clone() if wlen > 1 else state
    return y, new_state


def _gated(p, xf: torch.Tensor, gates_in: torch.Tensor | None = None):
    """(a, sqrt(clip(1 - a^2, 1e-12)) * (i * x)) in float32 for float32
    x, in the reference's order of operations.  The gates read
    ``gates_in`` (float32; on a mesh every channel of which ``xf`` is
    the rank's block), by default ``xf``."""
    g = xf if gates_in is None else gates_in
    r = torch.sigmoid(layers.matmul(g, p["wa"].float()) + p["ba"].float())
    i = torch.sigmoid(layers.matmul(g, p["wx"].float()) + p["bx"].float())
    lam = p["lam"].float()
    softplus = torch.logaddexp(lam, torch.zeros_like(lam))   # jax's softplus
    a = torch.exp(-RGLRU_C * softplus * r)
    return a, torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * xf)


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t along dim 1 from h_{-1} = 0: an inclusive
    Hillis-Steele scan of the reference's ``combine((a1, b1), (a2, b2)) =
    (a1 a2, a2 b1 + b2)``, ceil(log2 T) steps."""
    d = 1
    while d < a.shape[1]:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    return b


def rglru(p, x: torch.Tensor, h0: torch.Tensor, gates_in=None):
    """x: (B, T, R); h0: (B, R) float32.  Returns (h in x's dtype, the
    last h in float32).  ``gates_in``: as :func:`_gated`'s."""
    xf = x.float()
    a, b = _gated(p, xf, None if gates_in is None else gates_in.float())
    b[:, 0] += a[:, 0] * h0                     # fold h0 into b_0
    h = linear_scan(a, b)
    return h.to(x.dtype), h[:, -1, :].clone()


def rglru_step(p, x: torch.Tensor, h0: torch.Tensor, gates_in=None):
    """One decode step. x: (B, 1, R); h0: (B, R) float32."""
    xf = x[:, 0, :].float()
    a, gated = _gated(p, xf, None if gates_in is None
                      else gates_in[:, 0, :].float())
    h = a * h0 + gated
    return h.to(x.dtype)[:, None, :], h


def recurrent_block_apply(p, x: torch.Tensor, state: dict, *,
                          decode: bool = False, lay=None):
    """x: (B, T, D) -> (B, T, D); ``state`` {"conv", "h"} -> the new one.
    With ``lay`` (a mesh; see the module docstring) ``x`` is the residual
    stream, whole on every rank, and the states taken and returned are
    the rank's blocks; where the rules do not split the channels, the
    rank takes the whole weights: the single-device arithmetic."""
    split = lay is not None and lay.model_dim(p["w_in"]) == 1
    gates_in = None
    if split:
        x = lay.to_full(x)
        p = dict({k: lay.weight(p[k], 1) for k in ("w_in", "w_gate",
                                                   "conv_w", "wa", "wx")},
                 **{k: lay.weight(p[k], 0) for k in ("conv_b", "ba", "bx",
                                                      "lam", "w_out")})
    elif lay is not None:
        p = {k: lay.local_weight(p[k]) for k in recurrent_shapes(1, 1, 1)}
    gate = F.gelu(layers.matmul(x, p["w_gate"]), approximate="tanh")
    xin = layers.matmul(x, p["w_in"])
    conv, conv_state = _causal_conv1d(p, xin, state["conv"])
    if split:
        gates_in = parallel.gather(conv, lay.tp_group, -1, reduce=True)
    step = rglru_step if decode else rglru
    y, h = step(p, conv, state["h"], gates_in)
    out = layers.matmul(y * gate, p["w_out"])
    if split:
        out = lay.from_partial(out)
    return out, {"conv": conv_state, "h": h}


def init_recurrent_state(batch: int, rnn_width: int, conv_width: int, *,
                         dtype, device, lay=None) -> dict:
    """Zero states; with ``lay`` this rank's blocks of the channels
    (``cache_specs``)."""
    r = rnn_width
    if lay is not None and lay.cache_dim("h", (batch, r)) is not None:
        r //= lay.tp
    return {"conv": torch.zeros((batch, conv_width - 1, r),
                                dtype=dtype, device=device),
            "h": torch.zeros((batch, r), dtype=torch.float32,
                             device=device)}
