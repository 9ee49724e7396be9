"""Roofline terms on the H100 and the counts behind them.

Counterpart of ``repro.roofline.analysis``.  The reference derives its
counts by walking compiled XLA HLO (``analyze_hlo``, ``blended_totals``,
``shape_bytes``/``shape_dims``); PyTorch runs eagerly and compiles no
whole-program text, so those have no counterpart here.  In their place
:func:`ph_program_cost` counts the bytes and operations of the port's
whole-image PixHomology program from the tensors each stage reads and
writes under given knobs.  :func:`roofline_terms` and the LM counts
(:func:`model_flops`, :func:`count_params`) are the reference's.

Machine description: one NVIDIA H100 SXM5 (NVIDIA H100 Tensor Core GPU
data sheet; dense rates, no sparsity, at the full 700 W power limit).
"""
from __future__ import annotations

import math

HBM_BW = 3.35e12             # bytes/s, HBM3 (data sheet)
PEAK_FLOPS = 989e12          # bf16 tensor cores, dense (data sheet)
FP32_FLOPS = 67e12           # float32 outside the tensor cores (data sheet)
LINK_BW = 450e9              # bytes/s per direction, NVLink 4 (data sheet:
                             # 900 GB/s both directions)

DTYPE_BYTES = {"uint8": 1, "int16": 2, "int32": 4, "float32": 4,
               "bfloat16": 2, "int64": 8, "float64": 8}
KEY_BYTES = 8                # packed (value, index) int64 keys


def dtype_bytes(dtype) -> int:
    """Bytes of one element of ``dtype`` (a torch or numpy dtype, or its
    name)."""
    name = str(dtype).removeprefix("torch.")
    if name not in DTYPE_BYTES:
        raise ValueError(f"no element size for dtype {dtype!r}")
    return DTYPE_BYTES[name]


def roofline_terms(flops: float, bytes_: float, coll_bytes: float) -> dict:
    """Per-card seconds for the three roofline terms + the bottleneck."""
    compute_s = flops / PEAK_FLOPS
    memory_s = bytes_ / HBM_BW
    coll_s = coll_bytes / LINK_BW
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": coll_s}
    dom = max(terms, key=terms.get)
    bound = max(compute_s, memory_s, coll_s)
    return dict(terms, bottleneck=dom,
                roofline_fraction=(compute_s / bound if bound > 0 else 0.0))


def ph_program_cost(shape, dtype, params, max_features: int,
                    max_candidates: int) -> dict:
    """Bytes and operations of the whole-image program the autotuner
    measures (fused phase A, frontier phase B, exact candidates,
    Boruvka-fused phase C over packed keys) on an ``(H, W)`` image under
    ``params`` (``strip_rows``; the other knobs leave the count as it is).

    Each stage counts the tensors it reads and writes once:

    * ``phase_a``: the kernel's ``n·(itemsize + 8)`` (the image read, ptr
      and mask written), plus ``8·n`` in the ``"global"`` width regime of
      ``strip_layout``, where a strip's 32-bit pointers live in ptr and
      the snap reads and writes them once more;
    * ``phase_b``: the frontier of ``2·⌈H/S⌉`` boundary rows, per doubling
      (``⌈log2 rows⌉ + 1``: a chain steps from strip to strip) the table,
      its row slots and the gathered entry read and the table written,
      then one follow of every pixel's pointer;
    * ``candidates`` and ``compaction``: the bitmask and the neighbours'
      labels read; the cumsum compaction of candidates and roots into
      their capacity-sized tables.  This program selects by compaction,
      so no top-k tournament runs and ``tournament_width`` has no term;
    * ``phase_c``: the best-edge bound ``8·E + 8·live + 12·nv`` a Boruvka
      round, every edge live, at ``E = 8·max_candidates`` and ``nv =
      max_features``, over ``⌈log2 nv⌉ + 1`` rounds.

    The count ranks candidates; its magnitude is not a prediction.
    """
    from repro_torch.kernels.ph_phase_a.kernel import strip_layout
    from repro_torch.kernels.ph_phase_a.ops import boundary_rows

    h, w = int(shape[-2]), int(shape[-1])
    n = h * w
    item = dtype_bytes(dtype)
    s = max(1, min(int(params.strip_rows), h))
    nv = min(int(max_features), n)
    k = min(int(max_candidates), n)
    e = 8 * k
    layout, _ = strip_layout(s, w)
    rows = len(boundary_rows(h, s))
    frontier = rows * w
    doublings = math.ceil(math.log2(max(2, rows))) + 1
    rounds = math.ceil(math.log2(max(2, nv))) + 1
    by_stage = {
        "keys": n * (item + KEY_BYTES),
        "phase_a": n * (item + 8) + (8 * n if layout == "global" else 0),
        "phase_b": frontier * 4 + doublings * frontier * 16 + n * 16,
        "candidates": n * (4 + 8 * 4 + 1),
        "compaction": 2 * n * (1 + 4 + KEY_BYTES + 4)
        + (k + nv) * (KEY_BYTES + 4),
        "phase_c": rounds * (KEY_BYTES * e + 8 * e + 12 * nv),
    }
    ops = 8 * n + 16 * n + rounds * e   # neighbour compares, label min/max,
    #                                     a compare per live edge a round
    return {"bytes": float(sum(by_stage.values())), "flops": float(ops),
            "by_stage": by_stage, "phase_a_layout": layout}


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6 N D (dense) / 6 N_active D (MoE), D = tokens."""
    n = active_params(cfg)
    if shape.kind == "decode":
        tokens = shape.global_batch          # one new token per sequence
    else:
        tokens = shape.global_batch * shape.seq_len
    mult = 6 if shape.kind == "train" else 2
    return float(mult) * n * tokens


def count_params(cfg, *, active: bool) -> float:
    d, f, l, v = cfg.d_model, cfg.d_ff, cfg.num_layers, cfg.padded_vocab
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    total = v * d * (1 if cfg.tie_embeddings else 2)
    per_layer = 0.0
    for i in range(l):
        kind = cfg.block_kind(i)
        if kind in ("attn", "lattn", "moe"):
            per_layer_attn = d * h * hd + 2 * d * kv * hd + h * hd * d
            per_layer += per_layer_attn
            if kind == "moe":
                e_frac = (cfg.top_k / cfg.num_experts) if active else 1.0
                per_layer += 3 * d * f * cfg.num_experts * e_frac
                if cfg.moe_shared_expert:
                    per_layer += 3 * d * f
            else:
                nmat = 3 if cfg.mlp_type in ("swiglu", "geglu") else 2
                per_layer += nmat * d * f
        elif kind == "rwkv":
            per_layer += 5 * d * d + 2 * d * f + d * d
        elif kind == "rec":
            r = cfg.rnn_width
            per_layer += 2 * d * r + r * d + 2 * r * r + 3 * d * f
    total += per_layer
    if cfg.is_encdec:
        per_enc = d * h * hd * 2 + 2 * d * kv * hd + 2 * d * f
        total += cfg.encoder_layers * per_enc
        total += cfg.num_layers * (d * h * hd + 2 * d * kv * hd + h * hd * d)
    return float(total)


def active_params(cfg) -> float:
    return count_params(cfg, active=True)


def total_params(cfg) -> float:
    return count_params(cfg, active=False)
