#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (PixHomology and the LM) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout; one CUDA card

Phases, each printing one JSON line (any failure raises, exit code != 0):

1. device  — card name and power limit (nvidia-smi), torch and CUDA versions;
2. build   — the five CUDA kernels built from
             ``src/repro_torch/kernels/*/csrc`` with one ``nvcc`` per source,
             started together; ptxas's registers, shared memory and spills
             for each kernel of the flash, maxpool, distance and best-edge
             libraries;
3. phase_a — the phase-A kernel against its plain version, bitwise, over the
             five dtypes, strip heights 1/8/16, ragged strips, a ramp, a
             constant image, a wide image and the 4096² astro frame; timed
             at 4096² float32;
4. maxpool — the 3x3 pooling kernel (max+argmax, max, min) against its plain
             version, bitwise (zeros' signs too), over the five dtypes at
             1x1, 1x29, 29x1 and 37x53 (noise, heavy ties, borders equal to
             the pad fill: uint8 zeros, int32 minimum), at the tile edges
             4095x4097, 33x129, 1x4097, 33x(4096 + one vector) and batches
             (3x33x129, 3x33x128, 2x40x4096), on views whose base is not
             16-byte aligned, on signed zeros, and at 4096² (the
             float32 frame, int32 ties); timed at 4096² float32 in turns
             with ``max_pool2d``;
5. main    — ``PHEngine(PHConfig(merge_impl="boruvka", phase_c_impl="fused",
             filter_level="filter_std")).run`` on the 4096² frame with the
             device left at its default: regrow, Boruvka rounds, steady-state
             wall time, per-stage device times, kernel launch counts (both
             must be > 0), and bitwise equality with the plain-version run;
6. best_edge — the best-edge kernel against its plain version, bitwise, on
             int32/int64 tie storms, all-dead edges, the full capacities of
             the 4096² run, around its 16-byte vectors (E of 1 to 33,
             ``key[1:]`` views, all-live and all-dead instances, keys at
             ``iinfo.min + 1``), and the main path's own first-round
             instance; timed on that instance in turns with
             ``scatter_reduce_`` (one call's time and device time);
7. paper   — the paper's Algorithm 1 (``phase_a_impl="pooled"``,
             ``candidate_mode="paper"``, Boruvka-fused, ``filter_std``)
             through ``run`` on the same frame: maxpool and best-edge
             launches > 0, bitwise equal to the plain-version run; pooled
             phase A with exact candidates equals the main diagram bitwise;
8. batch   — ``run_batch`` of four 2048² frames equals four single runs;
9. mixed_batch — ``run_batch`` of a survey batch of mixed shapes (2048²,
             2048x1536, 1536², 1024x2048, 1000x1800 and a duplicate) padded
             into one 2048² bucket: every row equals ``run`` on its frame,
             the duplicate equals its twin;
10. distance — ``distance_matrix`` over the rows of the mixed batch
             (``n_dirs=16``): distance-kernel launches > 0, the kernel
             against its plain version (bn bitwise, sw at rtol 1e-5),
             exact symmetry and zero diagonal, there and at F of 1, 4095,
             4097, 65,536 and 131,072 (the path for rows wider than one
             cluster) with B of 1, 2 and 17 (pad-heavy rows, ties, signed
             zeros); timed against its bound (one call's time, device
             time, and its sort and merge stages' device time);
11. oracle — at 256² (an astro frame, random uint8, random bfloat16) the port
             on the card equals the numpy union-find oracle for the scan,
             Boruvka-xla and Boruvka-fused merges;
12. flash_attention — the flash attention kernel against its plain version
             (``FLASH_CASES``: GQA, MQA, MHA, windows, non-causal, ragged
             Sq != Skv, rows that see no key, hd 64/128/256, the edges of
             the kernel's tiles) in float32 and bfloat16 at ``FLASH_TOL``,
             then at the main path's shapes (``FLASH_MAIN_SHAPES``, strided
             views as the model passes them); the counts of wgmma and TMA
             instructions in its SASS (cuobjdump); timed at the LM
             prefill's shape beside its bound, in turns with
             ``scaled_dot_product_attention``;
13. lm_serve — ``serve`` of mistral_nemo_12b at full width and depth (random
             weights drawn on the card from seed 0): 4 prompts of 1024
             tokens, 32 greedy tokens; one flash launch per layer; the
             last layer's flash call of a prefill against the plain
             version at ``FLASH_TOL``; the prefill's logits against a run
             through the plain attention, and teacher-forced
             ``decode_step`` logits against one full-sequence forward, at
             ``LOGIT_ATOL``/``LOGIT_RTOL``, which a control (one KV tile
             hidden) must fail; one prefill and one decode step under
             ``torch.profiler`` (device busy ms by kind, idle share);
14. lm_forward — ``Model.loss_fn`` forward at 2 x 2048 tokens: 40 flash
             launches, the loss equal to the plain-attention run's within
             ``LOSS_ATOL``, which the hidden-tile control must miss.

Every kernel is timed two ways: ``ms`` is one call's CUDA-event time
(``cuda_ms``: the host's launch overhead falls inside the interval when it
is longer than the kernel), ``device_ms`` the card's own time
(``device_ms``: calls queued behind a device-side sleep); ``bound_share``
is the bound over ``device_ms``.  Then it prints the kernel table as one
JSON line (both times for all five kernels, and for their library calls),
the nvidia-smi line, and last ``{"ok": true, "device": {...}}``.  Without a CUDA device, or outside a
checkout, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate (data sheet)
FP32_OPS_PER_S = 67e12           # H100 SXM float32 outside the tensor cores
MAIN_SIZE = 4096
BATCH_SIZE = 2048
ORACLE_SIZE = 256
# The survey batch of the mixed_batch phase: (h, w) windows of 2048² frames.
MIXED_SHAPES = ((2048, 2048), (2048, 1536), (1536, 1536), (1024, 2048),
                (1000, 1800))
N_DIRS = 16
# The main path's engine configuration (phases 5-10).
MAIN_CONFIG = dict(merge_impl="boruvka", phase_c_impl="fused",
                   filter_level="filter_std")
BF16_OPS_PER_S = 989e12          # H100 SXM bfloat16 tensor cores, dense
# flash_attention cases (B, H, KV, Sq, Skv, hd, causal, window): the six of
# tests/test_kernels_flash_attention.py, then the LM's GQA 32/8 at hd 128
# with a ragged length, hd 256, a window over a ragged length, a ragged
# Sq != Skv, and rows that see no key; then the edges of the bfloat16
# kernel's tiles (128 query rows; 128 keys, 64 at hd 256): the 1032-token
# teacher-forced length, Skv of 129 and 191, Sq one row into a query tile,
# window edges inside a key tile, hd 64 and 256 at a 128-row tile.
FLASH_CASES = ((1, 1, 1, 128, 128, 64, True, None),
               (2, 4, 2, 128, 128, 64, True, None),
               (1, 8, 1, 256, 256, 128, True, None),
               (2, 4, 4, 128, 128, 128, False, None),
               (1, 2, 2, 256, 256, 64, True, 128),
               (1, 4, 2, 128, 256, 64, False, None),
               (2, 32, 8, 200, 200, 128, True, None),
               (2, 4, 4, 130, 130, 256, False, None),
               (1, 8, 2, 300, 300, 256, True, 100),
               (1, 4, 2, 70, 150, 128, False, None),
               (1, 2, 2, 8, 4, 64, True, 2),
               (1, 32, 8, 1032, 1032, 128, True, None),
               (1, 4, 2, 100, 129, 128, False, None),
               (1, 4, 2, 191, 191, 128, True, None),
               (1, 4, 2, 129, 129, 128, True, None),
               (1, 4, 2, 257, 300, 128, False, None),
               (1, 4, 2, 300, 300, 128, True, 70),
               (1, 4, 2, 256, 256, 64, True, 100),
               (1, 4, 1, 129, 129, 64, True, None),
               (1, 4, 1, 129, 129, 256, True, None),
               (1, 4, 2, 256, 256, 256, True, 70))
# The working type's tolerance (atol = rtol), as the reference's kernel
# test states it; float32 compares without TF32.
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# The main path's own shapes (B, H, KV, S, hd), causal bfloat16, held to the
# plain version element by element: lm_serve's prefill (the timed shape)
# and lm_forward's.  q, k, v are (B, H, S, hd) views of (B, S, H, hd)
# tensors, as the model passes them.
FLASH_SHAPE = (4, 32, 8, 1024, 128)
FLASH_MAIN_SHAPES = (FLASH_SHAPE, (2, 32, 8, 2048, 128))
LM_ARCH = "mistral_nemo_12b"
LM_SERVE = dict(batch=4, prompt_len=1024, gen_len=32, max_len=2048)
LM_FORWARD = dict(batch=2, seq=2048)
TEACHER_STEPS = 8
# bfloat16 logits of the full-width model, two attention routes on the same
# weights: |a - b| <= LOGIT_ATOL + LOGIT_RTOL * |b|.  The routes round
# attention's output at other points; 40 bfloat16 layers carry that on.
# Each limit lies between the kernel's reading and that of a control: the
# plain version with one KV tile (CONTROL_KEYS) hidden from every query,
# which must fail it (PERF.md gives both readings).
LOGIT_ATOL, LOGIT_RTOL = 0.25, 0.05
LOSS_ATOL = 5e-4                 # mean cross-entropy over 4096 tokens
CONTROL_KEYS = slice(320, 384)   # the sixth 64-key tile
# The design of each redesigned kernel (PR 14: maxpool, flash; PR 15:
# distance, best-edge).
DESIGN = {"maxpool3x3": "tiled separable 3x3, 16-byte vectors",
          "flash_attention": "warp-specialised wgmma + TMA pipeline",
          "ph_distance": "cluster radix sort in distributed shared memory, "
                         "then a tiled merge path from shared memory",
          "ph_phase_c_best_edge": "one 16-byte-vector read of the keys, "
                                  "a compact live list for the win pass"}


def survey_frames() -> list:
    """The mixed_batch phase's survey batch: windows of 2048² frames of
    ``MIXED_SHAPES``, then an exact duplicate of the third."""
    from repro_torch.data import astro
    survey = [astro.generate_window(i, 0, 0, h, w, size=BATCH_SIZE)
              for i, (h, w) in enumerate(MIXED_SHAPES, start=10)]
    survey.append(survey[2].copy())
    return survey


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, reps: int = 10) -> float:
    """Median device time of ``fn`` over ``reps`` runs (CUDA events)."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int = 20) -> float:
    """Device time of one call of ``fn``: ``reps`` calls queued behind a
    device-side sleep, so that the card runs them back to back and the
    host's launch overhead (tens of microseconds a call through the ctypes
    wrappers: compare ``cuda_ms``) stays out of the interval; CUDA events
    around the calls, divided by ``reps``."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)       # ~50 ms: longer than the enqueue
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_diff(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() \
        else 0.0


def in_turns(kernel_fn, library_fn) -> dict:
    """A kernel and its library call timed in turns (kernel, library,
    library, kernel), so that both see the same card state: first one
    call's time (``cuda_ms``), then device time (``device_ms``).  ``ms``,
    ``library_ms``, ``device_ms`` and ``library_device_ms`` are the means
    of each pair; ``turns_ms`` and ``turns_device_ms`` hold the four."""
    out = {}
    for timer, key in ((cuda_ms, "ms"), (device_ms, "device_ms")):
        k1, l1, l2, k2 = (timer(fn) for fn in (kernel_fn, library_fn,
                                               library_fn, kernel_fn))
        out[f"turns_{key}"] = {"kernel": [k1, k2], "library": [l1, l2]}
        out[key], out[f"library_{key}"] = (k1 + k2) / 2, (l1 + l2) / 2
    return out


def ptxas_report(lib) -> dict | None:
    """Registers, shared memory and spills of each kernel of a library,
    from its build's ``-Xptxas -v`` report (None for a cached build)."""
    import re
    if lib.ptxas_log is None:
        return None
    out, name = {}, None
    for line in lib.ptxas_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[name].update(stack=int(m.group(1)),
                             spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            out[name]["static_smem"] = int(smem.group(1)) if smem else 0
    return out


def sass_counts(lib) -> dict:
    """Counts of Hopper's wgmma (HGMMA) and TMA load/store (UTMALDG,
    UTMASTG) instructions in a built library's SASS, or None with the
    reason where the toolkit has no cuobjdump."""
    import re
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return {"HGMMA": None, "UTMALDG": None, "UTMASTG": None,
                "why": "no cuobjdump in the CUDA toolkit here"}
    sass = subprocess.run([tool, "-sass", str(lib.library_path())],
                          capture_output=True, text=True, check=True).stdout
    return {op: len(re.findall(rf"\b{op}\b", sass))
            for op in ("HGMMA", "UTMALDG", "UTMASTG")}


def best_edge_cases(dev, rng, err) -> int:
    """The best-edge kernel against its plain version, bitwise, around its
    16-byte vectors: E from 1 to 33, views whose base is not 16-byte
    aligned (``key[1:]``), all-dead, all-live and tie-storm instances and
    keys at ``iinfo.min + 1``, in int32 and int64.  Returns the count."""
    import numpy as np
    import torch

    from repro_torch.kernels.ph_phase_c import kernel as kc
    from repro_torch.kernels.ph_phase_c import ref as rc

    def check(key, ra_, rb_, nv, label):
        b_k, w_k = kc.best_edge_reduce(key, ra_, rb_, nv)
        b_r, w_r = rc.best_edge_reduce(key, ra_, rb_, nv)
        err["ph_phase_c"] = max(err["ph_phase_c"], max_abs_diff(b_k, b_r),
                                max_abs_diff(w_k, w_r))
        if not (torch.equal(b_k, b_r) and torch.equal(w_k, w_r)):
            raise AssertionError(f"best_edge kernel != plain on {label}")

    def instance(e, nv, dtype, dead, keys):
        lo = torch.iinfo(dtype).min
        key = torch.from_numpy(rng.choice(np.asarray(keys, np.int64), e))
        key = torch.where(torch.from_numpy(rng.random(e) < dead), lo, key)
        ends = [torch.from_numpy(rng.integers(0, nv, size=e)
                                 .astype(np.int32)) for _ in range(2)]
        return key.to(dtype).to(dev), ends[0].to(dev), ends[1].to(dev)

    n = 0
    for dtype in (torch.int32, torch.int64):
        lo = torch.iinfo(dtype).min
        storm = (lo + 1, lo + 2, -1, 0, 3)
        wide = tuple(range(-50, 50))
        for e in range(1, 34):
            for dead, keys in ((0.3, storm), (0.0, storm), (1.0, wide),
                               (0.5, wide)):
                nv = 1 + e % 5
                # One lane more, then the view from lane 1: its base is
                # 4 or 8 bytes past a 16-byte boundary.
                key, ra_, rb_ = instance(e + 1, nv, dtype, dead, keys)
                check(key[:e], ra_[:e], rb_[:e], nv, f"{dtype} E={e} "
                      f"dead={dead}")
                check(key[1:], ra_[1:], rb_[1:], nv, f"{dtype} E={e} "
                      f"dead={dead} view key[1:]")
                n += 2
        for e, nv, dead, keys in ((4099, 7, 0.0, (lo + 1,)),
                                  (100_001, 300, 0.0, storm),
                                  (100_001, 300, 1.0, storm),
                                  (1 << 20, 4096, 0.98, wide)):
            key, ra_, rb_ = instance(e, nv, dtype, dead, keys)
            check(key, ra_, rb_, nv, f"{dtype} E={e} dead={dead}")
            check(key[1:], ra_[1:], rb_[1:], nv,
                  f"{dtype} E={e} dead={dead} view key[1:]")
            n += 2
    return n


def distance_cases(dev, rng, err) -> int:
    """The distance kernel against its plain version (bn bitwise, sw at
    rtol 1e-5, exact symmetry, zero diagonal, a twin row at exactly 0)
    at F of 1, 4095, 4097, 65,536 and 131,072 (wider than one cluster:
    the wide path) and B of 1, 2 and 17.  Rows take turns among Gaussian
    values, pad-heavy rows (90 % zeros, as capacity pads project), heavy
    ties and signed zeros.  Returns the count."""
    import numpy as np
    import torch

    from repro_torch.kernels.ph_distance import kernel as kd
    from repro_torch.kernels.ph_distance import ref as rd

    def table(b, k, f):
        x = rng.normal(size=(b, k, f)) * 50
        mode = (np.arange(b)[:, None] + np.arange(k)[None, :]) % 4
        pads = rng.random((b, k, f)) < 0.9
        x = np.where((mode[..., None] == 1) & pads, 0.0, x)
        x = np.where(mode[..., None] == 2, np.round(x / 40), x)
        zeros = rng.choice([0.0, -0.0, 1.5, -1.5], size=(b, k, f))
        x = np.where(mode[..., None] == 3, zeros, x)
        return torch.from_numpy(x.astype(np.float32)).to(dev)

    n = 0
    for f in (1, 4095, 4097, 65536, 131072):
        for b in (1, 2, 17):
            k = 16 if b * f <= 1 << 18 else 2
            pts, diag = table(b, k, f), table(b, k, f)
            prof = table(b, 1, f)[:, 0].abs().sort(dim=1, descending=True
                                                   ).values.contiguous()
            if b > 1:                      # a twin row: exactly 0 apart
                pts[-1], diag[-1], prof[-1] = pts[0], diag[0], prof[0]
            ksw, kbn = kd.distance_matrix(pts, diag, prof)
            rsw, rbn = rd.distance_matrix(pts, diag, prof)
            label = f"B={b} K={k} F={f}"
            err["ph_distance"] = max(err["ph_distance"],
                                     max_abs_diff(ksw, rsw),
                                     max_abs_diff(kbn, rbn))
            if not torch.equal(kbn, rbn):
                raise AssertionError(f"distance bn != plain on {label}")
            if not torch.allclose(ksw, rsw, rtol=1e-5, atol=0.0):
                raise AssertionError(f"distance sw != plain within rtol "
                                     f"1e-5 on {label}")
            if not (torch.equal(ksw, ksw.T) and torch.equal(kbn, kbn.T)
                    and not ksw.diagonal().any()
                    and not kbn.diagonal().any()):
                raise AssertionError(f"distance not exactly symmetric with "
                                     f"a zero diagonal on {label}")
            if b > 1 and (ksw[0, b - 1] != 0 or kbn[0, b - 1] != 0):
                raise AssertionError(f"twin rows apart on {label}")
            n += 1
    return n


def phase_flash_attention(dev, rng, err) -> dict:
    """The flash kernel against its plain version on every case, in both
    types; timed at the LM prefill's shape beside its bound and SDPA."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as kfa
    from repro_torch.kernels.flash_attention import ref as rfa

    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    errs = {}
    for name, dt in dtypes.items():
        tol, errs[name] = FLASH_TOL[name], 0.0
        for case in FLASH_CASES:
            b, h, kv, sq, skv, hd, causal, window = case
            q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(
                "float32")).to(dt).to(dev) for shape in
                ((b, h, sq, hd), (b, kv, skv, hd), (b, kv, skv, hd)))
            got = kfa.flash_attention_fwd(q, k, v, causal=causal,
                                          window=window)
            want = rfa.attention(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            errs[name] = max(errs[name], max_abs_diff(got, want))
            if got.shape != want.shape or not torch.allclose(
                    got.float(), want.float(), atol=tol, rtol=tol):
                raise AssertionError(
                    f"flash kernel != plain ({name}, {case}): max |diff| "
                    f"{max_abs_diff(got, want)} over tolerance {tol}")

    def views(b, h, kv, s, hd):
        return (torch.randn(b, s, n, hd, device=dev,
                            dtype=torch.bfloat16).transpose(1, 2)
                for n in (h, kv, kv))

    tol, main_errs = FLASH_TOL["bfloat16"], []
    for shape in FLASH_MAIN_SHAPES:
        q, k, v = views(*shape)
        got = kfa.flash_attention_fwd(q, k, v, causal=True)
        want = rfa.attention(q, k, v, causal=True)
        main_errs.append(max_abs_diff(got, want))
        if not torch.allclose(got.float(), want.float(), atol=tol, rtol=tol):
            raise AssertionError(f"flash kernel != plain at the main path's "
                                 f"shape {shape}: max |diff| {main_errs[-1]} "
                                 f"over tolerance {tol}")
        del got, want
    errs["bfloat16"] = max(errs["bfloat16"], *main_errs)
    err["flash_attention"] = max(errs.values())

    b, h, kv, s, hd = FLASH_SHAPE
    q, k, v = views(*FLASH_SHAPE)
    plain_ms = cuda_ms(lambda: rfa.attention(q, k, v, causal=True), reps=3)
    k_rep = k.repeat_interleave(h // kv, dim=1)     # SDPA wants H heads
    v_rep = v.repeat_interleave(h // kv, dim=1)
    timed = in_turns(
        lambda: kfa.flash_attention_fwd(q, k, v, causal=True),
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k_rep, v_rep, is_causal=True))
    ms, lib_ms = timed["ms"], timed["library_ms"]
    sass = sass_counts(kfa.LIBRARY)
    if sass["HGMMA"] == 0 or sass["UTMALDG"] == 0:
        raise AssertionError(f"the flash library has no wgmma or TMA load "
                             f"in its SASS: {sass}")
    # Operations the causal mask leaves (two products over the visible
    # (q, k) pairs), bytes of q, k, v read once and o written once.
    pairs = s * (s + 1) // 2
    ops = 4 * b * h * hd * pairs
    nbytes = (2 * b * h * s * hd + 2 * b * kv * s * hd) * 2
    bound_ms = max(ops / BF16_OPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
    bound_by = "operations" if ops / BF16_OPS_PER_S >= \
        nbytes / HBM_BYTES_PER_S else "bytes"
    emit("flash_attention", cases=len(FLASH_CASES) * len(dtypes),
         tolerance=FLASH_TOL, max_abs_err=errs,
         main_shapes=[list(t) for t in FLASH_MAIN_SHAPES],
         main_shape_max_abs_err=main_errs, timed_shape=list(
             FLASH_SHAPE), timed_dtype="bfloat16", causal=True,
         kernel_ms=ms, device_ms=timed["device_ms"], plain_ms=plain_ms,
         library_ms_sdpa=lib_ms,
         library_device_ms=timed["library_device_ms"],
         turns_ms=timed["turns_ms"], turns_device_ms=timed["turns_device_ms"],
         flop=ops, bytes=nbytes, bound_ms=bound_ms, bound_by=bound_by,
         bound_share=bound_ms / timed["device_ms"], sass=sass)
    return {"ms": ms, "device_ms": timed["device_ms"], "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
            "library_device_ms": timed["library_device_ms"], "sass": sass}


def device_profile(fn) -> dict:
    """One run of ``fn`` under ``torch.profiler``: its host wall ms (with
    the profiler's own cost), the device time of its kernels and copies
    summed (one stream, so they do not overlap), the idle share that
    leaves, device ms by kind and the five longest kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict = {}
    launches = 0
    for event in prof.events():
        if event.device_type == DeviceType.CUDA:
            launches += 1
            by_name[event.name] = by_name.get(event.name, 0.0) \
                + event.time_range.elapsed_us() / 1e3
    if not by_name:                     # the profiler saw no device work
        return {"wall_ms": wall_ms, "device_busy_ms": None}
    # "copy": dtype casts and copies (the float32 widening of the head and
    # of the KV cache among them).
    kinds = {"flash_attention": 0.0, "gemm": 0.0, "copy": 0.0, "other": 0.0}
    for name, ms in by_name.items():
        low = name.lower()
        if "flash_fwd" in low:
            kinds["flash_attention"] += ms
        elif any(w in low for w in ("gemm", "xmma", "nvjet", "cutlass")):
            kinds["gemm"] += ms
        elif "copy" in low:
            kinds["copy"] += ms
        else:
            kinds["other"] += ms
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / wall_ms, "device_events": launches,
            "device_ms_by_kind": kinds,
            "top_kernels": [[name[:80], ms] for name, ms in top]}


def hidden_tile_attention(q, k, v, *, causal=True, window=None):
    """The plain version with keys ``CONTROL_KEYS`` hidden from every
    query: a deliberately wrong attention (a kernel that loses one KV
    tile), run as the LM phases' control."""
    import torch
    from repro_torch.kernels.flash_attention import ref as rfa
    b, h, sq, hd = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    q5 = q.reshape(b, kvh, h // kvh, sq, hd)
    s = torch.einsum("bngqd,bnkd->bngqk", q5.float(), k.float()) * hd ** -0.5
    visible = rfa.mask(sq, skv, causal=causal, window=window, device=q.device)
    visible[:, CONTROL_KEYS] = False
    p = torch.softmax(s.masked_fill(~visible, float("-inf")), dim=-1)
    out = torch.einsum("bngqk,bnkd->bngqd", p.to(v.dtype).float(), v.float())
    return out.reshape(b, h, sq, hd).to(q.dtype)


class plain_attention_replaced:
    """Within the block, the model's plain attention route
    (``plain=True``) runs ``fn`` instead of ``ref.attention``."""

    def __init__(self, fn):
        self.fn = fn

    def __enter__(self):
        from repro_torch.kernels.flash_attention import ref as rfa
        self.saved, rfa.attention = rfa.attention, self.fn

    def __exit__(self, *exc):
        from repro_torch.kernels.flash_attention import ref as rfa
        rfa.attention = self.saved


def logit_reading(got, want) -> dict:
    """max |got - want| and its largest ratio to the logit tolerance
    (``torch.allclose`` passes exactly when the ratio is at most 1)."""
    import torch
    if not bool(torch.isfinite(got).all()) or got.shape != want.shape:
        raise AssertionError(f"non-finite logits or shape "
                             f"{tuple(got.shape)} != {tuple(want.shape)}")
    diff = (got.double() - want.double()).abs()
    ratio = diff / (LOGIT_ATOL + LOGIT_RTOL * want.double().abs())
    return {"max_abs": float(diff.max()), "tol_ratio": float(ratio.max())}


def hold(label: str, sound: float, control: float) -> None:
    """A reading (ratio to its tolerance) of the kernel's run passes, the
    hidden-tile control's fails: the limit can tell a lost tile apart."""
    if not sound <= 1.0:
        raise AssertionError(f"{label}: {sound:.4g} of its tolerance")
    if not control > 1.0:
        raise AssertionError(f"{label}: the hidden-tile control reads only "
                             f"{control:.4g} of the tolerance, which could "
                             f"not tell a lost KV tile apart")


def phase_lm_serve(dev, reset_counts, read_counts) -> dict:
    """``serve`` of the full-width LM, then its logits held to a run
    through the plain attention and to teacher-forced decoding."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention import kernel as kfa
    from repro_torch.kernels.flash_attention import ref as rfa
    from repro_torch.launch import serve_lm
    from repro_torch.models import transformer
    from repro_torch.models.model import Model

    cfg = get_config(LM_ARCH)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = Model(cfg)                          # device left at its default
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in params.parameters())
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    gen, stats = serve_lm.serve(LM_ARCH, smoke=False, params=params,
                                verbose=False, **LM_SERVE)
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    want = dict.fromkeys(launches, 0) | {"flash_attention": cfg.num_layers}
    if launches != want:
        raise AssertionError(f"serve launched {launches}, expected {want} "
                             f"(one flash launch per layer of the prefill)")
    if gen.shape != (LM_SERVE["batch"], LM_SERVE["gen_len"]) or \
            gen.min() < 0 or gen.max() >= cfg.vocab_size:
        raise AssertionError(f"serve tokens out of range: {gen.shape}")

    b, p = LM_SERVE["batch"], LM_SERVE["prompt_len"]
    prompts = torch.from_numpy(serve_lm.make_prompts(
        cfg.vocab_size, b, p, 0)).to(dev).long()
    batch = {"tokens": prompts}
    # The same prefill again, keeping the last layer's q, k, v as the
    # model hands them to the kernel, to hold that call element by element.
    launch, captured = kfa.flash_attention_fwd, {}

    def capture(q, k, v, **kw):
        captured.update(q=q, k=k, v=v, kw=kw)
        return launch(q, k, v, **kw)

    kfa.flash_attention_fwd = capture
    try:
        logits, caches = model.prefill(params, batch,
                                       max_len=LM_SERVE["max_len"])
    finally:
        kfa.flash_attention_fwd = launch
    q, k, v, kw = (captured[n] for n in ("q", "k", "v", "kw"))
    got, want = launch(q, k, v, **kw), rfa.attention(q, k, v, **kw)
    layer_err, tol = max_abs_diff(got, want), FLASH_TOL["bfloat16"]
    if not torch.allclose(got.float(), want.float(), atol=tol, rtol=tol):
        raise AssertionError(f"flash kernel != plain on the prefill's last "
                             f"layer: max |diff| {layer_err} over {tol}")
    layer_call = {"q": list(q.shape), "q_strides": list(q.stride()),
                  "k": list(k.shape), **kw, "max_abs_err": layer_err}
    del q, k, v, got, want, captured

    plain_logits, _ = Model(cfg, plain=True).prefill(
        params, batch, max_len=LM_SERVE["max_len"])
    with plain_attention_replaced(hidden_tile_attention):
        control_logits, _ = Model(cfg, plain=True).prefill(
            params, batch, max_len=LM_SERVE["max_len"])
    prefill_read = logit_reading(logits, plain_logits)
    prefill_control = logit_reading(control_logits, plain_logits)
    hold("prefill kernel vs plain", prefill_read["tol_ratio"],
         prefill_control["tol_ratio"])
    first = torch.argmax(logits[:, -1], -1).cpu().numpy()
    if not (first == gen[:, 0]).all():
        raise AssertionError("prefill's greedy token != serve's first token")

    # Teacher forcing: decode serve's own tokens, compare with one
    # full-sequence forward (flash over a ragged 1032-token sequence).
    forced = torch.from_numpy(gen[:, :TEACHER_STEPS]).to(dev).long()
    steps = [logits[:, 0]]
    for j in range(TEACHER_STEPS):
        lg, caches = model.decode_step(params, forced[:, j:j + 1], caches)
        steps.append(lg[:, 0])
    steps = torch.stack(steps, 1)

    def full_forward(plain: bool):
        with torch.no_grad():
            h, _ = transformer.backbone(params, transformer.embed_tokens(
                params, torch.cat([prompts, forced], dim=1)), plain=plain)
            return transformer.logits_from_hidden(params, h[:, p - 1:])

    decode_read = logit_reading(steps, full_forward(False))
    with plain_attention_replaced(hidden_tile_attention):
        decode_control = logit_reading(steps, full_forward(True))
    hold("teacher-forced decode vs full sequence", decode_read["tol_ratio"],
         decode_control["tol_ratio"])
    prefill_prof = device_profile(lambda: model.prefill(
        params, batch, max_len=LM_SERVE["max_len"]))
    decode_prof = device_profile(lambda: model.decode_step(
        params, forced[:, :1], caches))
    emit("lm_serve", arch=LM_ARCH, layers=cfg.num_layers,
         d_model=cfg.d_model, heads=[cfg.num_heads, cfg.num_kv_heads],
         head_dim=cfg.head_dim, params=n_params, dtype=cfg.dtype,
         **LM_SERVE, init_s=init_s, prefill_ms=stats["prefill_ms"],
         decode_tokens_per_s=stats["decode_tokens_per_s"],
         max_memory_allocated=peak, launches=launches,
         last_layer_flash_call=layer_call,
         logit_tolerance=[LOGIT_ATOL, LOGIT_RTOL],
         control_hidden_keys=[CONTROL_KEYS.start, CONTROL_KEYS.stop],
         prefill_kernel_vs_plain=prefill_read,
         prefill_control_vs_plain=prefill_control,
         teacher_forced_steps=TEACHER_STEPS,
         decode_vs_full=decode_read, decode_vs_control_full=decode_control,
         prefill_profile=prefill_prof, decode_step_profile=decode_prof,
         sample_output=stats["sample_output"])
    return {"params": params, "launches": launches}


def phase_lm_forward(dev, params, reset_counts, read_counts) -> None:
    """``Model.loss_fn`` forward at B x S = 2 x 2048 through the kernel and
    through the plain attention, on the same weights."""
    import numpy as np
    import torch
    from repro_torch.models.model import Model

    cfg = params.cfg
    b, s = LM_FORWARD["batch"], LM_FORWARD["seq"]
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (b, s + 1))
    toks = torch.from_numpy(toks).to(dev)
    batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:],
             "mask": torch.ones(b, s, device=dev)}
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        loss, _ = Model(cfg).loss_fn(params, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        launches = read_counts()
        plain, _ = Model(cfg, plain=True).loss_fn(params, batch)
        with plain_attention_replaced(hidden_tile_attention):
            control, _ = Model(cfg, plain=True).loss_fn(params, batch)
    if launches["flash_attention"] != cfg.num_layers:
        raise AssertionError(f"loss_fn launched {launches}")
    loss, plain, control = float(loss), float(plain), float(control)
    if not math.isfinite(loss):
        raise AssertionError(f"loss {loss} is not finite")
    hold(f"loss {loss} vs plain {plain} (atol {LOSS_ATOL})",
         abs(loss - plain) / LOSS_ATOL, abs(control - plain) / LOSS_ATOL)
    emit("lm_forward", arch=cfg.name, batch=b, seq=s, loss=loss,
         plain_loss=plain, control_loss=control,
         loss_atol=LOSS_ATOL, wall_ms=wall_ms, launches=launches,
         max_memory_allocated=torch.cuda.max_memory_allocated())


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1

    import numpy as np

    from repro_torch.core import (diagram_to_numpy, persistence_oracle,
                                  pixhomology)
    from repro_torch.core.packed_keys import key_pad
    from repro_torch.data import astro
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as kfa
    from repro_torch.kernels.maxpool import kernel as kmp
    from repro_torch.kernels.maxpool import ref as rmp
    from repro_torch.kernels.ph_distance import kernel as kd
    from repro_torch.kernels.ph_distance import ref as rd
    from repro_torch.kernels.ph_phase_a import kernel as ka
    from repro_torch.kernels.ph_phase_a import ref as ra
    from repro_torch.kernels.ph_phase_c import kernel as kc
    from repro_torch.kernels.ph_phase_c import ops as oc
    from repro_torch.kernels.ph_phase_c import ref as rc
    from repro_torch.ph import PHConfig, PHEngine
    from repro_torch.pipeline.scheduler import bucket_shape

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False   # full float32 products
    libraries = {"ph_phase_a": ka.LIBRARY, "ph_phase_c": kc.LIBRARY,
                 "maxpool": kmp.LIBRARY, "ph_distance": kd.LIBRARY,
                 "flash_attention": kfa.LIBRARY}

    def reset_counts() -> None:
        for lib in libraries.values():
            lib.launches = 0

    def read_counts() -> dict:
        return {name: lib.launches for name, lib in libraries.items()}

    def same_diagram(a, b) -> bool:
        return all(np.array_equal(x, y) for x, y in
                   zip(diagram_to_numpy(a), diagram_to_numpy(b)))

    # -- 1. device ---------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    emit("device", name=name, nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, count=torch.cuda.device_count())

    # -- 2. build ----------------------------------------------------------
    build_s = _build.build_all(list(libraries.values()))
    emit("build", seconds=round(build_s, 3),
         libraries=[str(lib.library_path().relative_to(ROOT))
                    for lib in libraries.values()],
         ptxas={name: ptxas_report(libraries[name])
                for name in ("flash_attention", "maxpool", "ph_distance",
                             "ph_phase_c")},
         ptxas_note="flash_fwd_wgmma_kernel's registers are its launch "
                    "share; setmaxnreg leaves the producer warpgroup 24 and "
                    "gives each consumer warpgroup 240")

    # -- 3. phase-A kernel vs plain ---------------------------------------
    rng = np.random.default_rng(0)

    def as_dtype(img: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
        if dtype == torch.uint8:
            img = np.clip(np.abs(img), 0, 255)
        t = torch.from_numpy(np.ascontiguousarray(img).astype(np.float32))
        return t.to(dtype).to(dev).contiguous()

    err = {name: 0.0 for name in libraries}

    def check_phase_a(x: torch.Tensor, s: int, label: str) -> None:
        p_k, m_k = ka.phase_a(x, strip_rows=s)
        p_r, m_r = ra.phase_a(x, strip_rows=s)
        err["ph_phase_a"] = max(err["ph_phase_a"], max_abs_diff(p_k, p_r),
                                max_abs_diff(m_k, m_r))
        if not (torch.equal(p_k, p_r) and torch.equal(m_k, m_r)):
            bad = int((p_k != p_r).sum() + (m_k != m_r).sum())
            raise AssertionError(f"phase_a kernel != plain on {label} "
                                 f"(S={s}): {bad} differing entries")

    dtypes = (torch.uint8, torch.int16, torch.int32, torch.float32,
              torch.bfloat16)
    n_cases = 0
    for dt in dtypes:
        for shape in ((37, 53), (64, 64), (1, 29), (29, 1), (1, 1)):
            gauss = rng.normal(size=shape) * 40
            ties = rng.integers(0, 3, size=shape).astype(np.float64)
            for kind, img in (("gauss", gauss), ("ties", ties)):
                for s in (1, 8, 16):
                    check_phase_a(as_dtype(img, dt), s, f"{kind}{shape}/{dt}")
                    n_cases += 1
        ramp = np.tile(np.arange(4096, dtype=np.float64) % 200, (24, 1))
        check_phase_a(as_dtype(ramp, dt), 8, f"ramp/{dt}")
        check_phase_a(as_dtype(np.full((33, 65), 7.0), dt), 8, f"const/{dt}")
        n_cases += 2
    wide = np.tile(np.arange(8192, dtype=np.float64), (20, 1))
    check_phase_a(as_dtype(wide, torch.float32), 8, "wide ramp 20x8192")
    batch = as_dtype(rng.normal(size=(3, 45, 70)) * 9, torch.bfloat16)
    check_phase_a(batch, 8, "batch (3, 45, 70)")
    frame = astro.generate_image(0, MAIN_SIZE)
    x_main = torch.from_numpy(frame).to(dev)
    for s in (1, 8, 16):
        check_phase_a(x_main, s, f"astro {MAIN_SIZE}²")
    n_cases += 5
    n = MAIN_SIZE * MAIN_SIZE
    a_ms = cuda_ms(lambda: ka.phase_a(x_main, strip_rows=8))
    a_dev_ms = device_ms(lambda: ka.phase_a(x_main, strip_rows=8))
    a_plain_ms = cuda_ms(lambda: ra.phase_a(x_main, strip_rows=8))
    a_bytes = n * (4 + 4 + 4)            # read f32 image, write ptr + mask
    a_bound_ms = a_bytes / HBM_BYTES_PER_S * 1e3
    emit("phase_a", cases=n_cases, bitwise_equal=True, shape=[MAIN_SIZE] * 2,
         dtype="float32", strip_rows=8, kernel_ms=a_ms, device_ms=a_dev_ms,
         plain_ms=a_plain_ms, bound_ms=a_bound_ms,
         bound_share=a_bound_ms / a_dev_ms)

    # -- 4. maxpool kernel vs plain ----------------------------------------
    def check_pool(x: torch.Tensor, label: str) -> None:
        kv, kai = kmp.maxargmaxpool3x3(x)
        rv, rai = rmp.maxargmaxpool3x3(x)
        pairs = [(kv, rv), (kai, rai),
                 (kmp.maxpool3x3(x), rmp.maxpool3x3(x)),
                 (kmp.minpool3x3(x), rmp.minpool3x3(x))]
        for got, want in pairs:
            err["maxpool"] = max(err["maxpool"], max_abs_diff(got, want))
            if not torch.equal(got, want):
                bad = int((got != want).sum())
                raise AssertionError(f"maxpool kernel != plain on {label}: "
                                     f"{bad} differing entries")
            if got.dtype.is_floating_point and not torch.equal(
                    torch.signbit(got), torch.signbit(want)):
                raise AssertionError(f"maxpool kernel != plain on {label}: "
                                     f"the sign of a zero differs")

    n_pool = 0
    for dt in dtypes:
        fill = float("-inf") if dt.is_floating_point \
            else float(torch.iinfo(dt).min)         # uint8: 0
        for shape in ((1, 1), (1, 29), (29, 1), (37, 53)):
            gauss = rng.normal(size=shape) * 40
            ties = rng.integers(0, 3, size=shape).astype(np.float64)
            for kind, img in (("gauss", gauss), ("ties", ties)):
                check_pool(as_dtype(img, dt), f"{kind}{shape}/{dt}")
                n_pool += 1
            check_pool(torch.full(shape, fill, dtype=dt, device=dev),
                       f"fill-valued{shape}/{dt}")
            n_pool += 1
        # The edges of the kernel's tiles (32 rows by 32 16-byte vectors of
        # VEC values), batches, contiguous views whose base is not 16-byte
        # aligned, heavy ties everywhere and signed zeros.  Widths that are
        # a multiple of VEC take the 16-byte loads and stores: batches of
        # them, and 4096 + VEC, whose last vector ends inside a tile.
        vec = 16 // dt.itemsize
        for shape in ((4095, 4097), (33, 129), (1, 4097), (3, 33, 129),
                      (3, 33, 128), (2, 40, 4096), (33, 4096 + vec)):
            ties = rng.integers(0, 3, size=shape).astype(np.float64)
            check_pool(as_dtype(ties, dt), f"ties{shape}/{dt}")
            n_pool += 1
        odd = as_dtype(rng.integers(0, 3, size=(41, 67)).astype(np.float64),
                       dt)
        check_pool(odd[1:], f"unaligned view (40, 67)/{dt}")
        flat = as_dtype(rng.integers(0, 3, size=1 + 40 * 64)
                        .astype(np.float64), dt)
        check_pool(flat[1:].view(40, 64), f"unaligned view (40, 64)/{dt}")
        n_pool += 2
        for shape in ((37, 130), (37, 128)):
            zeros = rng.choice([0.0, -0.0, 1.0, -1.0], size=shape)
            check_pool(torch.from_numpy(zeros.astype(np.float32)).to(dt)
                       .to(dev) if dt.is_floating_point
                       else as_dtype(zeros, dt),
                       f"signed zeros {shape}/{dt}")
            n_pool += 1
    comp_ties = torch.from_numpy(rng.integers(
        0, 3, size=(MAIN_SIZE, MAIN_SIZE)).astype(np.int32)).to(dev)
    check_pool(x_main, f"astro {MAIN_SIZE}² float32")
    check_pool(comp_ties, f"ties {MAIN_SIZE}² int32")
    n_pool += 2
    p_plain_ms = cuda_ms(lambda: rmp.maxargmaxpool3x3(x_main))
    x4 = x_main[None, None]
    p_timed = in_turns(lambda: kmp.maxargmaxpool3x3(x_main),
                       lambda: torch.nn.functional.max_pool2d(
                           x4, 3, 1, 1, return_indices=True))
    p_ms, p_lib_ms = p_timed["ms"], p_timed["library_ms"]
    p_dev_ms = p_timed["device_ms"]
    p_bytes = n * (4 + 4 + 4)            # read f32 image, write value + arg
    p_bound_ms = p_bytes / HBM_BYTES_PER_S * 1e3
    emit("maxpool", cases=n_pool, bitwise_equal=True,
         shape=[MAIN_SIZE] * 2, dtype="float32", kernel_ms=p_ms,
         device_ms=p_dev_ms, plain_ms=p_plain_ms,
         library_ms_max_pool2d_indices=p_lib_ms,
         library_device_ms=p_timed["library_device_ms"],
         turns_ms=p_timed["turns_ms"],
         turns_device_ms=p_timed["turns_device_ms"], bound_ms=p_bound_ms,
         bound_share=p_bound_ms / p_dev_ms)

    # -- 5. main path (drives the kernels; its first best-edge round is
    #       captured for the best-edge timing below) --------------------------
    cfg = PHConfig(**MAIN_CONFIG)
    engine = PHEngine(cfg)                      # device left at its default
    reset_counts()
    t0 = time.perf_counter()
    res = engine.run(frame)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = read_counts()
    if min(launches["ph_phase_a"], launches["ph_phase_c"]) <= 0:
        raise AssertionError(f"main path missed a kernel: {launches}")
    mf, mc = res.regrow.final_max_features, res.regrow.final_max_candidates
    if res.regrow.overflow or bool(res.diagram.overflow):
        raise AssertionError("main path still overflows after regrow")

    # Steady state: the regrow memo starts at the final capacities.
    before = kc.LIBRARY.launches
    t0 = time.perf_counter()
    res2 = engine.run(frame)
    torch.cuda.synchronize()
    steady_ms = (time.perf_counter() - t0) * 1e3
    rounds = kc.LIBRARY.launches - before
    if res2.regrow.attempts or not same_diagram(res.diagram, res2.diagram):
        raise AssertionError("steady-state run differs from the first run")

    # Host-side parts of run(): the Variant-2 statistic and the upload.
    t0 = time.perf_counter()
    engine.auto_threshold(frame)
    threshold_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    x_run = engine.cast_input(frame)
    torch.cuda.synchronize()
    cast_ms = (time.perf_counter() - t0) * 1e3

    # Per-stage device times of the same computation (CUDA events between
    # stage marks), with the kernels and with the plain versions.
    tv = torch.tensor(res.threshold, dtype=torch.float32, device=dev)
    stage_kw = dict(max_features=mf, max_candidates=mc, merge_impl="boruvka",
                    phase_c_impl="fused", strip_rows=cfg.strip_rows)

    def staged(use_pallas, kw=stage_kw, want=None):
        """Per-stage device times of one ``pixhomology`` call (CUDA events
        between stage marks); the diagram must equal ``want``."""
        marks = []

        def mark(stage: str) -> None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((stage, ev))

        start = torch.cuda.Event(enable_timing=True)
        start.record()
        d = pixhomology(x_run, tv, mark=mark, use_pallas=use_pallas, **kw)
        torch.cuda.synchronize()
        ms, prev = {}, start
        for stage, ev in marks:
            ms[stage] = prev.elapsed_time(ev)
            prev = ev
        if not same_diagram(d, res.diagram if want is None else want):
            raise AssertionError(f"staged run (use_pallas={use_pallas}) "
                                 f"differs from the engine run")
        return ms

    stage_ms = staged(None)
    plain_stage_ms = staged(False)

    # The plain versions on the card, same capacities: bitwise equal.
    plain = PHEngine(cfg.replace(use_pallas=False, max_features=mf,
                                 max_candidates=mc))
    ka.LIBRARY.launches = kc.LIBRARY.launches = 0
    t0 = time.perf_counter()
    res_plain = plain.run(frame)
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3
    if ka.LIBRARY.launches or kc.LIBRARY.launches:
        raise AssertionError("use_pallas=False still launched a kernel")
    if not same_diagram(res.diagram, res_plain.diagram):
        raise AssertionError("kernel run != plain-version run at 4096²")

    # Capture the main path's first Boruvka round (the largest instance).
    captured = []
    kernel_fn = kc.best_edge_reduce

    def capture(key, ra_, rb_, nv):
        if not captured:
            captured.append((key.clone(), ra_.clone(), rb_.clone(), nv))
        return kernel_fn(key, ra_, rb_, nv)

    oc.kernel.best_edge_reduce = capture
    try:
        engine.run(frame)
    finally:
        oc.kernel.best_edge_reduce = kernel_fn

    emit("main", shape=[MAIN_SIZE] * 2, config=json.loads(cfg.to_json()),
         threshold=res.threshold, count=int(res.diagram.count),
         n_unmerged=int(res.diagram.n_unmerged),
         regrow_attempts=res.regrow.attempts, final_max_features=mf,
         final_max_candidates=mc, boruvka_rounds=rounds,
         first_call_s=first_s, steady_wall_ms=steady_ms,
         plain_steady_wall_ms=plain_wall_ms, host_threshold_ms=threshold_ms,
         host_cast_upload_ms=cast_ms, stage_ms=stage_ms,
         plain_stage_ms=plain_stage_ms,
         launches=launches, equals_plain=True)

    # -- 6. best-edge kernel vs plain --------------------------------------
    def check_best(key, ra_, rb_, nv, label):
        b_k, w_k = kc.best_edge_reduce(key, ra_, rb_, nv)
        b_r, w_r = rc.best_edge_reduce(key, ra_, rb_, nv)
        err["ph_phase_c"] = max(err["ph_phase_c"], max_abs_diff(b_k, b_r),
                                max_abs_diff(w_k, w_r))
        if not (torch.equal(b_k, b_r) and torch.equal(w_k, w_r)):
            raise AssertionError(f"best_edge kernel != plain on {label}")

    def instance(e, nv, dtype, dead, keyspace):
        pad = key_pad(dtype)
        key = torch.from_numpy(rng.integers(-keyspace, keyspace, size=e))
        key = torch.where(torch.from_numpy(rng.random(e) < dead), pad, key)
        ends = [torch.from_numpy(rng.integers(0, nv, size=e).astype(np.int32))
                for _ in range(2)]
        return (key.to(dtype).to(dev), ends[0].to(dev), ends[1].to(dev), nv)

    n_best = 0
    full_e, full_nv = 8 * mc, mf
    for dtype in (torch.int32, torch.int64):
        for e, nv, dead, ks in ((1, 1, 0.0, 5), (7, 3, 0.3, 5),
                                (1000, 17, 0.3, 3), (4096, 64, 1.0, 5),
                                (100_000, 5000, 0.5, 10),
                                (full_e, full_nv, 0.3, 1 << 20)):
            check_best(*instance(e, nv, dtype, dead, ks),
                       f"{dtype} E={e} nv={nv} dead={dead}")
            n_best += 1
    n_best += best_edge_cases(dev, rng, err)
    key, ra_, rb_, nv = captured[0]
    check_best(key, ra_, rb_, nv, "main-path round 1")
    n_best += 1
    e_plain_ms = cuda_ms(lambda: rc.best_edge_reduce(key, ra_, rb_, nv))
    pad = key_pad(key.dtype)
    alive = key > pad
    live = int(alive.sum())
    drop = torch.full_like(ra_, nv)
    lib_idx = torch.cat([torch.where(alive, ra_, drop),
                         torch.where(alive, rb_, drop)]).long()
    lib_src = torch.cat([key, key])
    lib_best = torch.full((nv + 1,), pad, dtype=key.dtype, device=dev)
    e_timed = in_turns(lambda: kc.best_edge_reduce(key, ra_, rb_, nv),
                       lambda: lib_best.scatter_reduce_(0, lib_idx, lib_src,
                                                        "amax"))
    e_ms, e_dev_ms = e_timed["ms"], e_timed["device_ms"]
    e_lib_ms = e_timed["library_ms"]
    kb = key.element_size()
    # Every key read once, the endpoints of live edges once, both tables
    # written once.
    e_bytes = key.numel() * kb + live * 8 + nv * (kb + 4)
    e_bound_ms = e_bytes / HBM_BYTES_PER_S * 1e3
    # What the kernel reads by its design: every key once (16-byte
    # vectors), the endpoints of live edges in pass 1, then per list entry
    # the index, its key, its endpoints and both ends' best.
    e_read = key.numel() * kb + live * (8 + 4 + kb + 8 + 2 * kb)
    emit("best_edge", cases=n_best, bitwise_equal=True, edges=key.numel(),
         live_edges=live, nv=nv, key_dtype=str(key.dtype),
         kernel_ms=e_ms, device_ms=e_dev_ms, plain_ms=e_plain_ms,
         library_ms_scatter_reduce_amax=e_lib_ms,
         library_device_ms=e_timed["library_device_ms"],
         turns_ms=e_timed["turns_ms"],
         turns_device_ms=e_timed["turns_device_ms"], bound_ms=e_bound_ms,
         bound_share=e_bound_ms / e_dev_ms, read_bytes=e_read,
         read_tb_per_s=e_read / e_dev_ms / 1e9, design=DESIGN[
             "ph_phase_c_best_edge"])

    # -- 7. paper: the paper's pooled Algorithm 1 through run() -------------
    paper_cfg = cfg.replace(phase_a_impl="pooled", candidate_mode="paper")
    paper = PHEngine(paper_cfg)
    reset_counts()
    t0 = time.perf_counter()
    pres = paper.run(frame)
    torch.cuda.synchronize()
    paper_first_s = time.perf_counter() - t0
    paper_launches = read_counts()
    if min(paper_launches["maxpool"], paper_launches["ph_phase_c"]) <= 0:
        raise AssertionError(f"paper path missed a kernel: {paper_launches}")
    if pres.regrow.overflow or bool(pres.diagram.overflow):
        raise AssertionError("paper path still overflows after regrow")
    t0 = time.perf_counter()
    pres2 = paper.run(frame)
    torch.cuda.synchronize()
    paper_steady_ms = (time.perf_counter() - t0) * 1e3
    if not same_diagram(pres.diagram, pres2.diagram):
        raise AssertionError("paper steady-state run differs")
    pmf = pres.regrow.final_max_features
    pmc = pres.regrow.final_max_candidates
    paper_plain = PHEngine(paper_cfg.replace(
        use_pallas=False, max_features=pmf, max_candidates=pmc))
    reset_counts()
    t0 = time.perf_counter()
    pres_plain = paper_plain.run(frame)
    torch.cuda.synchronize()
    paper_plain_ms = (time.perf_counter() - t0) * 1e3
    if max(read_counts().values()):
        raise AssertionError("use_pallas=False still launched a kernel")
    if not same_diagram(pres.diagram, pres_plain.diagram):
        raise AssertionError("paper run != plain-version run at 4096²")
    pooled_exact = PHEngine(cfg.replace(
        phase_a_impl="pooled", max_features=mf, max_candidates=mc))
    if not same_diagram(res.diagram, pooled_exact.run(frame).diagram):
        raise AssertionError("pooled phase A with exact candidates != the "
                             "main (fused) diagram")
    paper_kw = dict(stage_kw, max_features=pmf, max_candidates=pmc,
                    phase_a_impl="pooled", candidate_mode="paper")
    paper_stage_ms = staged(None, paper_kw, pres.diagram)
    emit("paper", shape=[MAIN_SIZE] * 2,
         config=json.loads(paper_cfg.to_json()), count=int(pres.diagram.count),
         n_unmerged=int(pres.diagram.n_unmerged),
         regrow_attempts=pres.regrow.attempts, final_max_features=pmf,
         final_max_candidates=pmc, first_call_s=paper_first_s,
         steady_wall_ms=paper_steady_ms, plain_wall_ms=paper_plain_ms,
         stage_ms=paper_stage_ms, launches=paper_launches, equals_plain=True,
         pooled_exact_equals_main=True)

    # -- 8. batch ----------------------------------------------------------
    frames = np.stack([astro.generate_image(i, BATCH_SIZE)
                       for i in range(1, 5)])
    batch_engine = PHEngine(cfg)
    rb_res = batch_engine.run_batch(frames)
    single = PHEngine(cfg.replace(
        max_features=rb_res.regrow.final_max_features,
        max_candidates=rb_res.regrow.final_max_candidates))
    rows = diagram_to_numpy(rb_res.diagram)
    for i in range(frames.shape[0]):
        one = diagram_to_numpy(single.run(frames[i]).diagram)
        if not all(np.array_equal(a[i], b) for a, b in zip(rows, one)):
            raise AssertionError(f"run_batch row {i} != single run")
    emit("batch", shape=list(frames.shape), counts=rows.count.tolist(),
         regrow_attempts=rb_res.regrow.attempts,
         final_max_features=rb_res.regrow.final_max_features,
         final_max_candidates=rb_res.regrow.final_max_candidates,
         equals_single_runs=True)

    # -- 9. mixed_batch: a survey batch of mixed shapes, one bucket ---------
    survey = survey_frames()
    twin, twin_of = len(survey) - 1, 2
    mixed = PHEngine(cfg)
    reset_counts()
    t0 = time.perf_counter()
    mres = mixed.run_batch(survey)
    torch.cuda.synchronize()
    mixed_ms = (time.perf_counter() - t0) * 1e3
    mixed_launches = read_counts()
    if min(mixed_launches["ph_phase_a"], mixed_launches["ph_phase_c"]) <= 0:
        raise AssertionError(f"mixed batch missed a kernel: {mixed_launches}")
    dispatch = sorted({key[1] for key in mixed._plans if key[0] == "batched"})
    want_bucket = tuple(max(bucket_shape(im.shape)[d] for im in survey)
                        for d in (0, 1))
    if dispatch != [(len(survey) - 1, *want_bucket)]:
        raise AssertionError(f"unexpected dispatch shapes {dispatch}")
    mmf = mres.regrow.final_max_features
    mmc = mres.regrow.final_max_candidates
    msingle = PHEngine(cfg.replace(max_features=mmf, max_candidates=mmc))
    mrows = diagram_to_numpy(mres.diagram)
    for i, im in enumerate(survey):
        one = diagram_to_numpy(msingle.run(im).diagram)
        if not all(np.array_equal(a[i], b) for a, b in zip(mrows, one)):
            raise AssertionError(f"mixed run_batch row {i} {im.shape} != "
                                 f"single run")
    if not all(np.array_equal(a[twin], a[twin_of]) for a in mrows):
        raise AssertionError("duplicate row != its twin")
    # Host parts of run_batch, each timed on its own: the content hash of
    # the dedupe, the Variant-2 statistic per frame; then the same batch
    # with its thresholds given (regrow memo settled).
    t0 = time.perf_counter()
    mixed._dedupe_batch(survey, None)
    dedupe_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    survey_tv = [mixed.auto_threshold(im) for im in survey]
    mixed_threshold_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    mres2 = mixed.run_batch(survey, survey_tv)
    torch.cuda.synchronize()
    mixed_given_ms = (time.perf_counter() - t0) * 1e3
    if mres2.regrow.attempts or not same_diagram(mres.diagram,
                                                 mres2.diagram):
        raise AssertionError("mixed batch with given thresholds differs")
    emit("mixed_batch", shapes=[list(im.shape) for im in survey],
         dispatch_shape=list(dispatch[0]),
         dispatch_mpx=int(np.prod(dispatch[0])) / 1e6,
         counts=mrows.count.tolist(), regrow_attempts=mres.regrow.attempts,
         final_max_features=mmf, final_max_candidates=mmc,
         wall_ms=mixed_ms, host_dedupe_hash_ms=dedupe_ms,
         host_threshold_ms=mixed_threshold_ms,
         steady_wall_ms_given_thresholds=mixed_given_ms,
         launches=mixed_launches, equals_single_runs=True,
         duplicate_equals_twin=True)

    # -- 10. distance: the mixed batch's rows compared pairwise -------------
    reset_counts()
    t0 = time.perf_counter()
    sw, bn = mixed.distance_matrix(mres, n_dirs=N_DIRS)
    torch.cuda.synchronize()
    dist_ms = (time.perf_counter() - t0) * 1e3
    dist_launches = read_counts()
    if dist_launches["ph_distance"] <= 0:
        raise AssertionError(f"distance path missed its kernel: "
                             f"{dist_launches}")
    if not (torch.equal(sw, sw.T) and torch.equal(bn, bn.T)
            and not sw.diagonal().any() and not bn.diagonal().any()):
        raise AssertionError("distance matrices not exactly symmetric with "
                             "a zero diagonal")
    if sw[twin, twin_of] != 0 or bn[twin, twin_of] != 0:
        raise AssertionError("duplicate frames at a non-zero distance")
    # The engine call's parts, each on its own (host clock, synchronized).
    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    (birth, death, p_birth), stack_ms = timed(
        lambda: mixed._stack_diagrams(mres))
    birth, death = birth.float(), death.float()
    (pts, dirs), proj_ms = timed(lambda: rd.diagram_projections(
        birth, death, p_birth, n_dirs=N_DIRS))
    pts, dirs = pts.contiguous(), dirs.contiguous()
    prof, prof_ms = timed(lambda: rd.persistence_profiles(
        birth, death, p_birth, merge_keys="packed").contiguous())
    ksw, kbn = kd.distance_matrix(pts, dirs, prof)
    rsw, rbn = rd.distance_matrix(pts, dirs, prof)
    if not (torch.equal(ksw, sw) and torch.equal(kbn, bn)):
        raise AssertionError("distance kernel on the prepared tables != the "
                             "engine's matrices")
    err["ph_distance"] = max(err["ph_distance"], max_abs_diff(ksw, rsw),
                             max_abs_diff(kbn, rbn))
    if not torch.equal(kbn, rbn):
        raise AssertionError("distance kernel bn != plain version")
    sw_rel = float(((ksw.double() - rsw.double()).abs()
                    / rsw.double().abs().clamp_min(1e-30)).max())
    if not torch.allclose(ksw, rsw, rtol=1e-5, atol=0.0):
        raise AssertionError(f"distance kernel sw != plain version within "
                             f"rtol 1e-5 (max rel {sw_rel})")
    n_dist = 1 + distance_cases(dev, rng, err)
    d_ms = cuda_ms(lambda: kd.distance_matrix(pts, dirs, prof))
    d_dev_ms = device_ms(lambda: kd.distance_matrix(pts, dirs, prof))
    # The kernel's two stages, each timed on its own on shared scratch.
    d_sort, d_pairs = kd.stages(pts, dirs, prof)
    d_sort()
    if not all(torch.equal(a, b) for a, b in zip(d_pairs(), (ksw, kbn))):
        raise AssertionError("distance kernel's stages != the whole kernel")
    d_sort_ms = device_ms(d_sort)
    d_merge_ms = device_ms(d_pairs)
    d_plain_ms = cuda_ms(lambda: rd.distance_matrix(pts, dirs, prof), reps=3)
    b_rows, k_dirs, f_cap = pts.shape
    d_bytes = (2 * b_rows * k_dirs * f_cap + b_rows * f_cap
               + 2 * b_rows * b_rows) * 4
    d_ops = b_rows * b_rows * k_dirs * 2 * 2 * f_cap
    d_bound_ms = max(d_bytes / HBM_BYTES_PER_S, d_ops / FP32_OPS_PER_S) * 1e3
    d_bound_by = "bytes" if d_bytes / HBM_BYTES_PER_S >= \
        d_ops / FP32_OPS_PER_S else "operations"
    emit("distance", rows=b_rows, n_dirs=k_dirs, capacity=f_cap,
         engine_wall_ms=dist_ms, stack_ms=stack_ms, projections_ms=proj_ms,
         profiles_ms=prof_ms, launches=dist_launches, cases=n_dist,
         kernel_ms=d_ms, device_ms=d_dev_ms, sort_ms=d_sort_ms,
         merge_ms=d_merge_ms, plain_ms=d_plain_ms, bound_ms=d_bound_ms,
         bound_by=d_bound_by, bound_share=d_bound_ms / d_dev_ms,
         design=DESIGN["ph_distance"],
         bn_bitwise_equal=True, sw_max_rel_err=sw_rel,
         symmetric_zero_diagonal=True,
         sw_matrix=sw.cpu().tolist(), bn_matrix=bn.cpu().tolist())

    # -- 11. oracle --------------------------------------------------------
    s = ORACLE_SIZE
    n_small = s * s
    astro_small = astro.generate_image(5, s)
    u8 = rng.integers(0, 256, size=(s, s)).astype(np.uint8)
    bf = torch.from_numpy(rng.normal(size=(s, s)).astype(np.float32)).to(
        torch.bfloat16)
    images = {"astro_f32": (astro_small, astro_small),
              "uint8": (u8, u8),
              "bfloat16": (bf, bf.to(torch.float32).numpy())}
    checked = {}
    for label, (img, host) in images.items():
        want = persistence_oracle(host)
        for merge_impl, impl in (("scan", "fused"), ("boruvka", "xla"),
                                 ("boruvka", "fused")):
            eng = PHEngine(PHConfig(max_features=n_small,
                                    max_candidates=n_small,
                                    merge_impl=merge_impl,
                                    phase_c_impl=impl))
            got = eng.run(img).to_array()
            if got.shape != want.shape or not np.array_equal(got, want):
                raise AssertionError(f"oracle mismatch: {label} "
                                     f"{merge_impl}/{impl}")
        checked[label] = int(want.shape[0])
    emit("oracle", size=s, features=checked,
         merges=["scan", "boruvka/xla", "boruvka/fused"], equal=True)

    # -- 12-14. flash attention, LM serving, LM forward ----------------------
    fa = phase_flash_attention(dev, rng, err)
    lm = phase_lm_serve(dev, reset_counts, read_counts)
    phase_lm_forward(dev, lm["params"], reset_counts, read_counts)

    # -- kernel table, card, result ----------------------------------------
    kernels = [
        {"name": "ph_phase_a", "route": "cuda",
         "source": "src/repro_torch/kernels/ph_phase_a/csrc/phase_a.cu",
         "replaces": "src/repro/kernels/ph_phase_a/kernel.py:52",
         "launches": launches["ph_phase_a"],
         "max_abs_err": err["ph_phase_a"],
         "ms": a_ms, "device_ms": a_dev_ms, "plain_ms": a_plain_ms,
         "bound_ms": a_bound_ms, "bound_by": "bytes", "library_ms": None},
        {"name": "ph_phase_c_best_edge", "route": "cuda",
         "source": "src/repro_torch/kernels/ph_phase_c/csrc/best_edge.cu",
         "replaces": "src/repro/kernels/ph_phase_c/kernel.py:42",
         "launches": launches["ph_phase_c"],
         "max_abs_err": err["ph_phase_c"],
         "ms": e_ms, "device_ms": e_dev_ms, "plain_ms": e_plain_ms,
         "bound_ms": e_bound_ms, "bound_by": "bytes", "library_ms": e_lib_ms,
         "library_device_ms": e_timed["library_device_ms"],
         "design": DESIGN["ph_phase_c_best_edge"]},
        {"name": "maxpool3x3", "route": "cuda",
         "source": "src/repro_torch/kernels/maxpool/csrc/maxpool.cu",
         "replaces": "src/repro/kernels/maxpool/kernel.py:56",
         "launches": paper_launches["maxpool"],
         "max_abs_err": err["maxpool"],
         "ms": p_ms, "device_ms": p_dev_ms, "plain_ms": p_plain_ms,
         "bound_ms": p_bound_ms, "bound_by": "bytes", "library_ms": p_lib_ms,
         "library_device_ms": p_timed["library_device_ms"],
         "design": DESIGN["maxpool3x3"]},
        {"name": "ph_distance", "route": "cuda",
         "source": "src/repro_torch/kernels/ph_distance/csrc/distance.cu",
         "replaces": "src/repro/kernels/ph_distance/kernel.py:33",
         "launches": dist_launches["ph_distance"],
         "max_abs_err": err["ph_distance"],
         "ms": d_ms, "device_ms": d_dev_ms, "plain_ms": d_plain_ms,
         "bound_ms": d_bound_ms, "bound_by": d_bound_by, "library_ms": None,
         "design": DESIGN["ph_distance"]},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/flash_attention/csrc/"
                   "flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:35",
         "launches": lm["launches"]["flash_attention"],
         "max_abs_err": err["flash_attention"], **fa,
         "design": DESIGN["flash_attention"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
