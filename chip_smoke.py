#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (PixHomology and the LM) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout; one CUDA card

Phases, each printing one JSON line (any failure raises, exit code != 0):

1. device  — card name and power limit (nvidia-smi), torch and CUDA versions;
2. build   — the five CUDA kernels built from
             ``src/repro_torch/kernels/*/csrc`` with one ``nvcc`` per source,
             started together; ptxas's registers, shared memory and spills
             for each kernel of the five libraries;
3. phase_a — the phase-A kernel against its plain version, bitwise
             (``phase_a_cases``): the five dtypes, strip heights 1/8/16
             (and 4/32 on the bucket, the 4096² frame and peak grids),
             ragged strips, ramps, a constant image; every width regime
             and its edges (S * W = 65,536 and a column either side, the
             widest cluster strip and a column more, widths 10240 and
             16384) at S = 8 and 16 with deep column ramps, signed zeros,
             NaN pixels, uint8 zero borders and unaligned views; a
             bfloat16 tie storm,
             batches, the mixed batch's 5 x 2048² bucket and the 4096²
             astro frame; timed at 4096² float32, on the bucket and on a
             10240² frame (S = 8), each beside its bound;
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
12. tiled   — ``run_tiled`` of the paper's 10240² frame: ``AstroImage(0,
             10240)`` as a tile provider through ``PHEngine(MAIN_CONFIG,
             tile=TileSpec())`` (auto grid (10, 10) of 1024² tiles, the
             threshold from ``provider_threshold``): regrow chain,
             best-edge launches (> 0), peak device memory; ``stage_tiles``
             then ``run_tiled`` (steady), stage device times (per-tile A+B,
             ring table, seam merge); every diagram field equal to ``run``
             of the frame phase 3 rendered, at the same threshold; the seam
             merge's first Boruvka round held to the plain version
             bitwise and timed beside its bound and ``scatter_reduce_``;
13. delta   — ``run_delta`` over ``FrameSequence(0, 10240, grid=(10, 10),
             dirty_frac=0.05)`` (its base the same frame), frames 0, 1, 2
             and 2 again at that threshold: miss, partial (the frame's
             ``dirty_tiles``), partial, full hit, each equal to a cold
             ``run_tiled`` bitwise; wall ms per frame, the hash apart;
14. flash_attention — the flash attention kernel against its plain version
             (``FLASH_CASES``: GQA, MQA, MHA, windows, non-causal, ragged
             Sq != Skv, rows that see no key, hd 64/128/256, the edges of
             the kernel's tiles; lm_families' shapes: whisper's ragged
             non-causal 1500 keys and 224 x 1500 cross-attention,
             recurrentgemma's MQA 10/1 at hd 256 with a 2048 window) in
             float32 and bfloat16 at ``FLASH_TOL``, then at the main
             path's shapes (``FLASH_MAIN_SHAPES``, ``FLASH_FAMILY_CALLS``:
             strided views as the model passes them, in the dtype each
             runs in), and at query offsets (``FLASH_OFFSET_CASES``: a
             rank's block of the query rows, ragged and windowed, in both
             types; the last timed); the counts of wgmma and TMA
             instructions in its SASS (cuobjdump); timed at the LM
             prefill's shape and at
             whisper's float32 encoder call beside their bounds, in turns
             with ``scaled_dot_product_attention``;
15. lm_serve — ``serve`` of mistral_nemo_12b at full width and depth (random
             weights drawn on the card from seed 0): 4 prompts of 1024
             tokens, 32 greedy tokens; one flash launch per layer; the
             last layer's flash call of a prefill against the plain
             version at ``FLASH_TOL``; the prefill's logits against a run
             through the plain attention, and teacher-forced
             ``decode_step`` logits against one full-sequence forward, at
             ``LOGIT_ATOL``/``LOGIT_RTOL``, which a control (one KV tile
             hidden) must fail; one prefill and one decode step under
             ``torch.profiler`` (device busy ms by kind, idle share);
16. lm_forward — ``Model.loss_fn`` forward at 2 x 2048 tokens: 40 flash
             launches, the loss equal to the plain-attention run's within
             ``LOSS_ATOL``, which the hidden-tile control must miss;
16b. lm_moe — the mixture-of-experts decoders at their published width,
             depth cut to fit the card (``MOE_DEPTH``: llama4 scout 12 of
             48 layers, dbrx 8 of 40; random weights drawn on the card
             from seed 0, the float32 router among them): ``serve`` as in
             lm_serve with one flash launch per layer of the prefill and
             nothing else, the depth and peak memory; the prefill's last
             flash call (GQA 40/8, 48/8) against the plain version; logits
             at ``MOE_POSITIONS`` of the kernel route against the plain
             route, held on the rows whose tokens took the same experts
             and kept the same pairs in every layer (the hidden-tile
             control must fail there), with each layer's share of routes
             that agree; teacher-forced ``decode_step`` against one
             full-sequence forward at capacity factor E/k, where nothing
             drops (the published 1.25 drops other tokens in the two:
             read, not held), and the drop shares of prefill and decode
             at 1.25; a prefill and a decode step under ``torch.profiler``
             (GEMM, flash, sort/scatter/gather, the rest, idle share);
             ``loss_fn`` at 2 x 2048 with its aux, finite;
16c. lm_families — whisper_small, recurrentgemma_2b, rwkv6_3b and
             phi3_mini_3_8b at their published width and depth
             (``LM_FAMILIES``; bfloat16 weights drawn on the card from
             seed 0): ``serve`` with 36, 8, 0 and 0 flash launches per
             prefill and nothing else (whisper's float32 frames: its
             encoder and cross-attention calls run the kernel's float32
             path); the prefill's flash calls of ``FAMILY_HELD_CALLS``
             against the plain version; the prompt's logits (every 64th
             position and the prefill's last) of the kernel route against
             the plain route, with the hidden-tile control
             (``FAMILY_CONTROL_KEYS``); teacher-forced ``decode_step``
             against one full-sequence forward in ``FAMILY_LIMITS``'
             dtype (rwkv6 and recurrentgemma on the same weights widened
             to float32; read in bfloat16 too), whose control must fail
             (rwkv6: the WKV state zeroed at ``WKV_CONTROL_AT``; the
             others: a hidden tile); ``wkv_chunked`` against ``wkv_scan``
             on one layer's inputs at ``WKV_TOL``, the recurrences timed
             alone; a prefill and a decode step under ``torch.profiler``
             (the recurrences' non-GEMM work as its own kind);
17. pipeline — ``run_distributed`` (the paper's Variant 1-3 job) over a
             survey of astro frames: ids 0-15 at sizes cycling 1024, 2048,
             4096, 2048 and id 16 at ``PIPELINE_TILED``² routed tiled by
             ``TileSpec(max_tile_pixels=4096 * 4096)``, ``filter_std``,
             ``pow2`` buckets, Boruvka-fused, ``part_LPT``; once
             synchronous and once with ``OverlapSpec()``: phase-A and
             best-edge launches (> 0) in each run, every image's diagram
             equal to the port's own ``run`` / ``run_tiled`` at the same
             threshold and capacities; at each whole size, phase A's input
             and the first Boruvka round captured from that run and held to
             the plain versions bitwise, and the diagram to a
             ``use_pallas=False`` engine's; the tiled frame's first seam
             round likewise; the runs' summaries and diagrams equal, the
             overlap counters (no dispatch-thread sync, one upload group
             per whole round, every round resolved on the harvest thread,
             one result copy per round); a staged
             round's ``load_round`` + ``begin_staged`` under
             ``torch.cuda.set_sync_debug_mode("error")``; a one-round
             failure injection and a work-log resume equal to the clean
             run; wall ms of each run, the loader thread's host ms and the
             host ms spent in each round's compute; a result's copy to the
             host by ``start_d2h`` against ``.cpu()``, in turns;
18. serving — ``PHServer`` over the main config with buckets 1024² and
             2048², ``batch_cap`` 4 and ``OverlapSpec()``: ``warmup`` (its
             seconds, plans and each bucket's capacity tier), then 32
             windows of astro frames 0-3 at 2048² (sides 60-100 % of their
             bucket) from 4 client threads, thresholds left to the server:
             no failed future, no plan built and no regrow after warmup,
             phase-A and best-edge launches, no blocking read on the tick
             thread; every served diagram equal to ``run`` at its
             threshold, one per bucket to a ``use_pallas=False`` engine's;
             per bucket the p50/p95/p99 end-to-end and queue wait, the
             occupancy, the statistic's share of a batch, and a batch at
             the warm tier against ``run_batch`` of the same images at
             their own tier, in turns (the kernels held to their plain
             versions on the warm-tier batch); the first 8 requests
             through a synchronous harvest, equal; one tick dispatch under
             ``torch.cuda.set_sync_debug_mode("error")``; the cache tier
             over ``FrameSequence(0, 2048, grid=(4, 4))`` (a miss, a
             partial hit equal to ``run_tiled``, an exact hit resolved on
             the submit thread; the device memory it holds); and
             ``python -m repro_torch.launch.ph_serve`` as a subprocess;
18b. ph_examples — ``examples/quickstart_torch.py``,
             ``distributed_ph_torch.py`` and ``serve_ph_torch.py`` in
             process at their defaults: each finishes with phase-A and
             best-edge launches; quickstart's regrown diagram equal to
             the union-find oracle's, the distributed run's injected
             failure recovered over 12 images, every served future
             resolved with no plan built after the warmup;
19. autotune — the phase-A kernel against its plain version at strip
             heights 4 and 32 (the 4096² frame, the survey bucket, the
             stride-2 peak grids; at 4096 columns S = 32 is a 3-block
             cluster with a ragged last block) and its device time at S =
             4/8/16/32; ``autotune`` of 4096² and 2048² float32 with every
             strip height measured (model seconds against measured
             seconds and spreads, their rank correlation, the ``"cuda"``
             entries naming the card); ``autotune_grid`` of the 10240²
             frame (candidates, ``per_tile_cost`` peaks, trials); a tuned
             engine's ``run``, ``run_batch`` and ``run_tiled`` equal to
             phases 5, 9 and 12 bitwise with phase-A and best-edge
             launches (best-edge alone in ``run_tiled``), their steady
             walls in turns with an untuned engine; lookups that launch
             and write nothing; ``python -m
             repro_torch.launch.ph_distances`` as a subprocess, its
             matrices equal to ``distance_matrix`` in process;
20. lm_train — the training step of qwen1_5_0_5b at its published width
             and depth (bf16, random weights from seed 0) at 4 x 4096
             tokens (``TRAIN_SHAPE``; train_4k's rows, the batch cut from
             256): one ``train_bundle`` step through the kernel, one
             through the plain attention and one through the hidden-tile
             control on the same weights and batch (the loss before and
             after the step within ``LOSS_ATOL``, the grad norm within
             ``GRAD_NORM_RTOL``, the attention projections' first moments
             within ``MOMENT_RTOL``; those of ``TRAIN_HELD`` held, each
             failed by the control); the step's
             first and last forward flash calls and its last recompute
             call held to plain; flash launches 48 a step (``remat="full"``:
             the forward pass and the recompute; the backward is the plain
             recompute) and 24 with ``remat="none"``, the peak memory of
             each; warm step ms, tokens/s and the model-FLOPs share of the
             bf16 peak; one step under ``torch.profiler`` (GEMM, flash
             forward, attention backward, optimizer, other, idle);
             ``train`` of ``TRAIN_STEPS`` steps with a checkpoint every
             ``TRAIN_CKPT_EVERY`` into a temporary directory under
             ``build/`` (the last checkpoint bitwise equal to the trained
             weights; an asynchronous save unmoved by the in-place update
             that follows it), then resumed from the first checkpoint,
             its losses within ``LOSS_ATOL`` of the uninterrupted run's;
             mistral_nemo_12b at full width and ``TRAIN_GQA``'s 4 layers
             (GQA 32/8, hd 128), 2 x 2048, kernel vs plain vs control as
             above, the grad norm and moments held (8 flash launches a
             step); ``examples/train_lm_torch.py``
             (150 steps, the last loss below the first); the temporary
             directory removed;
21. lm_mesh — the LM on a (1, 1) ("data", "model") mesh of one NCCL rank
             (``launch/mesh.py``): an all-reduce, all_to_all and
             all-gather on the group (data unchanged, NCCL kernels
             counted); ``TRAIN_ARCH`` at ``TRAIN_SHAPE``,
             ``MESH_TRAIN_STEPS`` steps of the sharded ``train_bundle``
             (parameters and moments DTensors placed by the sharding
             rules) in turns with the unsharded one from the same weights
             and batches: loss and grad norm within ``LOSS_ATOL`` and
             ``GRAD_NORM_RTOL`` (their differences printed), 48 flash
             launches a step each way, step ms both ways, the peak memory,
             one more step each way under the profiler (wall and busy ms,
             host ops, the host ops the sharded step adds most to) and
             its NCCL kernels; dbrx at
             ``MOE_DEPTH``'s 8 layers: a greedy prefill (the all_to_all
             path, one flash call a layer) and decode steps (the psum
             path, no flash call) against the caches ``cache_specs``
             splits along the sequence, tokens equal and logits within
             ``LOGIT_ATOL``/``LOGIT_RTOL`` of the same without the mesh,
             NCCL kernels from the profile;
             rwkv6_3b, recurrentgemma_2b and whisper_small at full width
             and depth (``MESH_FAMILIES``): a greedy prefill and
             ``MESH_SERVE``'s decode steps on the mesh against the same
             without it (tokens equal, logits within the limit of
             ``FAMILY_LIMITS``' decode dtype: the recurrent two on
             float32 copies, their bfloat16 runs read at ``LOGIT_ATOL``/
             ``LOGIT_RTOL``), the prefill's flash launches (0, 8, 36) on
             and off the mesh, none in the decode steps, the first and
             last mesh flash call held to plain, prefill and
             decode-step ms and peak memory both ways;
             whisper_small's sharded ``train_bundle`` step in turns with
             the unsharded one (``MESH_TRAIN_FAMILY``; loss and grad norm
             as above, 72 flash launches a step each way); after these
             timed runs, ``launch/dryrun.py``'s estimate of the qwen train
             cell on a fake one-rank group (its own process, on the host)
             beside the measured peak.

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

import functools
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# The card's rates (H100 SXM data sheet) live with the port's cost model.
from repro_torch.roofline.analysis import (  # noqa: E402
    FP32_FLOPS as FP32_OPS_PER_S, HBM_BW as HBM_BYTES_PER_S,
    PEAK_FLOPS as BF16_OPS_PER_S)

MAIN_SIZE = 4096
# A width of the paper's 10240² frames: phase A's strips of it at S = 8
# take the kernel's cluster regime.
PHASE_A_WIDE = 10240
# The tiled and delta phases' frame: the paper's 10240² (image 0, which
# phase 3 renders); TileSpec()'s budget of 1 << 20 pixels a tile gives a
# (10, 10) grid of 1024² tiles.
TILED_SIZE = PHASE_A_WIDE
TILED_GRID = (10, 10)
# The delta phase's survey stream: frames 0, 1 and 2, then 2 again, each
# later frame adding transients to 5 % of the tiles.
DELTA_FRAMES = (0, 1, 2, 2)
DELTA_DIRTY_FRAC = 0.05
BATCH_SIZE = 2048
ORACLE_SIZE = 256
# The survey batch of the mixed_batch phase: (h, w) windows of 2048² frames.
MIXED_SHAPES = ((2048, 2048), (2048, 1536), (1536, 1536), (1024, 2048),
                (1000, 1800))
N_DIRS = 16
# The main path's engine configuration (phases 5-10).
MAIN_CONFIG = dict(merge_impl="boruvka", phase_c_impl="fused",
                   filter_level="filter_std")
# The pipeline phase's survey: ids 0-15 at sizes cycling PIPELINE_SIZES,
# then one PIPELINE_TILED² frame above the tile budget (a tiled round of
# 4096² tiles).
PIPELINE_SIZES = (1024, 2048, 4096, 2048)
PIPELINE_WHOLE = 16
PIPELINE_TILED = 8192
PIPELINE_TILE_PIXELS = 4096 * 4096
PIPELINE_FAIL_ROUND = 3         # dispatch sequence number that fails once
# The serving phase: a daemon with buckets 1024² and 2048² (its warm tier
# is the checkerboard's, 7-8 doublings from 8192 features at 2048²) and a
# fixed dispatch batch of 4; a survey load of 32 windows of astro frames
# 0-3 at 2048², sides 60-100 % of their bucket, from 4 client threads.
SERVE_BUCKETS = (1024, 2048)
SERVE_CAP = 4
SERVE_FRAMES = 4
SERVE_REQUESTS = 32
SERVE_CLIENTS = 4
SERVE_ASYNC_CHECK = 8           # requests also served with a sync harvest
SERVE_TIER_GRID = (4, 4)        # the cache tier's tiles over 2048² frames
SERVE_CLI = ("--buckets", "64", "128", "--clients", "4", "--requests", "16",
             "--merge-impl", "boruvka")
# The autotune phase: the strip heights phase 3's cases did not reach, the
# trials per measured candidate (every candidate of both searches is
# measured; a 4096² call takes ~12 ms, so 10 trials cost ~1 s a search),
# and the ph_distances CLI's frames.
AUTOTUNE_STRIPS = (4, 32)
AUTOTUNE_TRIALS = 10
AUTOTUNE_GRID_TRIALS = 5       # a 10240² tiled call is ~0.15 s
DIST_CLI_IMAGES = 6
DIST_CLI_SIZE = 1024
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
               (1, 4, 2, 256, 256, 256, True, 70),
               # lm_families at batch 1: whisper's encoder (ragged 1500,
               # non-causal), cross-attention (224 queries over 1500
               # keys) and decoder self-attention; recurrentgemma's local
               # attention (MQA 10/1, hd 256, window 2048, 3072 tokens).
               (1, 12, 12, 1500, 1500, 64, False, None),
               (1, 12, 12, 224, 1500, 64, False, None),
               (1, 12, 12, 224, 224, 64, True, None),
               (1, 10, 1, 3072, 3072, 256, True, 2048))
# The working type's tolerance (atol = rtol), as the reference's kernel
# test states it; float32 compares without TF32.
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# The main path's own shapes (B, H, KV, S, hd), causal bfloat16, held to the
# plain version element by element: lm_serve's prefill (the timed shape),
# lm_forward's, and lm_moe's prefills (GQA 40/8 and 48/8, group ratios 5
# and 6).  q, k, v are (B, H, S, hd) views of (B, S, H, hd) tensors, as
# the model passes them.
FLASH_SHAPE = (4, 32, 8, 1024, 128)
FLASH_MAIN_SHAPES = (FLASH_SHAPE, (2, 32, 8, 2048, 128),
                     (4, 40, 8, 1024, 128), (4, 48, 8, 1024, 128))
# lm_families' own calls at its serve batch, on (B, S, heads, hd) views as
# the model passes them, in the dtype each runs in (dtype, B, H, KV, Sq,
# Skv, hd, causal, window): whisper's encoder and cross-attention in
# float32 (the frames are float32), its first decoder self-attention in
# bfloat16 and the later ones in float32; recurrentgemma's bfloat16.
FLASH_FAMILY_CALLS = (("float32", 4, 12, 12, 1500, 1500, 64, False, None),
                      ("float32", 4, 12, 12, 224, 1500, 64, False, None),
                      ("bfloat16", 4, 12, 12, 224, 224, 64, True, None),
                      ("float32", 4, 12, 12, 224, 224, 64, True, None),
                      ("bfloat16", 4, 10, 1, 3072, 3072, 256, True, 2048))
# The whisper encoder's call, timed beside its bound and SDPA: (B, H, S,
# hd), float32, non-causal.
FLASH_ENCODER_SHAPE = (4, 12, 1500, 64)
# Head dims the kernel does not take (B, H, KV, S, hd): the op routes them
# to the plain version by shape (phi3's 96, the smoke configs' 16) and
# launches nothing; the kernel called directly refuses them.
FLASH_PLAIN_ROUTE = ((2, 32, 8, 300, 96), (2, 4, 2, 64, 16))
# The query offset (B, H, KV, Sq, Skv, hd, causal, window, q_offset): a
# rank's block of the query rows on a mesh whose model axis splits the
# sequence (the rows at positions q_offset ..), ragged and windowed, then
# the timed case, lm_serve's prefill shape split two ways (the second
# half of 1024 query rows).
FLASH_OFFSET_CASES = ((1, 4, 2, 64, 256, 64, True, None, 192),
                      (2, 8, 2, 128, 512, 128, True, None, 384),
                      (1, 4, 1, 100, 300, 256, True, None, 150),
                      (1, 4, 2, 128, 512, 128, True, 70, 300),
                      (1, 4, 2, 130, 260, 64, True, 100, 130),
                      (1, 2, 2, 64, 128, 128, False, None, 64),
                      (4, 32, 8, 512, 1024, 128, True, None, 512))
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
# lm_moe: the two MoE decoders at their published width, their depth cut
# so that one 80 GB card holds the bfloat16 weights beside the KV caches,
# the float32 head and the expert buffers (layers; the configs have 48
# and 40).
MOE_DEPTH = {"llama4_scout_17b_a16e": 12, "dbrx_132b": 8}
# The prompt positions whose logits lm_moe holds kernel route against
# plain route: every 64th token of each prompt, the last included.
MOE_POSITIONS = tuple(range(63, LM_SERVE["prompt_len"], 64))
# lm_families: the four architectures of the RWKV-6, RG-LRU, encoder-decoder
# and head-dim-96 paths at their published width and depth (bfloat16,
# random weights drawn on the card from seed 0): each one's serve shape and
# the flash launches of one prefill (whisper: 12 encoder, 12 decoder self-
# and 12 cross-attention calls; recurrentgemma: its 8 local-attention
# layers, the prompt longer than the 2048 window so the ring caches wrap;
# rwkv6 has no attention; phi3's head dim 96 takes the plain route).
LM_FAMILIES = {
    "whisper_small": (dict(batch=4, prompt_len=224, gen_len=32,
                           max_len=256), 36),
    "recurrentgemma_2b": (dict(batch=4, prompt_len=3072, gen_len=32,
                               max_len=3104), 8),
    "rwkv6_3b": (dict(batch=4, prompt_len=1024, gen_len=32, max_len=1056),
                 0),
    "phi3_mini_3_8b": (dict(batch=4, prompt_len=1024, gen_len=32,
                            max_len=2048), 0),
}
# The prefill's flash calls held to the plain version, by call index:
# whisper's encoder's last and its last cross-attention.
FAMILY_HELD_CALLS = {"whisper_small": {"encoder_last": 11, "cross_last": 35},
                     "recurrentgemma_2b": {"last": -1}}
# The 64-key tile the hidden-tile control hides, (for the prompt's logits,
# for teacher-forced decode), where it is not CONTROL_KEYS: whisper's
# prompt (224) ends before that tile, so its control hides the third
# (seen by the decoder's later prompt queries and by every encoder and
# cross-attention query); recurrentgemma's decode rows see only the last
# 2048 keys, so their control hides a tile inside that window.
FAMILY_CONTROL_KEYS = {
    "whisper_small": (slice(128, 192), slice(128, 192)),
    "recurrentgemma_2b": (CONTROL_KEYS, slice(2560, 2624))}
# The logit limits (atol, rtol) of each family's checks: the prompt's
# logits, kernel route against plain route; teacher-forced decode against
# the full sequence, in the dtype named (the served bfloat16, or the same
# weights widened to float32).  Each limit lies between the sound reading
# and its control's (PERF.md gives both).  Two checks are held in float32:
# rwkv6's bfloat16 stream turns the two WKV forms' float32 rounding into
# logit differences of 12 times LOGIT_ATOL (its full forward with the scan
# form reads the same against the chunked form), and in recurrentgemma's
# bfloat16 stream a hidden tile moves the decode rows' logits no more than
# rounding does (both are read in bfloat16 as well).
FAMILY_LIMITS = {
    "whisper_small": {"prompt": (LOGIT_ATOL, LOGIT_RTOL),
                      "decode": ("bfloat16", LOGIT_ATOL, LOGIT_RTOL)},
    "recurrentgemma_2b": {"prompt": (LOGIT_ATOL, LOGIT_RTOL),
                          "decode": ("float32", 1e-3, 1e-3)},
    "rwkv6_3b": {"decode": ("float32", LOGIT_ATOL, LOGIT_RTOL)},
    "phi3_mini_3_8b": {"decode": ("bfloat16", LOGIT_ATOL, LOGIT_RTOL)},
}
# rwkv6's control: every layer's WKV state zeroed at this token (a chunk
# boundary: the prompt's end) in the full-sequence forward.
WKV_CONTROL_AT = 1024
# wkv_chunked against wkv_scan on one layer's inputs, widened to float32,
# relative to the largest output element, as tests/test_torch_recurrent.py
# holds them (the two forms order their sums differently).
WKV_TOL = 1e-5
# lm_train: the training step of qwen1_5_0_5b at its published width and
# depth (bfloat16, random weights drawn on the card from seed 0), at
# train_4k's 4096 tokens a row and a global batch cut from 256 to 4 to fit
# one card; ``train`` runs TRAIN_STEPS steps with a checkpoint every
# TRAIN_CKPT_EVERY, then resumes from the first checkpoint.
TRAIN_ARCH = "qwen1_5_0_5b"
TRAIN_SHAPE = dict(seq_len=4096, global_batch=4)
TRAIN_STEPS = 6
TRAIN_CKPT_EVERY = 3
# GQA and head dim 128 in training: mistral_nemo_12b at full width, 4 of
# its 40 layers (weights, grads and moments ~29 GB), 2 x 2048 tokens.
TRAIN_GQA = ("mistral_nemo_12b", 4, dict(seq_len=2048, global_batch=2))
# One train step through the kernel against one through the plain
# attention, same weights and batch, read four ways: the loss before the
# step and after it (within LOSS_ATOL), the gradient's global norm (within
# GRAD_NORM_RTOL of the plain run's) and the first moments the step leaves
# in the attention projections' (wq, wk, wv, wo) optimizer state, 0.1 of
# their clipped gradients (relative L2 within MOMENT_RTOL).  TRAIN_HELD
# names the readings each model holds, where the hidden-tile control must
# fail: at mistral's 4 of 40 layers the random-weight loss barely depends
# on attention (the control moved it 1.7e-5, the kernel's rounding 2.2e-4),
# so its losses are read, not held.  Each limit lies between the kernel's
# reading and the control's (PERF.md gives both).
GRAD_NORM_RTOL = 1e-3
MOMENT_RTOL = 0.05
TRAIN_HELD = {"qwen1_5_0_5b": ("loss", "loss_after", "grad_norm",
                               "attention_moments"),
              "mistral_nemo_12b": ("grad_norm", "attention_moments")}
# examples/train_lm_torch.py on the card: its own defaults.
TRAIN_EXAMPLE_ARGS = ()
# lm_mesh: the LM steps on a (1, 1) ("data", "model") mesh of one NCCL
# rank.  Training: TRAIN_ARCH at TRAIN_SHAPE, MESH_TRAIN_STEPS steps of the
# sharded train_bundle in turns with the unsharded one, from the same
# weights and batches.  Serving: dbrx at MOE_DEPTH's depth, a prefill
# (the all_to_all path) and greedy decode steps (the psum path, against
# the caches split along the sequence) on the mesh against the same
# without it.
MESH_TRAIN_STEPS = 3
MESH_PROFILE_TOP = 12       # host ops listed from a profiled mesh step
MESH_SERVE_ARCH = "dbrx_132b"
MESH_SERVE = dict(batch=4, prompt_len=512, gen_len=8, max_len=1024)
# lm_mesh's families: the recurrent decoders and the encoder-decoder at
# their published width and depth (bfloat16, weights drawn on the card
# from seed 0), a greedy prefill and MESH_SERVE's decode steps on the mesh
# against the same without it, and the flash launches of one prefill
# (recurrentgemma's 8 local-attention layers, whisper's 36 calls, none in
# rwkv6) and of the decode steps (none).  Each is held in FAMILY_LIMITS'
# decode dtype at the limit it gives that dtype: rwkv6 and recurrentgemma
# on float32 copies of the weights (their bfloat16 runs are read beside,
# at LOGIT_ATOL/LOGIT_RTOL).
MESH_FAMILIES = {"rwkv6_3b": 0, "recurrentgemma_2b": 8, "whisper_small": 36}
# whisper_small's sharded train_bundle step in turns with the unsharded
# one: its decoder's 448-token context (the published model's), a global
# batch of 4, each from seed 0's weights.  One step: the bfloat16
# gradients of the tied embedding sum its lookup's and the head's parts in
# another order on the mesh (grad norm 3.7e-4 apart), which Adam then
# carries into the next step's loss.
MESH_TRAIN_FAMILY = ("whisper_small", dict(seq_len=448, global_batch=4), 1)
# Profiler ranges of a train step's attention backward (the plain
# recompute and its gradient) and optimizer update, by kind.
TRAIN_RANGES = {"lm_train.attention_backward": "attention_backward",
                "lm_train.optimizer": "optimizer"}
# The design of each kernel.
DESIGN = {"ph_phase_a": "one launch per strip: a 16-byte-vector stencil, "
                        "16-bit pointers and an escape table in shared "
                        "memory; wider strips over a cluster's distributed "
                        "shared memory",
          "maxpool3x3": "tiled separable 3x3, 16-byte vectors",
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


def to_device(img, dtype, dev):
    """A numpy image as a contiguous ``dtype`` tensor on ``dev`` (uint8
    takes the clipped magnitude)."""
    import numpy as np
    import torch
    if dtype == torch.uint8:
        img = np.clip(np.abs(img), 0, 255)
    t = torch.from_numpy(np.ascontiguousarray(img).astype(np.float32))
    return t.to(dtype).to(dev).contiguous()


def survey_bucket(dev):
    """The mixed_batch phase's one dispatch as phase A sees it: the
    distinct survey frames padded with the superlevel fill (-inf) into
    one (5, 2048, 2048) float32 bucket."""
    import torch
    from repro_torch.pipeline.padding import pad_image
    frames = survey_frames()[:len(MIXED_SHAPES)]
    return torch.stack([pad_image(torch.from_numpy(f),
                                  (BATCH_SIZE, BATCH_SIZE))
                        for f in frames]).to(dev)


def phase_a_bound_ms(x) -> float:
    """Phase A's least time on the card: the image read once, ptr and mask
    (int32) written once, at the device memory rate."""
    return x.numel() * (x.element_size() + 8) / HBM_BYTES_PER_S * 1e3


def column_ramp(h: int, w: int, s: int):
    """The deepest in-strip chains: values step up by 2s a column, and
    within a column fall off from each strip's middle row, so every ascent
    runs to that row and along it to the right edge (a chain of w pixels;
    exact in float32 and int32 below 2^24)."""
    import numpy as np
    r, c = np.mgrid[:h, :w]
    return (c * 2 * s - np.abs(r % s - s // 2)).astype(np.float64)


def check_phase_a(x, s: int, label: str, err) -> None:
    """The phase-A kernel against its plain version on ``x``, bitwise."""
    import torch
    from repro_torch.kernels.ph_phase_a import kernel as ka
    from repro_torch.kernels.ph_phase_a import ref as ra
    p_k, m_k = ka.phase_a(x, strip_rows=s)
    p_r, m_r = ra.phase_a(x, strip_rows=s)
    err["ph_phase_a"] = max(err["ph_phase_a"], max_abs_diff(p_k, p_r),
                            max_abs_diff(m_k, m_r))
    if not (torch.equal(p_k, p_r) and torch.equal(m_k, m_r)):
        bad = int((p_k != p_r).sum() + (m_k != m_r).sum())
        raise AssertionError(f"phase_a kernel != plain on {label} "
                             f"(S={s}): {bad} differing entries")


def phase_a_cases(dev, rng, err) -> int:
    """The phase-A kernel against its plain version, bitwise: the five
    dtypes on small and degenerate shapes at strip heights 1/8/16, ramps
    and constant images; then each width regime and its edges (S * W =
    65,536 and one column either side, the widest strip a cluster holds
    and one column more, widths 10240 and 16384) at S = 8 and 16, with
    ragged last strips, column ramps, signed zeros, NaN pixels, uint8
    zeros at the borders and views whose base is not 16-byte aligned; a
    bfloat16 tie storm, batches; the mixed batch's (5, 2048, 2048) bucket
    with its fill padding, the 4096² astro frame and the stride-2 peak
    grids at 4096² and 2048² at strip heights 1/4/8/16/32 (S = 32 at 4096
    columns: a 3-block cluster with a ragged last block).  Returns the
    count."""
    import numpy as np
    import torch

    from repro_torch.data import astro
    from repro_torch.kernels.ph_phase_a import kernel as ka

    dtypes = (torch.uint8, torch.int16, torch.int32, torch.float32,
              torch.bfloat16)
    n = 0

    def check(img, dt, s, label):
        nonlocal n
        x = img if isinstance(img, torch.Tensor) else to_device(img, dt, dev)
        check_phase_a(x, s, f"{label}/{x.dtype}", err)
        n += 1

    def signed_zeros(shape, dt):
        z = rng.choice([0.0, -0.0, 1.0, -1.0], size=shape).astype(np.float32)
        return torch.from_numpy(z).to(dt).to(dev)

    for dt in dtypes:
        for shape in ((37, 53), (64, 64), (1, 29), (29, 1), (1, 1)):
            gauss = rng.normal(size=shape) * 40
            ties = rng.integers(0, 3, size=shape).astype(np.float64)
            for kind, img in (("gauss", gauss), ("ties", ties)):
                for s in (1, 8, 16):
                    check(img, dt, s, f"{kind}{shape}")
        ramp = np.tile(np.arange(4096, dtype=np.float64) % 200, (24, 1))
        check(ramp, dt, 8, "ramp")
        check(np.full((33, 65), 7.0), dt, 8, "const")
    check(np.tile(np.arange(8192, dtype=np.float64), (20, 1)),
          torch.float32, 8, "wide ramp 20x8192")
    check(to_device(rng.normal(size=(3, 45, 70)) * 9, torch.bfloat16, dev),
          None, 8, "batch (3, 45, 70)")

    # Each width regime and its edges, at S = 8 and 16.
    for s in (8, 16):
        narrow = ka.NARROW_ENTRIES // s
        cap = (ka.SMEM_BYTES - ka.STATIC_BYTES) // (
            4 * -(-s // ka.MAX_CLUSTER))
        if (ka.strip_layout(s, narrow)[0], ka.strip_layout(s, narrow + 1)[0],
                ka.strip_layout(s, cap), ka.strip_layout(s, cap + 1)[0]) != (
                "shared16", "cluster", ("cluster", ka.MAX_CLUSTER), "global"):
            raise AssertionError(f"unexpected regime edges at S={s}")
        for w in (narrow - 1, narrow, narrow + 1, 10240, 16384):
            h = 2 * s + 3                       # a ragged last strip
            for dt in dtypes:
                check(rng.normal(size=(h, w)) * 40, dt, s, f"gauss({h}, {w})")
            check(rng.integers(0, 3, size=(h, w)).astype(np.float64),
                  torch.float32, s, f"ties({h}, {w})")
            check(column_ramp(h, w, s), torch.float32, s,
                  f"column ramp({h}, {w})")
            nans = rng.normal(size=(h, w)) * 40
            nans[rng.random((h, w)) < 0.1] = np.nan
            for dt in (torch.float32, torch.bfloat16):
                check(signed_zeros((h, w), dt), None, s,
                      f"signed zeros({h}, {w})")
                check(nans, dt, s, f"NaN pixels({h}, {w})")
            zeros = np.zeros((h, w))
            zeros[h // 2, w // 2] = 1.0
            check(zeros, torch.uint8, s, f"zeros with one peak({h}, {w})")
            flat = to_device(rng.normal(size=1 + h * w) * 40, torch.float32,
                             dev)
            check(flat[1:].view(h, w), None, s, f"unaligned view({h}, {w})")
        for w in (cap, cap + 1):               # the widest cluster, one more
            h = s + 1
            check(rng.normal(size=(h, w)) * 40, torch.float32, s,
                  f"gauss({h}, {w})")
            check(column_ramp(h, w, s), torch.int32, s,
                  f"column ramp({h}, {w})")
            check(rng.integers(0, 3, size=(h, w)).astype(np.float64),
                  torch.uint8, s, f"ties({h}, {w})")
    storm = to_device(rng.integers(0, 3, size=(3, 2048, 2048))
                      .astype(np.float64), torch.bfloat16, dev)
    check(storm, None, 8, "bf16 tie storm (3, 2048, 2048)")
    check(to_device(rng.normal(size=(2, 17, 8193)) * 9, torch.int16, dev),
          None, 8, "batch (2, 17, 8193)")
    x_main = torch.from_numpy(astro.generate_image(0, MAIN_SIZE)).to(dev)
    for label, x in tuned_strip_inputs(dev, x_main):
        for s in (1, 8, 16) + AUTOTUNE_STRIPS:
            check(x, None, s, label)
    return n


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
    from repro_torch.kernels.flash_attention import ops as fa_ops
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
    family_errs = []
    for name, b, h, kv, sq, skv, hd, causal, window in FLASH_FAMILY_CALLS:
        q, k, v = (torch.randn(b, s, n, hd, device=dev).to(dtypes[name])
                   .transpose(1, 2) for s, n in ((sq, h), (skv, kv),
                                                 (skv, kv)))
        got = kfa.flash_attention_fwd(q, k, v, causal=causal, window=window)
        want = rfa.attention(q, k, v, causal=causal, window=window)
        family_errs.append(max_abs_diff(got, want))
        tol = FLASH_TOL[name]
        errs[name] = max(errs[name], family_errs[-1])
        if not torch.allclose(got.float(), want.float(), atol=tol, rtol=tol):
            raise AssertionError(f"flash kernel != plain at lm_families' "
                                 f"call {(name, b, h, kv, sq, skv, hd)}: max "
                                 f"|diff| {family_errs[-1]} over {tol}")
        del got, want
    offset_errs = {}
    for name, dt in dtypes.items():
        tol, offset_errs[name] = FLASH_TOL[name], 0.0
        for case in FLASH_OFFSET_CASES:
            b, h, kv, sq, skv, hd, causal, window, off = case
            q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(
                "float32")).to(dt).to(dev) for shape in
                ((b, h, sq, hd), (b, kv, skv, hd), (b, kv, skv, hd)))
            got = kfa.flash_attention_fwd(q, k, v, causal=causal,
                                          window=window, q_offset=off)
            want = rfa.attention(q, k, v, causal=causal, window=window,
                                 q_offset=off)
            offset_errs[name] = max(offset_errs[name],
                                    max_abs_diff(got, want))
            if not torch.allclose(got.float(), want.float(), atol=tol,
                                  rtol=tol):
                raise AssertionError(
                    f"flash kernel != plain at q_offset ({name}, {case}): "
                    f"max |diff| {max_abs_diff(got, want)} over {tol}")
        errs[name] = max(errs[name], offset_errs[name])
    b, h, kv, sq, skv, hd, _, _, off = FLASH_OFFSET_CASES[-1]
    q, k, v = (torch.randn(b, s_, n, hd, device=dev, dtype=torch.bfloat16)
               .transpose(1, 2) for s_, n in ((sq, h), (skv, kv), (skv, kv)))
    offset_timed = {
        "shape": [b, h, kv, sq, skv, hd], "q_offset": off,
        "ms": cuda_ms(lambda: kfa.flash_attention_fwd(
            q, k, v, causal=True, q_offset=off)),
        "device_ms": device_ms(lambda: kfa.flash_attention_fwd(
            q, k, v, causal=True, q_offset=off)),
        "plain_ms": cuda_ms(lambda: rfa.attention(
            q, k, v, causal=True, q_offset=off), reps=3)}
    err["flash_attention"] = max(errs.values())

    plain_route = []
    for shape in FLASH_PLAIN_ROUTE:
        q, k, v = views(*shape)
        before = kfa.LIBRARY.launches
        got = fa_ops.flash_attention(q, k, v, True, None)
        launched = kfa.LIBRARY.launches - before
        if launched or fa_ops.kernel_route(q) or not torch.equal(
                got, rfa.attention(q, k, v, causal=True)):
            raise AssertionError(f"the op at head dim {shape[-1]} did not "
                                 f"take the plain route ({launched} flash "
                                 f"launches)")
        try:
            kfa.flash_attention_fwd(q, k, v, causal=True)
        except ValueError:
            pass
        else:
            raise AssertionError(f"the kernel took head dim {shape[-1]}")
        plain_route.append({"shape": list(shape), "launches": launched,
                            "equal_to_plain": True, "kernel_refuses": True})

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
    encoder = flash_encoder_timing(dev)
    emit("flash_attention", cases=len(FLASH_CASES) * len(dtypes),
         tolerance=FLASH_TOL, max_abs_err=errs,
         main_shapes=[list(t) for t in FLASH_MAIN_SHAPES],
         main_shape_max_abs_err=main_errs,
         family_calls=[list(c) for c in FLASH_FAMILY_CALLS],
         family_max_abs_err=family_errs, plain_route=plain_route,
         offset_cases=[list(c) for c in FLASH_OFFSET_CASES],
         offset_max_abs_err=offset_errs, offset_timed=offset_timed,
         timed_shape=list(
             FLASH_SHAPE), timed_dtype="bfloat16", causal=True,
         kernel_ms=ms, device_ms=timed["device_ms"], plain_ms=plain_ms,
         library_ms_sdpa=lib_ms,
         library_device_ms=timed["library_device_ms"],
         turns_ms=timed["turns_ms"], turns_device_ms=timed["turns_device_ms"],
         flop=ops, bytes=nbytes, bound_ms=bound_ms, bound_by=bound_by,
         bound_share=bound_ms / timed["device_ms"], sass=sass,
         whisper_encoder=encoder)
    return {"ms": ms, "device_ms": timed["device_ms"], "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
            "library_device_ms": timed["library_device_ms"], "sass": sass,
            "q_offset": offset_timed,
            "whisper_encoder": {k: encoder[k] for k in (
                "shape", "dtype", "ms", "device_ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms", "library_device_ms")}}


def flash_encoder_timing(dev) -> dict:
    """The flash kernel at whisper's encoder call (``FLASH_ENCODER_SHAPE``,
    float32, non-causal, (B, S, H, hd) views), in turns with
    ``scaled_dot_product_attention`` on the same inputs, beside its bound:
    the two products over every (q, k) pair at the float32 rate outside
    the tensor cores (the kernel's float32 path is scalar FMAs), and q, k,
    v read once and o written once."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as kfa
    from repro_torch.kernels.flash_attention import ref as rfa

    b, h, s, hd = FLASH_ENCODER_SHAPE
    q, k, v = (torch.randn(b, s, h, hd, device=dev).transpose(1, 2)
               for _ in range(3))
    timed = in_turns(
        lambda: kfa.flash_attention_fwd(q, k, v, causal=False),
        lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v))
    plain_ms = cuda_ms(lambda: rfa.attention(q, k, v, causal=False), reps=3)
    ops = 4 * b * h * hd * s * s
    nbytes = 4 * b * h * s * hd * 4
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {"shape": [b, h, s, hd], "dtype": "float32", "causal": False,
            "ms": timed["ms"], "device_ms": timed["device_ms"],
            "plain_ms": plain_ms, "library_ms": timed["library_ms"],
            "library_device_ms": timed["library_device_ms"],
            "turns_device_ms": timed["turns_device_ms"], "flop": ops,
            "bytes": nbytes, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "bound_share": max(ops_ms, bytes_ms) / timed["device_ms"]}


def same_diagram(a, b) -> bool:
    """Every field of two diagrams equal, bit for bit."""
    from repro_torch.core import diagram_to_numpy
    import numpy as np
    return all(np.array_equal(x, y) for x, y in
               zip(diagram_to_numpy(a), diagram_to_numpy(b)))


def stage_marks(fn):
    """``fn()`` under the program's recorder (``repro_torch.telemetry``):
    returns ``(out, {stage: ms})``, each stage span's time on its stream
    between its two CUDA events, summed over the stage's spans (they
    include the stage's waits on host readbacks).  The recorder is off
    again afterwards and keeps nothing of the call."""
    import torch
    from repro_torch import telemetry
    telemetry.reset()
    telemetry.enable()
    try:
        out = fn()
        torch.cuda.synchronize()
        spans = telemetry.snapshot()["spans"]
    finally:
        telemetry.disable()
        telemetry.reset()
    ms: dict = {}
    for s in spans:
        if s.events is not None:
            ms[s.name] = ms.get(s.name, 0.0) + s.device_ms()
    return out, ms


def wall_ms(fn):
    """``(fn(), host ms)`` around a call that ends synchronized."""
    import torch
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def phase_tiled(dev, frame, reset_counts, read_counts, err) -> dict:
    """Phase 12: ``run_tiled`` of the paper's 10240² frame.

    ``AstroImage(0, TILED_SIZE)`` (a tile provider: every halo tile is
    rendered and staged on its own) through ``PHEngine(MAIN_CONFIG,
    tile=TileSpec())``, the threshold from ``provider_threshold``: the
    regrow chain, best-edge launches (> 0), peak device memory; then
    ``stage_tiles`` + ``run_tiled`` (the steady run), the per-stage
    device times on the staged stacks, ``run`` of ``frame`` (the same
    image, rendered whole) at the same threshold, and the seam merge's
    first Boruvka round held to the plain version and timed.  Every
    diagram must equal the provider run's bitwise.
    """
    import torch
    from repro_torch.core import diagram_to_numpy, tiling
    from repro_torch.core.packed_keys import key_pad, resolve_merge_keys
    from repro_torch.data import astro
    from repro_torch.kernels.ph_phase_c import kernel as kc
    from repro_torch.kernels.ph_phase_c import ops as oc
    from repro_torch.kernels.ph_phase_c import ref as rc
    from repro_torch.ph import PHConfig, PHEngine, TileSpec

    cfg = PHConfig(**MAIN_CONFIG, tile=TileSpec())
    engine = PHEngine(cfg)
    prov = astro.AstroImage(0, TILED_SIZE)
    tv = engine.provider_threshold(prov)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    res, first_ms = wall_ms(lambda: engine.run_tiled(prov))
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    if launches["ph_phase_c"] <= 0:
        raise AssertionError(f"tiled path missed the best-edge kernel: "
                             f"{launches}")
    if res.regrow.overflow or bool(res.diagram.overflow):
        raise AssertionError("tiled path still overflows after regrow")
    if res.threshold != tv:
        raise AssertionError("run_tiled's threshold is not the provider's")
    grid = tuple(res.config.tile.grid)
    if grid != TILED_GRID:
        raise AssertionError(f"auto grid {grid} != {TILED_GRID}")
    mf = res.config.max_features
    tf = res.config.tile.max_features_per_tile
    tk = res.config.tile.max_candidates_per_tile

    # The staged path: stage once, then the steady run (memo settled).
    staged, stage_ms = wall_ms(lambda: engine.stage_tiles(prov))
    before = kc.LIBRARY.launches
    res_s, steady_ms = wall_ms(lambda: engine.run_tiled(staged, tv))
    rounds = kc.LIBRARY.launches - before
    if res_s.regrow.attempts or not same_diagram(res.diagram,
                                                 res_s.diagram):
        raise AssertionError("run_tiled of staged tiles != run_tiled of "
                             "the provider")
    _, steady2_ms = wall_ms(lambda: engine.run_tiled(staged, tv))

    # Per-stage device times of the same computation on the staged stacks.
    kw = dict(shape=staged.shape, grid=grid, max_features=mf,
              tile_max_features=tf, tile_max_candidates=tk,
              merge_keys=resolve_merge_keys(cfg.merge_keys,
                                            staged.pvals.dtype),
              phase_c_impl=cfg.phase_c_impl)
    tvt = torch.tensor(tv, dtype=torch.float32, device=dev)
    td, tiled_stage_ms = stage_marks(
        lambda: tiling.tiled_pixhomology_stacks(
            staged.pvals, staged.pgidx, tvt, **kw))
    if not same_diagram(td.diagram, res.diagram):
        raise AssertionError("staged stage-timed run differs")
    n_cand = int(td.n_tile_cands.sum())
    n_roots = int(td.n_tile_roots.sum())

    # The whole image through run() at the same threshold and diagram
    # capacity (its candidate capacity is the tiles' candidate count).
    whole = PHEngine(cfg.replace(max_features=mf,
                                 regrow_features_ceiling=mf,
                                 max_candidates=max(n_cand, 1)))
    wres, whole_ms = wall_ms(lambda: whole.run(frame, tv))
    if not same_diagram(wres.diagram, res.diagram):
        raise AssertionError(f"run_tiled != run at {TILED_SIZE}²")

    # The seam merge's first Boruvka round (its largest instance).
    captured = []
    kernel_fn = kc.best_edge_reduce

    def capture(key, ra_, rb_, nv):
        if not captured:
            captured.append((key.clone(), ra_.clone(), rb_.clone(), nv))
        return kernel_fn(key, ra_, rb_, nv)

    oc.kernel.best_edge_reduce = capture
    try:
        engine.run_tiled(staged, tv)
    finally:
        oc.kernel.best_edge_reduce = kernel_fn
    key, ra_, rb_, nv = captured[0]
    b_k, w_k = kc.best_edge_reduce(key, ra_, rb_, nv)
    b_r, w_r = rc.best_edge_reduce(key, ra_, rb_, nv)
    err["ph_phase_c"] = max(err["ph_phase_c"], max_abs_diff(b_k, b_r),
                            max_abs_diff(w_k, w_r))
    if not (torch.equal(b_k, b_r) and torch.equal(w_k, w_r)):
        raise AssertionError("best_edge kernel != plain on the seam round")
    pad = key_pad(key.dtype)
    alive = key > pad
    live = int(alive.sum())
    drop = torch.full_like(ra_, nv)
    lib_idx = torch.cat([torch.where(alive, ra_, drop),
                         torch.where(alive, rb_, drop)]).long()
    lib_src = torch.cat([key, key])
    lib_best = torch.full((nv + 1,), pad, dtype=key.dtype, device=dev)
    timed = in_turns(lambda: kc.best_edge_reduce(key, ra_, rb_, nv),
                     lambda: lib_best.scatter_reduce_(0, lib_idx, lib_src,
                                                      "amax"))
    kb = key.element_size()
    bound_ms = (key.numel() * kb + live * 8 + nv * (kb + 4)) \
        / HBM_BYTES_PER_S * 1e3
    seam = dict(edges=key.numel(), live_edges=live, nv=nv,
                key_dtype=str(key.dtype), ms=timed["ms"],
                device_ms=timed["device_ms"],
                plain_ms=cuda_ms(lambda: rc.best_edge_reduce(
                    key, ra_, rb_, nv)),
                library_ms=timed["library_ms"],
                library_device_ms=timed["library_device_ms"],
                turns_device_ms=timed["turns_device_ms"], bound_ms=bound_ms,
                bound_share=bound_ms / timed["device_ms"],
                bitwise_equal=True)
    whole_attempts = wres.regrow.attempts
    del staged, td, wres
    torch.cuda.empty_cache()
    emit("tiled", shape=[TILED_SIZE] * 2, grid=list(grid),
         config=json.loads(cfg.to_json()), threshold=tv,
         count=int(res.diagram.count),
         n_unmerged=int(res.diagram.n_unmerged), tile_roots=n_roots,
         tile_candidates=n_cand, final_max_features=mf,
         final_tile_max_features=tf, final_tile_max_candidates=tk,
         regrow_attempts=res.regrow.attempts,
         regrow_log=[[list(r["from"]), list(r["to"])]
                     for r in engine.regrow_log],
         first_call_ms=first_ms, stage_tiles_ms=stage_ms,
         steady_wall_ms=steady_ms, steady_wall_ms_again=steady2_ms,
         stage_ms=tiled_stage_ms, whole_run_ms=whole_ms,
         whole_regrow_attempts=whole_attempts,
         boruvka_rounds=rounds, launches=launches,
         peak_device_gb=peak / 1e9, seam_round=seam,
         equals_run=True, equals_staged=True)
    return {"launches": launches, "threshold": tv, "grid": grid,
            "capacities": (mf, tf, tk), "seam_round": seam,
            "count": int(res.diagram.count),
            "diagram": diagram_to_numpy(res.diagram)}


def phase_delta(frame, tiled) -> dict:
    """Phase 13: delta-PH over a survey stream of the 10240² frame.

    ``FrameSequence(0, TILED_SIZE, grid=(10, 10), dirty_frac=0.05)`` with
    its base the frame phase 3 rendered; frames ``DELTA_FRAMES`` through
    ``run_delta`` at the tiled phase's threshold and final capacities.
    Each must equal a cold ``run_tiled`` of the same frame bitwise, and
    the hits must read miss, partial (the frame's ``dirty_tiles``),
    partial, full.  Wall ms per frame, the tile hash timed apart.
    """
    from repro_torch.core import delta
    from repro_torch.data import astro
    from repro_torch.kernels.ph_phase_c import kernel as kc
    from repro_torch.ph import DeltaSpec, PHConfig, PHEngine, TileSpec

    mf, tf, tk = tiled["capacities"]
    tv, grid = tiled["threshold"], tiled["grid"]
    cfg = PHConfig(**MAIN_CONFIG, max_features=mf, delta=DeltaSpec(),
                   tile=TileSpec(max_features_per_tile=tf,
                                 max_candidates_per_tile=tk))
    engine = PHEngine(cfg)
    fs = astro.FrameSequence(0, TILED_SIZE, grid=grid,
                             dirty_frac=DELTA_DIRTY_FRAC)
    fs._base = frame            # base() would render the same frame again
    rows, cold = [], {}
    want = [("miss", grid[0] * grid[1])] + [
        ("partial", len(fs.dirty_tiles(i))) for i in DELTA_FRAMES[1:3]] + [
        ("full", 0)]
    launches = 0
    for i, (kind, n_dirty) in zip(DELTA_FRAMES, want):
        img = fs.frame(i)
        x = engine.cast_input_host(img)
        _, hash_ms = wall_ms(lambda: delta.frame_digests(x, grid))
        before = kc.LIBRARY.launches
        res, ms = wall_ms(lambda: engine.run_delta(img, tv))
        launches += kc.LIBRARY.launches - before
        if (res.delta.hit, res.delta.n_dirty) != (kind, n_dirty):
            raise AssertionError(f"frame {i}: {res.delta} != {kind} with "
                                 f"{n_dirty} dirty tiles")
        if res.regrow.attempts:
            raise AssertionError(f"frame {i} regrew at settled capacities")
        cold_ms = None
        if i not in cold:
            cold[i], cold_ms = wall_ms(lambda: engine.run_tiled(img, tv))
        if not same_diagram(res.diagram, cold[i].diagram):
            raise AssertionError(f"run_delta != cold run_tiled on frame {i}")
        rows.append(dict(frame=i, hit=res.delta.hit,
                         n_dirty=res.delta.n_dirty,
                         dirty_tiles=fs.dirty_tiles(i).tolist(),
                         wall_ms=ms, hash_ms=hash_ms,
                         cold_run_tiled_ms=cold_ms,
                         count=int(res.diagram.count)))
    emit("delta", shape=[TILED_SIZE] * 2, grid=list(grid),
         dirty_frac=DELTA_DIRTY_FRAC, threshold=tv, frames=rows,
         best_edge_launches=launches, cache=engine.delta_cache_stats(),
         equals_cold_run_tiled=True)
    return {"launches": launches}


def pipeline_survey() -> list:
    """The pipeline phase's dataset as ``run_distributed`` takes it."""
    return [(i, PIPELINE_SIZES[i % len(PIPELINE_SIZES)])
            for i in range(PIPELINE_WHOLE)] + [(PIPELINE_WHOLE,
                                                PIPELINE_TILED)]


def chain_capacities(engine, f: int, n: int) -> tuple[int, int]:
    """The step of ``engine``'s regrow chain for an ``n``-pixel image whose
    diagram capacity is ``f``: ``(max_features, max_candidates)`` as the
    pipeline dispatched them (both grow together from the config's)."""
    caps = engine.initial_capacities(n)
    while caps[0] < f:
        nxt = engine.grow_capacities(*caps, n)
        if nxt == caps:
            break
        caps = nxt
    if caps[0] != f:
        raise AssertionError(f"capacity {f} is not on the regrow chain")
    return caps


class capture_kernels:
    """While active (and ``on``), the first input of the phase-A kernel
    and of the best-edge kernel, cloned, under ``"phase_a"`` and
    ``"best_edge"``; the kernels run as they would."""

    def __init__(self, on: bool):
        from repro_torch.kernels.ph_phase_a import ops as oa
        from repro_torch.kernels.ph_phase_c import ops as oc
        self.on, self.oa, self.oc, self.got = on, oa, oc, {}

    def __enter__(self):
        if self.on:
            ka, kc = self.oa.kernel.phase_a, self.oc.kernel.best_edge_reduce
            self.orig = ka, kc

            def phase_a(x, **kw):
                self.got.setdefault("phase_a", (x.clone(), kw["strip_rows"]))
                return ka(x, **kw)

            def best_edge(key, ra_, rb_, nv):
                self.got.setdefault("best_edge", (key.clone(), ra_.clone(),
                                                  rb_.clone(), nv))
                return kc(key, ra_, rb_, nv)

            self.oa.kernel.phase_a = phase_a
            self.oc.kernel.best_edge_reduce = best_edge
        return self.got

    def __exit__(self, *exc):
        if self.on:
            self.oa.kernel.phase_a, self.oc.kernel.best_edge_reduce = \
                self.orig


def check_best_edge(cap, err) -> dict:
    """The best-edge kernel against its plain version, bitwise, on the
    round ``capture_kernels`` caught."""
    import torch
    from repro_torch.kernels.ph_phase_c import kernel as kc
    from repro_torch.kernels.ph_phase_c import ref as rc
    key, ra_, rb_, nv = cap["best_edge"]
    b_k, w_k = kc.best_edge_reduce(key, ra_, rb_, nv)
    b_r, w_r = rc.best_edge_reduce(key, ra_, rb_, nv)
    e = max(max_abs_diff(b_k, b_r), max_abs_diff(w_k, w_r))
    err["ph_phase_c"] = max(err["ph_phase_c"], e)
    if not (torch.equal(b_k, b_r) and torch.equal(w_k, w_r)):
        raise AssertionError(f"best_edge kernel != plain on the pipeline's "
                             f"round of {key.numel()} edges")
    return dict(edges=key.numel(), nv=nv, max_abs_err=e, bitwise_equal=True)


def d2h_turns(tree, reps: int = 20) -> dict:
    """Host ms of one device-to-host copy of ``tree``: ``start_d2h`` (pinned,
    one side stream, one event) against ``.cpu()`` per leaf, in turns; the
    two copies must be equal."""
    import torch
    from repro_torch.ph.overlap import map_tensors, start_d2h
    fns = {"start_d2h": lambda: start_d2h(tree).result(),
           "cpu": lambda: map_tensors(lambda t: t.cpu(), tree)}
    ms = dict.fromkeys(fns, 0.0)
    for _ in range(reps):
        for k, fn in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            ms[k] += (time.perf_counter() - t0) * 1e3 / reps
    a, b = (fn() for fn in fns.values())
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError("start_d2h copy != .cpu()")
    return {**ms, "bytes": sum(t.numel() * t.element_size() for t in a)}


def phase_pipeline(reset_counts, read_counts, err) -> dict:
    """Phase 17: the distributed pipeline over a survey of astro frames.

    ``run_distributed`` of :func:`pipeline_survey` twice — synchronous,
    then with ``OverlapSpec()`` — through ``PHEngine`` on the card.  The
    executor's loads and results are observed (never changed) to hold
    every image's diagram to ``run`` (whole frames: a fresh engine at the
    pipeline's capacities) or ``run_tiled`` (the staged tiles) at the
    threshold the loader computed, and the kernels to their plain versions
    on the inputs of those runs.  Then a staged round under sync
    debug mode ``"error"``, and a failure injection plus a work-log
    resume over the survey's 1024² and 2048² frames.
    """
    import torch
    from repro_torch.distributed.context import single_device_ctx
    from repro_torch.ph import OverlapSpec, PHConfig, PHEngine, TileSpec
    from repro_torch.ph.overlap import PendingResult
    from repro_torch.pipeline import driver
    from repro_torch.pipeline.executor import ShardedPHExecutor
    from repro_torch.pipeline.scheduler import BucketRound, ImageMeta

    survey = pipeline_survey()
    cfg = PHConfig(**MAIN_CONFIG, bucket_rounding="pow2",
                   tile=TileSpec(max_tile_pixels=PIPELINE_TILE_PIXELS))
    loads: dict = {}          # id -> (host image, threshold), sync run
    tiles: dict = {}          # id -> (StagedTiles, threshold), sync run
    diags: dict = {"sync": {}, "overlap": {}}
    host_ms: dict = {}
    label = ["sync"]
    orig = (ShardedPHExecutor._load_one, ShardedPHExecutor.load_self_tiled,
            ShardedPHExecutor.begin_staged)

    def timed(fn, key):
        def call(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            host_ms[label[0]][key] += (time.perf_counter() - t0) * 1e3
            return out
        return call

    def load_one(self, meta):
        img, t = timed(orig[0], "load_ms")(self, meta)
        if label[0] == "sync":
            loads[meta.image_id] = (img, t)
        return img, t

    def load_tiled(self, rnd, meta):
        staged = timed(orig[1], "tiled_stage_ms")(self, rnd, meta)
        if label[0] == "sync":
            tiles[meta.image_id] = (staged.tiles, staged.threshold)
        return staged

    def begin_staged(self, staged):
        name = label[0]
        pending = timed(orig[2], "compute_ms")(self, staged)

        def finish():
            out = timed(pending.resolve, "compute_ms")()
            diags[name].update(out)
            return out

        return PendingResult(finish)

    def drive(engine, name):
        label[0] = name
        host_ms[name] = dict(load_ms=0.0, threshold_ms=0.0,
                             tiled_stage_ms=0.0, compute_ms=0.0)
        # The Variant-2 statistic inside each load, timed where it runs.
        engine.auto_threshold = timed(engine.auto_threshold, "threshold_ms")
        before = engine.overlap_counters.snapshot()
        reset_counts()
        res, ms = wall_ms(lambda: engine.run_distributed(survey))
        launches = read_counts()
        after = engine.overlap_counters.snapshot()
        if min(launches["ph_phase_a"], launches["ph_phase_c"]) <= 0:
            raise AssertionError(f"pipeline ({name}) missed a kernel: "
                                 f"{launches}")
        if res.failures or len(res.diagrams) != len(survey):
            raise AssertionError(f"pipeline ({name}) incomplete: {res}")
        return res, ms, launches, {k: after[k] - before[k] for k in after}

    ShardedPHExecutor._load_one = load_one
    ShardedPHExecutor.load_self_tiled = load_tiled
    ShardedPHExecutor.begin_staged = begin_staged
    try:
        sync = PHEngine(cfg)
        res_s, sync_ms, launches_s, count_s = drive(sync, "sync")
        over = PHEngine(cfg.replace(overlap=OverlapSpec()))
        res_o, over_ms, launches_o, count_o = drive(over, "overlap")
    finally:
        (ShardedPHExecutor._load_one, ShardedPHExecutor.load_self_tiled,
         ShardedPHExecutor.begin_staged) = orig
    del sync.auto_threshold, over.auto_threshold      # the timing wrappers
    if res_o.diagrams != res_s.diagrams:
        raise AssertionError("overlapped pipeline summaries != synchronous")
    if any(d["overflow"] for d in res_s.diagrams.values()):
        raise AssertionError("a pipeline diagram overflows after regrow")
    for i in range(len(survey)):
        if not same_diagram(diags["sync"][i], diags["overlap"][i]):
            raise AssertionError(f"image {i}: overlapped diagram != "
                                 f"synchronous")
    whole_rounds = res_s.rounds - 1
    if whole_rounds != PIPELINE_WHOLE or res_o.rounds != res_s.rounds:
        raise AssertionError(f"rounds {res_s.rounds}/{res_o.rounds}: one "
                             f"executor gives one round per image")
    want_counts = dict(h2d_transfers=whole_rounds, dispatch_syncs=0,
                       harvest_syncs=res_o.rounds, d2h_streams=res_o.rounds)
    if any(count_o[k] != v for k, v in want_counts.items()):
        raise AssertionError(f"overlap counters {count_o} != {want_counts}")
    if count_s["dispatch_syncs"] != res_s.rounds \
            or count_s["harvest_syncs"]:
        raise AssertionError(f"synchronous counters {count_s}")

    # Every image against the port's own single-image entry points, at the
    # capacities the pipeline ended on.  The first frame of each whole size
    # and the tiled frame also hold the kernels to their plain versions on
    # the inputs the path gives them (phase A's image and the first, the
    # largest, Boruvka round, captured), and each whole size's diagram to a
    # use_pallas=False engine's.
    t0 = time.perf_counter()
    held, d2h = {}, {}
    for i, (img, t) in sorted(loads.items()):
        d = diags["sync"][i]
        mf, mc = chain_capacities(sync, d.birth.shape[0], img.size)
        one_cfg = cfg.replace(max_features=mf, regrow_features_ceiling=mf,
                              max_candidates=mc)
        first = img.shape[0] not in held
        with capture_kernels(first) as cap:
            one = PHEngine(one_cfg).run(img, t)
        if one.regrow.attempts or not same_diagram(d, one.diagram):
            raise AssertionError(f"image {i}: pipeline != run")
        if not first:
            continue
        plain = PHEngine(one_cfg.replace(use_pallas=False)).run(img, t)
        if plain.regrow.attempts or not same_diagram(d, plain.diagram):
            raise AssertionError(f"image {i}: pipeline != the plain engine")
        x, s_rows = cap["phase_a"]
        check_phase_a(x, s_rows, f"pipeline image {i}", err)
        held[img.shape[0]] = dict(image=i, max_features=mf,
                                  max_candidates=mc,
                                  phase_a_shape=list(x.shape),
                                  best_edge=check_best_edge(cap, err),
                                  plain_engine_equal=True)
        d2h[f"{img.shape[0]}"] = d2h_turns(one.diagram)
    for i, (staged, t) in tiles.items():
        with capture_kernels(True) as cap:
            one = sync.run_tiled(staged, t)
        if one.regrow.attempts or not same_diagram(diags["sync"][i],
                                                   one.diagram):
            raise AssertionError(f"image {i}: pipeline != run_tiled")
        held["seam"] = dict(image=i, best_edge=check_best_edge(cap, err))
        d2h[f"{PIPELINE_TILED} tiled"] = d2h_turns(one.diagram)
    per_image_ms = (time.perf_counter() - t0) * 1e3
    if sorted(k for k in held if k != "seam") != sorted(
            set(PIPELINE_SIZES)) or "seam" not in held:
        raise AssertionError(f"kernels not held at every size: {held}")
    tiled_grid = list(sync._resolve_grid((PIPELINE_TILED,) * 2,
                                         "float32", cfg.tile))
    del loads, tiles

    # A staged round's dispatch side under sync debug mode "error": its
    # load and begin enqueue uploads and events only (no other thread
    # runs here; the mode is process-wide).
    pool = ShardedPHExecutor(over, single_device_ctx())
    meta = ImageMeta(1, (PIPELINE_SIZES[1],) * 2)
    rnd = BucketRound("whole", meta.shape, ((0, meta),))
    h2d = over.overlap_counters.snapshot()["h2d_transfers"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = pool.begin_staged(pool.load_round(rnd))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    got = pending.resolve()[1]
    if driver._summarize(got) != res_s.diagrams[1] or \
            over.overlap_counters.snapshot()["h2d_transfers"] != h2d + 1:
        raise AssertionError("begin_staged round != the pipeline's image 1")

    # One injected failure, then a resume from the work log, over the
    # survey's 1024² and 2048² frames; both equal the clean run.
    subset = [(i, s) for i, s in survey if s <= 2048]
    log = ROOT / "build" / "pipeline_worklog.jsonl"
    log.parent.mkdir(parents=True, exist_ok=True)
    log.unlink(missing_ok=True)
    failing = PHEngine(cfg.replace(overlap=OverlapSpec()))
    res_f, fail_ms = wall_ms(lambda: failing.run_distributed(
        subset, work_log=log,
        failure_injector=driver.FailureInjector([PIPELINE_FAIL_ROUND])))
    resumer = PHEngine(cfg.replace(overlap=OverlapSpec()))
    res_r = resumer.run_distributed(subset, work_log=log)
    want = {i: res_s.diagrams[i] for i, _ in subset}
    logged = [json.loads(x)["image_id"] for x in
              log.read_text().splitlines()]
    log.unlink()
    if res_f.failures != 1 or res_f.diagrams != want:
        raise AssertionError(f"failure run: {res_f.failures} failures, "
                             f"equal={res_f.diagrams == want}")
    if res_r.rounds or res_r.diagrams != want or sorted(logged) != \
            sorted(want) or resumer.overlap_counters.snapshot()[
                "h2d_transfers"]:
        raise AssertionError("work-log resume recomputed or differs")

    emit("pipeline", survey=[list(x) for x in survey],
         config=json.loads(cfg.to_json()), strategy="part_LPT",
         tiled_grid=tiled_grid, rounds=res_s.rounds,
         whole_rounds=whole_rounds,
         objects=sum(d["count"] for d in res_s.diagrams.values()),
         tiled_count=res_s.diagrams[PIPELINE_WHOLE]["count"],
         sync_wall_ms=sync_ms, overlap_wall_ms=over_ms,
         loader_host_ms=host_ms, counters={"sync": count_s,
                                           "overlap": count_o},
         launches={"sync": launches_s, "overlap": launches_o},
         regrow_log=[[r["kind"], list(r["from"]), list(r["to"])]
                     for r in sync.regrow_log],
         per_image_check_ms=per_image_ms, kernels_vs_plain=held,
         d2h_ms=d2h,
         failure={"fail_round": PIPELINE_FAIL_ROUND,
                  "images": len(subset), "failures": res_f.failures,
                  "rounds": res_f.rounds, "wall_ms": fail_ms,
                  "resume_rounds": res_r.rounds},
         sync_debug_error_begin_staged=True, equals_run=True,
         overlap_equals_sync=True, resume_equals_clean=True)
    return {"launches": launches_s}


def serving_load() -> tuple[list, list]:
    """The serving phase's survey load: ``(frames, requests)`` —
    ``SERVE_FRAMES`` astro frames at ``BATCH_SIZE``², and
    ``SERVE_REQUESTS`` windows cut from them, cycling ``SERVE_BUCKETS``,
    each side drawn at 60-100 % of its bucket at a drawn offset (seed
    18)."""
    import numpy as np
    from repro_torch.data import astro
    frames = [astro.generate_image(i, BATCH_SIZE)
              for i in range(SERVE_FRAMES)]
    rng = np.random.default_rng(18)
    requests = []
    for k in range(SERVE_REQUESTS):
        b = SERVE_BUCKETS[k % len(SERVE_BUCKETS)]
        h, w = (int(rng.integers(int(b * 0.6), b + 1)) for _ in range(2))
        r0 = int(rng.integers(0, BATCH_SIZE - h + 1))
        c0 = int(rng.integers(0, BATCH_SIZE - w + 1))
        f = frames[(k // len(SERVE_BUCKETS)) % SERVE_FRAMES]
        requests.append(np.ascontiguousarray(f[r0:r0 + h, c0:c0 + w]))
    return frames, requests


def same_rows(a, b) -> bool:
    """Two results' valid rows (``to_array()``) equal bit for bit, with the
    same unmerged count and overflow flag (capacities may differ)."""
    import numpy as np
    x, y = a.to_array(), b.to_array()
    return x.shape == y.shape and np.array_equal(
        x.view(np.int64), y.view(np.int64)) and all(
        int(getattr(a.diagram, f)) == int(getattr(b.diagram, f))
        for f in ("n_unmerged", "overflow"))


def cuda_bytes(tree) -> int:
    """Device memory held by the CUDA tensor leaves of ``tree``."""
    from repro_torch.ph.overlap import map_tensors
    held = []
    map_tensors(lambda t: held.append(t.numel() * t.element_size()
                                      if t.is_cuda else 0), tree)
    return sum(held)


class deferred_harvest:
    """Stands in for a server's harvest pool: records each resolution the
    tick hands over instead of running it, so a dispatch can be checked
    with nothing else running; :meth:`run` then resolves them on the
    calling thread."""

    def __init__(self):
        self.calls = []

    def submit(self, fn, *args):
        self.calls.append((fn, args))

    def run(self):
        calls, self.calls = self.calls, []
        for fn, args in calls:
            fn(*args)

    def shutdown(self, wait=True):
        self.run()


def phase_serving(reset_counts, read_counts, err) -> dict:
    """Phase 18: PH-as-a-service on the card.

    A ``PHServer`` over ``PHEngine(MAIN_CONFIG, serve=ServeSpec(buckets
    1024² and 2048², batch_cap 4), overlap=OverlapSpec())``: ``warmup``
    (its seconds, plans and the capacity tier of each bucket), then the
    survey load (:func:`serving_load`) from ``SERVE_CLIENTS`` threads with
    the thresholds left to the server.  Held: every served diagram equals
    the port's own ``run`` at the served threshold, one request per bucket
    a ``use_pallas=False`` engine's; no plan built and no regrow after
    warmup; phase-A and best-edge launches during the load; no blocking
    read on the tick thread.  Then a batch of each bucket at the warm tier
    against ``run_batch`` of the same four images at their own tier (the
    kernels held to their plain versions on the warm-tier inputs); the
    first requests again through a synchronous harvest; one tick dispatch
    under ``torch.cuda.set_sync_debug_mode("error")``; the cache tier over
    a ``FrameSequence`` at 2048² (miss, partial hit, exact hit on the
    submit thread); and the ``ph_serve`` CLI as a subprocess.
    """
    import os
    import threading

    import numpy as np
    import torch
    from repro_torch.data import astro
    from repro_torch.ph import (DeltaSpec, OverlapSpec, PHConfig, PHEngine,
                                ServeSpec, TileSpec)
    from repro_torch.pipeline.scheduler import assign_bucket
    from repro_torch.serving import PHServer, bucket_label

    t_phase = time.perf_counter()
    spec = ServeSpec(buckets=SERVE_BUCKETS, batch_cap=SERVE_CAP,
                     tick_interval_s=0.002)
    cfg = PHConfig(**MAIN_CONFIG, serve=spec, overlap=OverlapSpec())
    engine = PHEngine(cfg)
    srv = PHServer(engine)
    info = srv.warmup()
    tiers = {}
    for b in spec.buckets:
        n = b[0] * b[1]
        single = engine._grown.get(("single", b, "torch.float32"),
                                   engine.initial_capacities(n))
        batched = engine._grown.get(("batched", (SERVE_CAP, *b),
                                     "torch.float32"),
                                    engine.initial_capacities(n))
        worst = -(-b[0] // 2) * -(-b[1] // 2)
        tiers[bucket_label(b)] = dict(single=list(single),
                                      batched=list(batched),
                                      checkerboard_features=worst)
        if batched[0] < worst:
            raise AssertionError(f"bucket {b}: warm tier {batched} below "
                                 f"the checkerboard's {worst} features")
    warm_regrows = len(engine.regrow_log)

    # -- the survey load ------------------------------------------------------
    frames, requests = serving_load()
    bucket_of = [assign_bucket(im.shape, spec.buckets) for im in requests]
    stat = []                   # (bucket, s) per statistic call (tick)
    orig_stat = engine.auto_threshold

    def timed_stat(img):
        t0 = time.perf_counter()
        out = orig_stat(img)
        stat.append((assign_bucket(tuple(img.shape), spec.buckets),
                     time.perf_counter() - t0))
        return out

    results = [None] * len(requests)
    errors = []

    def client(c):
        try:
            futs = [(k, srv.submit(requests[k]))
                    for k in range(c, len(requests), SERVE_CLIENTS)]
            for k, f in futs:
                results[k] = f.result(timeout=600)
        except Exception as exc:        # noqa: BLE001 — reported below
            errors.append(exc)

    engine.auto_threshold = timed_stat
    before = engine.overlap_counters.snapshot()
    reset_counts()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(SERVE_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    drained = srv.drain(600)
    load_ms = (time.perf_counter() - t0) * 1e3
    launches = read_counts()
    del engine.auto_threshold
    after = engine.overlap_counters.snapshot()
    counters = {k: after[k] - before[k] for k in after}
    stats = srv.stats()
    srv.shutdown()
    if errors or not drained or any(r is None for r in results) \
            or stats["failed"] or stats["completed"] != len(requests):
        raise AssertionError(f"serving load failed: {errors[:3]}, "
                             f"drained={drained}, failed={stats['failed']}, "
                             f"completed={stats['completed']}")
    if srv.steady_state_traces() != 0 or \
            len(engine.regrow_log) != warm_regrows:
        raise AssertionError(f"steady state built {srv.steady_state_traces()}"
                             f" plans and regrew "
                             f"{engine.regrow_log[warm_regrows:]}")
    if min(launches["ph_phase_a"], launches["ph_phase_c"]) <= 0:
        raise AssertionError(f"serving missed a kernel: {launches}")
    if counters["dispatch_syncs"] != 0 or counters["harvest_syncs"] <= 0:
        raise AssertionError(f"serving counters {counters}")
    if not all(f.device.type == "cpu" for r in results for f in r.diagram):
        raise AssertionError("a served row is not in host memory")

    # -- every served diagram against run; one per bucket against plain -----
    t0 = time.perf_counter()
    ref = PHEngine(PHConfig(**MAIN_CONFIG))
    plain = PHEngine(PHConfig(**MAIN_CONFIG, use_pallas=False))
    plain_held = {}
    for k, (img, res) in enumerate(zip(requests, results)):
        if not same_rows(ref.run(img, res.threshold), res):
            raise AssertionError(f"request {k}: served != run")
        label = bucket_label(bucket_of[k])
        if label not in plain_held:
            if not same_rows(plain.run(img, res.threshold), res):
                raise AssertionError(f"request {k}: served != the plain "
                                     f"engine")
            plain_held[label] = dict(request=k, shape=list(img.shape),
                                     count=int(res.diagram.count))
    check_ms = (time.perf_counter() - t0) * 1e3
    del ref, plain

    # -- per bucket: latency, occupancy, the statistic, warm vs own tier -----
    buckets = {}
    for b in spec.buckets:
        label = bucket_label(b)
        bs = stats["buckets"][label]
        ks = [k for k in range(len(requests)) if bucket_of[k] == b]
        imgs = [requests[k] for k in ks[:SERVE_CAP]]
        tvs = [results[k].threshold for k in ks[:SERVE_CAP]]
        own = PHEngine(PHConfig(**MAIN_CONFIG, overlap=OverlapSpec()))
        first_own = own.run_batch(imgs, tvs, bucket=b, dedupe=False)
        with capture_kernels(True) as cap:
            warm = engine.run_batch(imgs, tvs, bucket=b, dedupe=False)
        x, s_rows = cap["phase_a"]
        check_phase_a(x, s_rows, f"serving {label} warm-tier batch", err)
        held = dict(phase_a_shape=list(x.shape),
                    best_edge=check_best_edge(cap, err))
        del cap, x
        ms = {"warm": [], "own": []}
        for name in ("own", "warm", "warm", "own", "own", "warm"):
            eng = engine if name == "warm" else own
            out, t_ms = wall_ms(lambda: eng.run_batch(imgs, tvs, bucket=b,
                                                      dedupe=False))
            ms[name].append(t_ms)
        for i, k in enumerate(ks[:SERVE_CAP]):
            for batch in (warm, first_own):
                row = type(results[k])(
                    type(batch.diagram)(*(f[i] for f in batch.diagram)),
                    batch.config, batch.regrow, tvs[i])
                if not same_rows(row, results[k]):
                    raise AssertionError(f"{label}: run_batch row {i} != "
                                         f"served")
        stat_s = sum(t for bb, t in stat if bb == b)
        batch_s = bs["batch_s"]["mean"] * bs["batch_s"]["count"]
        buckets[label] = dict(
            requests=bs["requests"], batches=bs["batches"],
            occupancy=bs["occupancy"],
            e2e_ms={q: bs["e2e_s"][q] * 1e3 for q in ("p50", "p95", "p99")},
            queue_wait_ms={q: bs["queue_wait_s"][q] * 1e3
                           for q in ("p50", "p95", "p99")},
            served_batch_ms_mean=bs["batch_s"]["mean"] * 1e3,
            statistic_calls=sum(1 for bb, _ in stat if bb == b),
            statistic_ms=stat_s * 1e3,
            statistic_share_of_batch=stat_s / batch_s if batch_s else None,
            warm_tier=tiers[label]["batched"],
            own_tier=list(own._grown.get(("batched", (SERVE_CAP, *b),
                                          "torch.float32"),
                                         own.initial_capacities(
                                             b[0] * b[1]))),
            run_batch_warm_tier_ms=ms["warm"],
            run_batch_own_tier_ms=ms["own"],
            run_batch_warm_tier_ms_median=statistics.median(ms["warm"]),
            run_batch_own_tier_ms_median=statistics.median(ms["own"]),
            kernels_vs_plain=held, plain_engine_equal=plain_held[label])
        del own, warm, first_own

    # -- the first requests again through a synchronous harvest -------------
    sync_eng = PHEngine(cfg.replace(overlap=OverlapSpec(
        async_harvest=False)))
    with PHServer(sync_eng) as ssrv:
        futs = [ssrv.submit(requests[k]) for k in range(SERVE_ASYNC_CHECK)]
        sync_res = [f.result(timeout=600) for f in futs]
    sync_counters = sync_eng.overlap_counters.snapshot()
    for k, res in enumerate(sync_res):
        if res.threshold != results[k].threshold or \
                not same_rows(res, results[k]):
            raise AssertionError(f"request {k}: sync harvest != async")
    if sync_counters["dispatch_syncs"] <= 0 or sync_counters["harvest_syncs"]:
        raise AssertionError(f"sync harvest counters {sync_counters}")
    del sync_eng, sync_res

    # -- one tick dispatch under sync debug mode "error" ---------------------
    # A server that never starts its tick: its queue is filled and the tick's
    # dispatch runs here, with the harvest recorded, not run, so nothing
    # else is on the card while the (process-wide) mode is on.
    dsrv = PHServer(engine, start=False)
    dsrv._harvest.shutdown(wait=True)
    dsrv._harvest = deferred = deferred_harvest()
    ks = [k for k in range(len(requests))
          if bucket_of[k] == spec.buckets[-1]][:SERVE_CAP]
    futs = [dsrv.submit(requests[k]) for k in ks]
    bucket, reqs = dsrv._next_batch()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        handed = dsrv._dispatch(bucket, reqs)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if not handed:
        raise AssertionError(f"the tick's dispatch did not hand its batch "
                             f"to the harvest: {futs[0].exception()}")
    deferred.run()
    for k, f in zip(ks, futs):
        if not same_rows(f.result(timeout=0), results[k]):
            raise AssertionError(f"request {k}: sync-debug dispatch != "
                                 f"served")
    dsrv.shutdown()

    # -- the cache tier over a FrameSequence at 2048² -------------------------
    fs = astro.FrameSequence(0, BATCH_SIZE, grid=SERVE_TIER_GRID)
    fs._base = frames[0]        # base() would render frame 0 again
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    tier_eng = PHEngine(PHConfig(
        **MAIN_CONFIG, tile=TileSpec(grid=SERVE_TIER_GRID),
        delta=DeltaSpec(), serve=ServeSpec(buckets=(BATCH_SIZE,),
                                           batch_cap=SERVE_CAP,
                                           tick_interval_s=0.002)))
    f0, f1 = fs.frame(0), fs.frame(1)
    tv = tier_eng.auto_threshold(f0)
    with PHServer(tier_eng) as tsrv:
        # The tier's own launches; the miss's first best-edge call (the
        # seam merge's first Boruvka round) is caught to hold the kernel.
        reset_counts()
        with capture_kernels(True) as cap:
            r0, miss_ms = wall_ms(lambda: tsrv.submit(f0, tv).result(600))
        r1, partial_ms = wall_ms(lambda: tsrv.submit(f1, tv).result(600))
        t0 = time.perf_counter()
        fut = tsrv.submit(f1, tv)
        on_submit = fut.done()
        hit_ms = (time.perf_counter() - t0) * 1e3
        tier_launches = read_counts()
        tier_stats = tsrv.cache_stats()
        tier_entries = list(tsrv._cache._entries.values())
    r2 = fut.result(timeout=0)
    if tier_launches["ph_phase_c"] <= 0 or "best_edge" not in cap:
        raise AssertionError(f"cache tier missed the best-edge kernel: "
                             f"{tier_launches}")
    tier_seam = check_best_edge(cap, err)
    del cap
    if (r0.delta.hit, r1.delta.hit) != ("miss", "partial") or \
            r1.delta.n_dirty != len(fs.dirty_tiles(1)):
        raise AssertionError(f"cache tier: {r0.delta}, {r1.delta}")
    if not on_submit or r2 is not r1 or tier_stats["hits"] != 1:
        raise AssertionError(f"cache tier: exact hit not resolved on the "
                             f"submit thread ({tier_stats})")
    cold = tier_eng.run_tiled(f1, tv)
    if cold.regrow.attempts or not same_diagram(r1.diagram, cold.diagram):
        raise AssertionError("cache tier: partial hit != run_tiled")
    store = list(tier_eng._delta_cache._entries.values())
    torch.cuda.synchronize()
    cache_tier = dict(
        grid=list(SERVE_TIER_GRID), threshold=tv,
        hits=["miss", "partial", "exact (submit thread)"],
        dirty_tiles=fs.dirty_tiles(1).tolist(), miss_ms=miss_ms,
        partial_ms=partial_ms, exact_hit_ms=hit_ms,
        count=int(r1.diagram.count), counters=tier_stats,
        launches=tier_launches, seam_round=tier_seam,
        tier_entries=len(tier_entries),
        tier_device_bytes=sum(cuda_bytes(r.diagram) for r in tier_entries),
        frame_store_entries=len(store),
        frame_store_device_bytes=sum(
            cuda_bytes([e.state, e.result.diagram]) for e in store),
        engine_device_bytes=torch.cuda.memory_allocated() - mem0,
        partial_equals_run_tiled=True)
    del tier_eng, store, tier_entries, r0, r1, r2, cold

    # -- the CLI ---------------------------------------------------------------
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.ph_serve",
                          *SERVE_CLI], capture_output=True, text=True,
                         env=env, timeout=600, cwd=ROOT)
    cli_ms = (time.perf_counter() - t0) * 1e3
    if out.returncode != 0:
        raise AssertionError(f"ph_serve exited {out.returncode}: "
                             f"{out.stderr[-2000:]}")
    head, body = out.stdout.split("\n", 1)
    cli = json.loads(body)
    if cli["serve"]["steady_state_traces"] != 0 or cli["serve"]["failed"] \
            or cli["resolved"] != 64 or not cli["device"].startswith("cuda"):
        raise AssertionError(f"ph_serve: {body[:2000]}")

    emit("serving", buckets=[list(b) for b in spec.buckets],
         batch_cap=SERVE_CAP, config=json.loads(cfg.to_json()),
         warmup=info, warm_tiers=tiers, requests=len(requests),
         clients=SERVE_CLIENTS, load_wall_ms=load_ms,
         completed=stats["completed"], failed=stats["failed"],
         steady_state_traces=0, regrows_after_warmup=0,
         launches=launches, counters=counters, per_bucket=buckets,
         run_check_ms=check_ms, equals_run=True,
         sync_harvest_equals_async=True,
         sync_harvest_counters=sync_counters,
         sync_debug_error_dispatch=True, cache_tier=cache_tier,
         cli=dict(args=list(SERVE_CLI), wall_ms=cli_ms,
                  warmup=json.loads(head.split(" ", 1)[1]),
                  resolved=cli["resolved"],
                  steady_state_traces=cli["serve"]["steady_state_traces"],
                  buckets={k: dict(e2e_p50_ms=v["e2e_s"]["p50"] * 1e3,
                                   occupancy=v["occupancy"])
                           for k, v in cli["serve"]["buckets"].items()}),
         phase_s=time.perf_counter() - t_phase)
    return {"launches": launches, "cache_tier_launches": tier_launches}


def phase_ph_examples(reset_counts, read_counts) -> dict:
    """Phase 18b: the three PH examples (``examples/*_torch.py``) in
    process on the card at their defaults (the work log under
    ``build/``): each finishes and launches phase A and best-edge;
    quickstart's diagram equals the union-find oracle's, the distributed
    run recovers its injected failure, every served future resolves with
    no plan built after the warmup.  Returns each one's launches."""
    import numpy as np
    import torch
    from repro_torch.core import persistence_oracle
    from repro_torch.data import astro

    t_phase = time.perf_counter()
    argv = {"quickstart_torch": [],
            "distributed_ph_torch": ["--work-log", str(
                ROOT / "build" / "ph_examples_worklog.jsonl")],
            "serve_ph_torch": []}
    out, launches = {}, {}
    for name, args in argv.items():
        example = load_example(name)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = example.main(args)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches[name] = {k: n for k, n in read_counts().items()
                          if k in ("ph_phase_a", "ph_phase_c")}
        if min(launches[name].values()) <= 0:
            raise AssertionError(f"{name} missed a kernel: "
                                 f"{launches[name]}")
        out[name] = {"wall_s": wall_s, "launches": launches[name]}
        if name == "quickstart_torch":
            want = persistence_oracle(astro.generate_image(image_id=42,
                                                           size=256))
            if not np.array_equal(res["rows"], want):
                raise AssertionError("quickstart's diagram != the oracle's")
            out[name].update(components=res["components"],
                             regrow_attempts=res["regrow_attempts"],
                             oracle_equal=True)
        elif name == "distributed_ph_torch":
            if res["images"] != 12 or res["failures"] != 1:
                raise AssertionError(f"distributed example: {res['images']} "
                                     f"images, {res['failures']} failures")
            out[name].update(images=res["images"], rounds=res["rounds"],
                             failures=res["failures"],
                             elapsed_s=res["elapsed_s"])
        else:
            if not res["resolved"] or res["steady_state_traces"]:
                raise AssertionError(f"serve example: {res['resolved']} "
                                     f"resolved, {res['steady_state_traces']}"
                                     f" plans built after warmup")
            out[name].update(resolved=res["resolved"],
                             rejected=len(res["rejected"]),
                             warmup=res["warmup"], buckets=res["buckets"])
    emit("ph_examples", **out, phase_s=time.perf_counter() - t_phase)
    return launches


def tuned_strip_inputs(dev, x_main) -> list:
    """The inputs phase A meets at the autotuner's strip heights: the
    4096² astro frame, the mixed batch's (5, 2048, 2048) bucket and the
    stride-2 peak grids the scalar searches measure on (4096², 2048²)."""
    from repro_torch.roofline.autotune import peak_grid
    return [(f"astro {MAIN_SIZE}²", x_main),
            ("survey bucket (5, 2048, 2048)", survey_bucket(dev))] + [
        (f"peak grid {n}²", peak_grid((n, n), "float32", dev))
        for n in (MAIN_SIZE, BATCH_SIZE)]


def rank_correlation(a, b) -> float | None:
    """Spearman's rank correlation of two sequences (ties take their mean
    rank); None when either is constant."""
    import numpy as np

    def ranks(x):
        x = np.asarray(x, np.float64)
        r = np.empty(len(x))
        r[np.argsort(x, kind="stable")] = np.arange(len(x))
        for v in np.unique(x):
            r[x == v] = r[x == v].mean()
        return r

    ra, rb = ranks(a), ranks(b)
    if ra.std() == 0 or rb.std() == 0:
        return None
    return float(np.corrcoef(ra, rb)[0, 1])


def wall_turns(untuned, tuned) -> dict:
    """Steady host walls (ms, each ending synchronized) of an untuned and
    a tuned call in turns: untuned, tuned, tuned, untuned."""
    u1, t1, t2, u2 = (wall_ms(fn)[1] for fn in (untuned, tuned, tuned,
                                                untuned))
    return {"untuned_ms": [u1, u2], "tuned_ms": [t1, t2]}


def same_host_diagram(d, want) -> bool:
    """A diagram against a host copy (``diagram_to_numpy``), every field."""
    from repro_torch.core import diagram_to_numpy
    import numpy as np
    return all(np.array_equal(x, y) for x, y in
               zip(diagram_to_numpy(d), want))


def phase_autotune(dev, ref, reset_counts, read_counts, err) -> dict:
    """Phase 19: the autotuner on the card.

    a. The phase-A kernel against its plain version at strip heights 4
       and 32 (``tuned_strip_inputs``; S = 32 at 4096 columns is a
       3-block cluster with a ragged last block, at 2048 columns exactly
       the 16-bit regime's 65,536 entries), and its device time at S = 4,
       8, 16 and 32 on the 4096² frame beside its bound.
    b. ``autotune`` of 4096² and 2048² float32 into a cache under
       ``build/``, every candidate (the four strip heights) measured: each
       candidate's model seconds, fastest measured seconds and the spread
       of its trials, their rank correlation, the winner and whether the
       default (S = 8) was kept; the entries must name the card.
    c. ``autotune_grid`` of the 10240² frame under ``max_tile_pixels=1 <<
       20``, every candidate measured: their ``per_tile_cost`` peaks,
       model bytes, measured seconds and spreads, the rank correlation,
       the winner and whether ``choose_grid``'s grid was kept.
    d. A tuned engine (``MAIN_CONFIG`` with ``autotune`` on that cache)
       through ``run`` of the 4096² frame, ``run_batch`` of the survey
       batch and ``run_tiled`` of the 10240² frame (the host array, at
       phase 12's threshold and final capacities): every diagram equal to
       phases 5, 9 and 12's bitwise, the tuned knobs and grid in effect,
       phase-A and best-edge launches (best-edge alone in ``run_tiled``:
       the tiled path takes only the tuned grid, as in the reference, and
       its per-tile phase A is keyed torch ops with no kernel); steady
       walls in turns with an untuned engine (host clock; no claim).
    e. Lookups (a miss, a hit, a grid) launch nothing and write nothing.
    f. ``python -m repro_torch.launch.ph_distances`` as a subprocess: its
       matrices equal ``distance_matrix`` in-process on the same frames
       (bn bitwise, sw at rtol 1e-5).

    ``ref`` holds the earlier phases' frames, thresholds and host
    diagrams.  Returns the launches of the searches and the tuned runs.
    """
    import os

    import numpy as np
    import torch
    from repro_torch.core.tiling import choose_grid, per_tile_cost
    from repro_torch.data import astro
    from repro_torch.kernels.ph_phase_a import kernel as ka
    from repro_torch.ph import PHConfig, PHEngine, TileSpec
    from repro_torch.roofline import autotune as at

    t_phase = time.perf_counter()
    name = torch.cuda.get_device_name()

    # -- a. phase A at the tuned strip heights -------------------------------
    if (ka.strip_layout(32, MAIN_SIZE), ka.strip_layout(32, BATCH_SIZE)) \
            != (("cluster", 3), ("shared16", 1)):
        raise AssertionError("unexpected width regimes at S = 32")
    x_main = torch.from_numpy(ref["frame"]).to(dev)
    n_cases = 0
    for label, x in tuned_strip_inputs(dev, x_main):
        for s in AUTOTUNE_STRIPS:
            check_phase_a(x, s, label, err)
            n_cases += 1
    a_bound = phase_a_bound_ms(x_main)
    strips = {}
    for s in (4, 8, 16, 32):
        dms = device_ms(lambda: ka.phase_a(x_main, strip_rows=s))
        strips[s] = dict(device_ms=dms, bound_ms=a_bound,
                         bound_share=a_bound / dms,
                         layout=ka.strip_layout(s, MAIN_SIZE))

    # -- b. the scalar searches ----------------------------------------------
    cache = ROOT / "build" / "autotune_smoke.json"
    cache.unlink(missing_ok=True)
    reset_counts()
    searches, best = {}, {}
    for size in (MAIN_SIZE, BATCH_SIZE):
        shape = (size, size)
        n_cands = len(at.candidate_space(shape))
        t0 = time.perf_counter()
        best[size] = at.autotune(shape, "float32", path=cache,
                                 measure_top=n_cands, trials=AUTOTUNE_TRIALS)
        search_s = time.perf_counter() - t0
        entry = at.load_cache(cache)[at.cache_key(shape, "float32")]
        trials = entry["trials"]
        if (best[size].source != "measured" or entry["device"] != name
                or len(trials) != n_cands or n_cands != 4
                or any(t["seconds"] is None for t in trials)):
            raise AssertionError(f"scalar search {shape}: {entry}")
        fastest = min(trials, key=lambda t: t["seconds"])
        searches[size] = dict(
            seconds=search_s, trials_per_candidate=AUTOTUNE_TRIALS,
            winner=best[size].strip_rows,
            default_kept=best[size].strip_rows == at.DEFAULTS.strip_rows,
            fastest=fastest["strip_rows"],
            model_first=trials[0]["strip_rows"],
            fastest_model_rank=trials.index(fastest) + 1,
            rank_correlation=rank_correlation(
                [t["model_s"] for t in trials],
                [t["seconds"] for t in trials]),
            candidates=[dict(strip_rows=t["strip_rows"],
                             model_s=t["model_s"], seconds=t["seconds"],
                             spread_s=t["spread_s"],
                             layout=ka.strip_layout(t["strip_rows"], size))
                        for t in trials])

    # -- c. the grid search --------------------------------------------------
    tshape = (TILED_SIZE, TILED_SIZE)
    n_grids = len(at.grid_candidates(tshape, max_tile_pixels=1 << 20))
    t0 = time.perf_counter()
    grid = at.autotune_grid(tshape, "float32", path=cache,
                            max_tile_pixels=1 << 20, measure_top=n_grids,
                            trials=AUTOTUNE_GRID_TRIALS)
    grid_s = time.perf_counter() - t0
    search_launches = read_counts()
    gentry = at.load_cache(cache)[at.cache_key(tshape, "float32")]
    if grid is None or gentry["tile_grid_source"] != "measured" \
            or gentry["device"] != name or any(
                t["seconds"] is None for t in gentry["tile_grid_trials"]):
        raise AssertionError(f"grid search: {gentry}")
    grid_rows = []
    for t in gentry["tile_grid_trials"]:
        gr, gc = t["grid"]
        c = per_tile_cost((TILED_SIZE // gr, TILED_SIZE // gc), "float32",
                          gr * gc, device=dev)
        grid_rows.append(dict(t, phase_a_peak_bytes=c["phase_a"][
            "peak_bytes_est"], phase_b_peak_bytes=c["phase_b"][
            "peak_bytes_est"]))
    torch.cuda.empty_cache()

    # -- d. tuned runs against the earlier phases' diagrams -----------------
    cfg = PHConfig(**MAIN_CONFIG)
    tuned_cfg = cfg.replace(autotune=True, autotune_cache=str(cache))
    runs, tuned_launches = {}, {}

    def tuned_run(label, untuned, first, steady, want, kernels):
        """The tuned engine's ``first`` call against ``want`` with its
        launches, then ``untuned`` and ``steady`` in turns."""
        reset_counts()
        out, first_ms = wall_ms(first)
        launches = read_counts()
        if not same_host_diagram(out.diagram, want):
            raise AssertionError(f"tuned {label} != its earlier phase")
        if min(launches[k] for k in kernels) <= 0:
            raise AssertionError(f"tuned {label} missed a kernel: "
                                 f"{launches}")
        for k, v in launches.items():
            tuned_launches[k] = tuned_launches.get(k, 0) + v
        untuned()                         # the untuned engine's first call
        runs[label] = dict(first_call_ms=first_ms, launches=launches,
                           equals_earlier_phase=True,
                           **wall_turns(untuned, steady))
        return out

    frame = ref["frame"]
    plain_e, tuned_e = PHEngine(cfg), PHEngine(tuned_cfg)
    eff = tuned_e._effective_config((MAIN_SIZE, MAIN_SIZE), torch.float32)
    if (eff.strip_rows, eff.tournament_width) != (
            best[MAIN_SIZE].strip_rows, at.DEFAULTS.tournament_width):
        raise AssertionError(f"tuned knobs not in effect: {eff}")
    tv = ref["threshold"]
    tuned_run("run", lambda: plain_e.run(frame, tv),
              lambda: tuned_e.run(frame), lambda: tuned_e.run(frame, tv),
              ref["main"],
              ("ph_phase_a", "ph_phase_c"))
    runs["run"]["strip_rows"] = eff.strip_rows

    survey, survey_tv = ref["survey"], ref["survey_tv"]
    plain_b, tuned_b = PHEngine(cfg), PHEngine(tuned_cfg)
    eff_b = tuned_b._effective_config((BATCH_SIZE, BATCH_SIZE),
                                      torch.float32)
    if eff_b.strip_rows != best[BATCH_SIZE].strip_rows:
        raise AssertionError(f"tuned batch knobs not in effect: {eff_b}")
    tuned_run("run_batch", lambda: plain_b.run_batch(survey, survey_tv),
              lambda: tuned_b.run_batch(survey),
              lambda: tuned_b.run_batch(survey, survey_tv), ref["mixed"],
              ("ph_phase_a", "ph_phase_c"))
    runs["run_batch"]["strip_rows"] = eff_b.strip_rows

    wide, tiled = ref["wide_frame"], ref["tiled"]
    mf, tf, tk = tiled["capacities"]
    tcfg = cfg.replace(max_features=mf, tile=TileSpec(
        max_features_per_tile=tf, max_candidates_per_tile=tk))
    plain_t = PHEngine(tcfg)
    tuned_t = PHEngine(tcfg.replace(autotune=True,
                                    autotune_cache=str(cache)))
    ttv = tiled["threshold"]
    rt = tuned_run("run_tiled", lambda: plain_t.run_tiled(wide, ttv),
                   lambda: tuned_t.run_tiled(wide, ttv),
                   lambda: tuned_t.run_tiled(wide, ttv), tiled["diagram"],
                   ("ph_phase_c",))
    if tuple(rt.config.tile.grid) != tuple(grid):
        raise AssertionError(f"tuned grid {grid} not in effect: "
                             f"{rt.config.tile.grid}")
    runs["run_tiled"].update(grid=list(grid), untuned_grid=list(
        tiled["grid"]), regrow_attempts=rt.regrow.attempts)
    del rt
    torch.cuda.empty_cache()

    # -- e. a lookup launches nothing and writes nothing -----------------------
    probe = PHEngine(tuned_cfg)
    before = cache.read_bytes()
    reset_counts()
    t0 = time.perf_counter()
    miss = probe._effective_config((1000, 1800), torch.float32)
    miss_grid = probe._tuned_grid((1000, 1800), torch.float32)
    hit = probe._effective_config((MAIN_SIZE, MAIN_SIZE), torch.float32)
    lookup_ms = (time.perf_counter() - t0) * 1e3
    if any(read_counts().values()) or miss is not probe.config \
            or miss_grid is not None or hit.strip_rows != eff.strip_rows \
            or cache.read_bytes() != before:
        raise AssertionError("an autotune lookup launched, measured or "
                             "wrote")

    # -- f. the ph_distances CLI ---------------------------------------------
    out_npz = ROOT / "build" / "ph_distances_smoke.npz"
    out_npz.unlink(missing_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cli_args = ("--images", str(DIST_CLI_IMAGES), "--size",
                str(DIST_CLI_SIZE), "--merge-impl", "boruvka", "--out",
                str(out_npz))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m",
                           "repro_torch.launch.ph_distances", *cli_args],
                          capture_output=True, text=True, env=env,
                          timeout=600, cwd=ROOT)
    cli_ms = (time.perf_counter() - t0) * 1e3
    if proc.returncode != 0:
        raise AssertionError(f"ph_distances exited {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    report = json.loads(proc.stdout[proc.stdout.index("{"):])
    frames = np.stack([astro.generate_image(i, DIST_CLI_SIZE)
                       for i in range(DIST_CLI_IMAGES)])
    deng = PHEngine(PHConfig(merge_impl="boruvka"))
    reset_counts()
    sw, bn = deng.distance_matrix(deng.run_batch(frames), n_dirs=N_DIRS)
    in_process_launches = read_counts()
    with np.load(out_npz) as z:
        cli_sw, cli_bn = z["sw"], z["bottleneck"]
    sw, bn = sw.cpu().numpy(), bn.cpu().numpy()
    if in_process_launches["ph_distance"] <= 0:
        raise AssertionError("in-process distance missed its kernel")
    if report["images"] != DIST_CLI_IMAGES or not np.array_equal(cli_bn, bn):
        raise AssertionError("ph_distances bn != distance_matrix in process")
    if not np.allclose(cli_sw, sw, rtol=1e-5, atol=0.0):
        raise AssertionError("ph_distances sw != distance_matrix in process "
                             "within rtol 1e-5")

    emit("autotune", cache=str(cache.relative_to(ROOT)),
         phase_a=dict(cases=n_cases, strip_rows=list(AUTOTUNE_STRIPS),
                      bitwise_equal=True, shape=[MAIN_SIZE] * 2,
                      by_strip_rows=strips),
         searches=searches,
         grid_search=dict(shape=list(tshape), seconds=grid_s,
                          trials_per_candidate=AUTOTUNE_GRID_TRIALS,
                          winner=list(grid), incumbent=list(
                              choose_grid(tshape, 1 << 20)),
                          rank_correlation=rank_correlation(
                              [t["model_bytes"] for t in grid_rows],
                              [t["seconds"] for t in grid_rows]),
                          candidates=grid_rows),
         search_launches=search_launches, tuned_runs=runs,
         tuned_launches=tuned_launches, lookup_ms=lookup_ms,
         lookup_launches=0,
         cli=dict(args=list(cli_args[:-1]), wall_ms=cli_ms,
                  images=report["images"], sw_mean=report["sw"]["mean"],
                  bn_max=report["bottleneck"]["max"],
                  bn_bitwise_equal=True, sw_max_rel_err=float(np.max(
                      np.abs(cli_sw - sw) / np.maximum(np.abs(sw), 1e-30))),
                  in_process_launches=in_process_launches),
         phase_s=time.perf_counter() - t_phase)
    return {"search_launches": search_launches,
            "tuned_launches": tuned_launches}


# The profiler range that ``recurrence_ranges`` opens around the
# recurrences, so that ``device_profile`` can attribute their device work.
RECURRENCE_RANGE = "lm_families.recurrence"


def _is_gemm(name: str) -> bool:
    return any(w in name.lower() for w in ("gemm", "xmma", "nvjet",
                                           "cutlass"))


def _in_recurrence(event) -> bool:
    while event is not None:
        if event.name == RECURRENCE_RANGE:
            return True
        event = event.cpu_parent
    return False


def device_profile(fn) -> dict:
    """One run of ``fn`` under ``torch.profiler``: its host wall ms (with
    the profiler's own cost), the device time of its kernels and copies
    summed (one stream, so they do not overlap), the idle share that
    leaves, device ms by kind and the five longest kernels.  Kernels
    launched by an op inside a ``RECURRENCE_RANGE`` (see
    ``recurrence_ranges``) count as "recurrence" unless they are GEMMs
    (the WKV's batched products), with their launches."""
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
    in_rec: dict = {}
    launches = rec_launches = 0
    for event in prof.events():
        if event.device_type == DeviceType.CUDA:
            if event.name == RECURRENCE_RANGE or getattr(
                    event, "is_user_annotation", False):
                continue                # a range's span, not a kernel
            launches += 1
            by_name[event.name] = by_name.get(event.name, 0.0) \
                + event.time_range.elapsed_us() / 1e3
        elif event.kernels and _in_recurrence(event):
            for kernel in event.kernels:
                if not _is_gemm(kernel.name):
                    rec_launches += 1
                    in_rec[kernel.name] = in_rec.get(kernel.name, 0.0) \
                        + kernel.duration / 1e3
    if not by_name:                     # the profiler saw no device work
        return {"wall_ms": wall_ms, "device_busy_ms": None}
    # "copy": dtype casts and copies (the float32 widening of the head and
    # of the KV cache among them); "sort_scatter_gather": sorts,
    # searchsorted and indexing (the MoE dispatch and combine, the
    # embedding lookup).
    kinds = {"flash_attention": 0.0, "gemm": 0.0, "recurrence": 0.0,
             "sort_scatter_gather": 0.0, "copy": 0.0, "other": 0.0}
    for name, ms in by_name.items():
        low = name.lower()
        rec = min(ms, in_rec.get(name, 0.0))
        kinds["recurrence"] += rec
        ms -= rec
        if "flash_fwd" in low:
            kinds["flash_attention"] += ms
        elif _is_gemm(name):
            kinds["gemm"] += ms
        elif any(w in low for w in ("sort", "scatter", "gather", "index",
                                    "searchsorted")):
            kinds["sort_scatter_gather"] += ms
        elif "copy" in low:
            kinds["copy"] += ms
        else:
            kinds["other"] += ms
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / wall_ms, "device_events": launches,
            "recurrence_launches": rec_launches,
            "device_ms_by_kind": kinds,
            "top_kernels": [[name[:80], ms] for name, ms in top]}


def hidden_tile_attention(q, k, v, *, causal=True, window=None,
                          q_offset=0, keys=CONTROL_KEYS):
    """The plain version with ``keys`` (by default ``CONTROL_KEYS``)
    hidden from every query: a deliberately wrong attention (a kernel
    that loses one KV tile), run as the LM phases' control."""
    import torch
    from repro_torch.kernels.flash_attention import ref as rfa
    b, h, sq, hd = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    q5 = q.reshape(b, kvh, h // kvh, sq, hd)
    s = torch.einsum("bngqd,bnkd->bngqk", q5.float(), k.float()) * hd ** -0.5
    visible = rfa.mask(sq, skv, causal=causal, window=window,
                       q_offset=q_offset, device=q.device)
    visible[:, keys] = False
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


def held_flash_calls(label: str, fn, picks=None):
    """Run ``fn`` with the flash kernel's wrapper recording its calls,
    then launch the picked ones again (``picks``: name -> call index, -1
    the last; by default the last) and hold each to the plain version
    element by element at ``FLASH_TOL`` of its dtype.  Returns (``fn()``,
    each pick's shapes, strides, dtype, options and max |diff|, the dtype
    of every call in order)."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as kfa
    from repro_torch.kernels.flash_attention import ref as rfa

    picks = picks or {"last": -1}
    wanted = {i for i in picks.values() if i >= 0}
    launch, kept, dtypes = kfa.flash_attention_fwd, {}, []

    def capture(q, k, v, **kw):
        if len(dtypes) in wanted:
            kept[len(dtypes)] = (q, k, v, kw)
        kept[-1] = (q, k, v, kw)
        dtypes.append(str(q.dtype).removeprefix("torch."))
        return launch(q, k, v, **kw)

    kfa.flash_attention_fwd = capture
    try:
        out = fn()
    finally:
        kfa.flash_attention_fwd = launch
    held = {}
    for name, index in picks.items():
        q, k, v, kw = kept[index]
        dtype = str(q.dtype).removeprefix("torch.")
        with torch.no_grad():     # a train step's q, k, v record grads
            got, want = launch(q, k, v, **kw), rfa.attention(q, k, v, **kw)
        err, tol = max_abs_diff(got, want), FLASH_TOL[dtype]
        if not torch.allclose(got.float(), want.float(), atol=tol,
                              rtol=tol):
            raise AssertionError(f"{label}: flash kernel != plain on call "
                                 f"{name} ({index}): max |diff| {err} over "
                                 f"{tol}")
        held[name] = {"call": index if index >= 0 else len(dtypes) - 1,
                      "q": list(q.shape), "q_strides": list(q.stride()),
                      "k": list(k.shape), "dtype": dtype, **kw,
                      "max_abs_err": err}
    return out, held, dtypes


def held_flash_call(label: str, fn):
    """``held_flash_calls`` of the last call: (``fn()``, its reading)."""
    out, held, _ = held_flash_calls(label, fn)
    return out, held["last"]


def logit_reading(got, want, tol=None) -> dict:
    """max |got - want| and its largest ratio to the logit tolerance
    ``tol`` = (atol, rtol), by default (``LOGIT_ATOL``, ``LOGIT_RTOL``)
    (``torch.allclose`` passes exactly when the ratio is at most 1)."""
    import torch
    if not bool(torch.isfinite(got).all()) or got.shape != want.shape:
        raise AssertionError(f"non-finite logits or shape "
                             f"{tuple(got.shape)} != {tuple(want.shape)}")
    atol, rtol = tol or (LOGIT_ATOL, LOGIT_RTOL)
    diff = (got.double() - want.double()).abs()
    ratio = diff / (atol + rtol * want.double().abs())
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
    # The same prefill again, its last layer's flash call (q, k, v as the
    # model hands them to the kernel) held element by element.
    (logits, caches), layer_call = held_flash_call(
        f"{LM_ARCH} prefill", lambda: model.prefill(
            params, batch, max_len=LM_SERVE["max_len"]))

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
            h, _, _ = transformer.backbone(params, transformer.embed_tokens(
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


class moe_routes_recorded:
    """Within the block, each MoE layer call records its router's expert
    ids (T, k) and which of its (token, slot) pairs it kept, in call order
    (one entry per layer of a forward or a decode step)."""

    def __enter__(self):
        import torch
        from repro_torch.models import moe
        self.saved, calls = moe._dispatch_indices, []

        def record(idx, spec, capacity):
            out = self.saved(idx, spec, capacity)
            tok_s, slot_s, _, _, keep = out
            pair_keep = torch.empty_like(keep).scatter_(
                0, tok_s * idx.shape[1] + slot_s, keep)
            calls.append((idx.clone(), pair_keep.view(idx.shape)))
            return out

        moe._dispatch_indices = record
        return calls

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe._dispatch_indices = self.saved


def drop_share(calls) -> float:
    """Share of the recorded (token, slot) pairs that were dropped."""
    kept = sum(int(keep.sum()) for _, keep in calls)
    return 1.0 - kept / sum(keep.numel() for _, keep in calls)


def held_readings(label: str, sound: tuple, control: tuple, held) -> dict:
    """``logit_reading`` of the (got, want) pairs ``sound`` and
    ``control`` over the rows ``held`` (a bool mask over their leading
    dims) and over all rows.  The held rows are those whose tokens took
    the same experts, and kept the same pairs, in every layer of both
    runs: a token that a rounding difference sent to another expert has
    other logits by design, not by error.  The hold rule then applies to
    the held rows, of which there must be at least one."""
    if not bool(held.any()):
        raise AssertionError(f"{label}: no row routed alike in both runs")
    out = {"rows": held.numel(), "held_rows": int(held.sum()),
           "all_rows": logit_reading(*sound),
           "all_rows_control": logit_reading(*control),
           "held": logit_reading(sound[0][held], sound[1][held]),
           "held_control": logit_reading(control[0][held],
                                         control[1][held])}
    hold(label, out["held"]["tol_ratio"], out["held_control"]["tol_ratio"])
    return out


def lm_moe_one(dev, arch: str, depth: int, reset_counts,
               read_counts) -> int:
    """One MoE decoder at full width and ``depth`` layers: ``serve``,
    its prefill's last flash call against the plain version, logits of
    the kernel route against the plain route, teacher-forced decode
    against the full sequence, profiles and ``loss_fn``.  Returns
    ``serve``'s flash launches."""
    import numpy as np
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve_lm
    from repro_torch.models import transformer
    from repro_torch.models.model import Model

    t_phase = time.perf_counter()
    full = get_config(arch)
    cfg = full.replace(num_layers=depth)
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg)                          # device left at its default
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in params.parameters())
    reset_counts()
    gen, stats = serve_lm.serve(arch, smoke=False, params=params,
                                verbose=False, **LM_SERVE)
    launches = read_counts()
    want = dict.fromkeys(launches, 0) | {"flash_attention": depth}
    if launches != want:
        raise AssertionError(f"{arch}: serve launched {launches}, expected "
                             f"{want} (one flash launch per layer of the "
                             f"prefill)")
    if gen.shape != (LM_SERVE["batch"], LM_SERVE["gen_len"]) or \
            gen.min() < 0 or gen.max() >= cfg.vocab_size:
        raise AssertionError(f"{arch}: serve tokens out of range")

    b, p, max_len = (LM_SERVE[k] for k in ("batch", "prompt_len", "max_len"))
    prompts = torch.from_numpy(serve_lm.make_prompts(
        cfg.vocab_size, b, p, 0)).to(dev).long()
    batch = {"tokens": prompts}
    with moe_routes_recorded() as prefill_routes:
        (logits, caches), layer_call = held_flash_call(
            f"{arch} prefill", lambda: model.prefill(params, batch,
                                                     max_len=max_len))
    if not (torch.argmax(logits[:, -1], -1).cpu().numpy()
            == gen[:, 0]).all():
        raise AssertionError(f"{arch}: prefill's greedy token != serve's")

    def logits_at(prm, tokens, positions, plain):
        with torch.no_grad():
            h, _, _ = transformer.backbone(
                prm, transformer.embed_tokens(prm, tokens), plain=plain)
            return transformer.logits_from_hidden(prm, h[:, positions])

    # Teacher-forced decode at the published capacity factor: its
    # capacity (ceil(B·k·cf/E)) and the full sequence's (the floor over
    # B·S tokens) drop other tokens, so it is read, not held.
    forced = torch.from_numpy(gen[:, :TEACHER_STEPS]).to(dev).long()
    seq = torch.cat([prompts, forced], dim=1)
    tail = torch.arange(p - 1, p + TEACHER_STEPS, device=dev)
    steps = [logits[:, 0]]
    with moe_routes_recorded() as decode_routes:
        for j in range(TEACHER_STEPS):
            lg, caches = model.decode_step(params, forced[:, j:j + 1],
                                           caches)
            steps.append(lg[:, 0])
    published_decode = logit_reading(torch.stack(steps, 1),
                                     logits_at(params, seq, tail, False))
    drops = {"prefill": drop_share(prefill_routes),
             "decode": drop_share(decode_routes)}
    del steps, logits, prefill_routes, decode_routes

    # Logits at MOE_POSITIONS: kernel route against plain route, with
    # the hidden-tile control, on the rows routed alike in both runs.
    positions = torch.tensor(MOE_POSITIONS, device=dev)
    with moe_routes_recorded() as kernel_routes:
        k_logits = logits_at(params, prompts, positions, False)
    with moe_routes_recorded() as plain_routes:
        p_logits = logits_at(params, prompts, positions, True)
    with plain_attention_replaced(hidden_tile_attention):
        c_logits = logits_at(params, prompts, positions, True)
    route_shares = [float((ki == pi).float().mean()) for (ki, _), (pi, _)
                    in zip(kernel_routes, plain_routes)]
    alike = torch.stack([((ki == pi) & (kk == pk)).all(1) for (ki, kk),
                         (pi, pk) in zip(kernel_routes, plain_routes)])
    alike = alike.all(0).view(b, p)
    logits_read = held_readings(
        f"{arch} logits kernel vs plain", (k_logits, p_logits),
        (c_logits, p_logits), alike[:, positions])
    del k_logits, p_logits, c_logits, kernel_routes, plain_routes

    # Teacher-forced decode against one full-sequence forward, on the
    # same weights at capacity_factor = E / k, where no pair can drop.
    nd_cfg = cfg.replace(capacity_factor=cfg.num_experts / cfg.top_k)
    nd = transformer.params_from_state(nd_cfg, params.state_dict(),
                                       device=dev)
    nd_model = Model(nd_cfg)
    with moe_routes_recorded() as nd_prefill:
        lg, nd_caches = nd_model.prefill(nd, batch, max_len=max_len)
    steps = [lg[:, 0]]
    with moe_routes_recorded() as nd_decode:
        for j in range(TEACHER_STEPS):
            lg, nd_caches = nd_model.decode_step(nd, forced[:, j:j + 1],
                                                 nd_caches)
            steps.append(lg[:, 0])
    steps = torch.stack(steps, 1)
    del nd_caches
    with moe_routes_recorded() as nd_full:
        full_lg = logits_at(nd, seq, tail, False)
    with plain_attention_replaced(hidden_tile_attention):
        ctrl_lg = logits_at(nd, seq, tail, True)
    if drop_share(nd_prefill + nd_decode + nd_full) != 0.0:
        raise AssertionError(f"{arch}: a pair dropped at capacity factor "
                             f"E / k")
    # Row (b, j) is the logits of the token at position p - 1 + j: the
    # prompt's last (from the prefill) or decode step j - 1's.
    alike = torch.ones(b, TEACHER_STEPS + 1, dtype=torch.bool, device=dev)
    kk = cfg.top_k
    for layer, (fi, fk) in enumerate(nd_full):
        fi = fi.view(b, p + TEACHER_STEPS, kk)[:, p - 1:]
        fk = fk.view(b, p + TEACHER_STEPS, kk)[:, p - 1:]
        pi, pk = (t.view(b, p, kk)[:, -1] for t in nd_prefill[layer])
        runs = [(pi, pk)] + [nd_decode[j * depth + layer]
                             for j in range(TEACHER_STEPS)]
        for j, (ri, rk) in enumerate(runs):
            alike[:, j] &= ((fi[:, j] == ri) & (fk[:, j] == rk)).all(-1)
    decode_read = held_readings(
        f"{arch} teacher-forced decode vs full sequence (no drops)",
        (steps, full_lg), (steps, ctrl_lg), alike)
    del nd, steps, full_lg, ctrl_lg, nd_prefill, nd_decode, nd_full

    prefill_prof = device_profile(lambda: model.prefill(
        params, batch, max_len=max_len))
    decode_prof = device_profile(lambda: model.decode_step(
        params, forced[:, :1], caches))
    del caches

    lb, ls = LM_FORWARD["batch"], LM_FORWARD["seq"]
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                             (lb, ls + 1))
    toks = torch.from_numpy(toks).to(dev)
    reset_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        loss, metrics = model.loss_fn(params, {
            "inputs": toks[:, :-1], "targets": toks[:, 1:],
            "mask": torch.ones(lb, ls, device=dev)})
        torch.cuda.synchronize()
    loss_ms = (time.perf_counter() - t0) * 1e3
    loss_launches = read_counts()
    loss, aux = float(loss), float(metrics["aux"])
    if loss_launches["flash_attention"] != depth or not (
            math.isfinite(loss) and math.isfinite(aux) and aux > 0):
        raise AssertionError(f"{arch}: loss_fn launched {loss_launches}, "
                             f"loss {loss}, aux {aux}")
    peak = torch.cuda.max_memory_allocated()
    emit("lm_moe", arch=arch, layers=depth, published_layers=full.num_layers,
         d_model=cfg.d_model, heads=[cfg.num_heads, cfg.num_kv_heads],
         head_dim=cfg.head_dim, d_ff=cfg.d_ff, experts=cfg.num_experts,
         top_k=cfg.top_k, router=cfg.router_type,
         capacity_factor=cfg.capacity_factor, norm=cfg.norm_type,
         shared_expert=cfg.moe_shared_expert, params=n_params,
         dtype=cfg.dtype, resident_bytes_before=resident, **LM_SERVE,
         init_s=init_s, prefill_ms=stats["prefill_ms"],
         decode_tokens_per_s=stats["decode_tokens_per_s"],
         launches=launches, max_memory_allocated=peak,
         last_layer_flash_call=layer_call,
         logit_tolerance=[LOGIT_ATOL, LOGIT_RTOL],
         control_hidden_keys=[CONTROL_KEYS.start, CONTROL_KEYS.stop],
         route_agreement_by_layer=route_shares,
         drop_share_published_factor=drops,
         logit_positions=list(MOE_POSITIONS),
         logits_kernel_vs_plain=logits_read,
         no_drop_capacity_factor=nd_cfg.capacity_factor,
         teacher_forced_steps=TEACHER_STEPS,
         decode_vs_full_no_drop=decode_read,
         decode_vs_full_published_factor=published_decode,
         prefill_profile=prefill_prof, decode_step_profile=decode_prof,
         loss_batch=[lb, ls], loss=loss, ce=float(metrics["ce"]), aux=aux,
         loss_ms=loss_ms, loss_launches=loss_launches,
         sample_output=stats["sample_output"],
         phase_s=time.perf_counter() - t_phase)
    return launches["flash_attention"]


class recurrence_ranges:
    """Within the block, the recurrences (``rwkv6.wkv_scan``,
    ``wkv_chunked``; ``rglru.rglru``, ``rglru_step``, ``_causal_conv1d``)
    run inside ``RECURRENCE_RANGE`` profiler ranges, and each one's last
    call is recorded: name -> (args, kwargs)."""

    TARGETS = (("rwkv6", ("wkv_scan", "wkv_chunked")),
               ("rglru", ("rglru", "rglru_step", "_causal_conv1d")))

    def __enter__(self):
        import importlib
        self.saved, self.last = [], {}
        for module, names in self.TARGETS:
            mod = importlib.import_module(f"repro_torch.models.{module}")
            for name in names:
                fn = getattr(mod, name)
                self.saved.append((mod, name, fn))
                setattr(mod, name, self._ranged(name, fn))
        return self.last

    def _ranged(self, name, fn):
        import torch

        def call(*args, **kw):
            self.last[name] = (args, kw)
            with torch.profiler.record_function(RECURRENCE_RANGE):
                return fn(*args, **kw)
        return call

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


class wkv_state_zeroed:
    """Within the block, ``wkv_chunked`` over more than ``at`` tokens
    starts again from a zero state at token ``at``: a deliberately wrong
    recurrence (one that loses its state between two chunks), rwkv6's
    control."""

    def __init__(self, at: int):
        self.at = at

    def __enter__(self):
        import torch
        from repro_torch.models import rwkv6
        fn, at = rwkv6.wkv_chunked, self.at
        self.saved = fn

        def dropped(r, k, v, w, u, state, **kw):
            if r.shape[1] <= at:
                return fn(r, k, v, w, u, state, **kw)
            head, s1 = fn(r[:, :at], k[:, :at], v[:, :at], w[:, :at], u,
                          state, **kw)
            tail, s2 = fn(r[:, at:], k[:, at:], v[:, at:], w[:, at:], u,
                          torch.zeros_like(s1), **kw)
            return torch.cat([head, tail], dim=1), s2

        rwkv6.wkv_chunked = dropped

    def __exit__(self, *exc):
        from repro_torch.models import rwkv6
        rwkv6.wkv_chunked = self.saved


class wkv_forms_swapped:
    """Within the block, ``wkv_chunked`` computes the scan form."""

    def __enter__(self):
        from repro_torch.models import rwkv6
        self.saved = fn = rwkv6.wkv_chunked
        rwkv6.wkv_chunked = lambda r, k, v, w, u, state, **kw: \
            rwkv6.wkv_scan(r, k, v, w, u, state)

    def __exit__(self, *exc):
        from repro_torch.models import rwkv6
        rwkv6.wkv_chunked = self.saved


def recurrence_timings(calls) -> dict:
    """Device time and launches of one layer's recurrence, on the inputs
    it had in the prefill: rwkv6's ``wkv_chunked`` (device time; and
    held to ``wkv_scan`` in float32 at ``WKV_TOL``) and ``wkv_scan`` (one
    call's time: its token loop enqueues more than a device sleep covers);
    recurrentgemma's ``rglru`` and its log-depth scan alone."""
    import torch
    from repro_torch.models import rglru, rwkv6

    with torch.no_grad():
        return {**_wkv_timings(calls, rwkv6), **_rglru_timings(calls, rglru)}


def _wkv_timings(calls, rwkv6) -> dict:
    out = {}
    if "wkv_chunked" in calls:
        args, kw = calls["wkv_chunked"]
        r = args[0]
        wide = [a.float() for a in args[:4]] + list(args[4:])
        chunked, c_state = rwkv6.wkv_chunked(*wide, **kw)
        scan, s_state = rwkv6.wkv_scan(*wide)
        scale = max(1.0, float(scan.abs().max()))
        err = max_abs_diff(chunked, scan) / scale
        state_err = max_abs_diff(c_state, s_state) / max(
            1.0, float(s_state.abs().max()))
        if not (err <= WKV_TOL and state_err <= WKV_TOL):
            raise AssertionError(f"wkv_chunked != wkv_scan at "
                                 f"{tuple(r.shape)}: {err}, state "
                                 f"{state_err} over {WKV_TOL}")
        del chunked, scan, c_state, s_state, wide
        out["wkv"] = {
            "shape": list(r.shape),
            "dtype": str(r.dtype).removeprefix("torch."), "chunk":
            kw.get("chunk", 32), "chunked_vs_scan_rel_err": err,
            "state_rel_err": state_err, "tolerance": WKV_TOL,
            "chunked_device_ms": device_ms(
                lambda: rwkv6.wkv_chunked(*args, **kw), reps=5),
            "chunked_launches": device_profile(
                lambda: rwkv6.wkv_chunked(*args, **kw))["device_events"],
            "scan_ms": cuda_ms(lambda: rwkv6.wkv_scan(*args[:6]), reps=1),
            "scan_launches": device_profile(
                lambda: rwkv6.wkv_scan(*args[:6]))["device_events"]}
    return out


def _rglru_timings(calls, rglru) -> dict:
    out = {}
    if "rglru" in calls:
        (p, x, h0, *_), _ = calls["rglru"]
        a, b = rglru._gated(p, x.float())
        out["rglru"] = {
            "shape": list(x.shape),
            "dtype": str(x.dtype).removeprefix("torch."),
            "device_ms": device_ms(lambda: rglru.rglru(p, x, h0), reps=5),
            "launches": device_profile(
                lambda: rglru.rglru(p, x, h0))["device_events"],
            "scan_device_ms": device_ms(lambda: rglru.linear_scan(a, b),
                                        reps=5),
            "scan_launches": device_profile(
                lambda: rglru.linear_scan(a, b))["device_events"]}
    return out


def prompt_positions(p: int) -> list:
    """Every 64th position of a p-token prompt, and its last."""
    return sorted(set(range(63, p, 64)) | {p - 1})


def lm_family_one(dev, arch: str, reset_counts, read_counts) -> dict:
    """One architecture of ``LM_FAMILIES`` at full width and depth:
    ``serve`` and its launches, the prefill's flash calls held to the
    plain version, the prompt's logits of the kernel route against the
    plain route (where a kernel runs), teacher-forced decode against one
    full-sequence forward (held in ``FAMILY_LIMITS``' dtype, read in the
    served one), each with a control that must fail, the recurrences
    timed alone, profiles.  Returns serve's flash launches and the
    recurrences' timings."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve_lm
    from repro_torch.models import encdec, transformer
    from repro_torch.models.model import Model

    t_phase = time.perf_counter()
    shape, flash_per_prefill = LM_FAMILIES[arch]
    limits = FAMILY_LIMITS[arch]
    cfg = get_config(arch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg)                          # device left at its default
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in params.parameters())
    reset_counts()
    gen, stats = serve_lm.serve(arch, smoke=False, params=params,
                                verbose=False, **shape)
    launches = read_counts()
    want = dict.fromkeys(launches, 0) | {"flash_attention": flash_per_prefill}
    if launches != want:
        raise AssertionError(f"{arch}: serve launched {launches}, expected "
                             f"{want}")
    # Whisper's logits are not masked past the vocabulary (nor are the
    # reference's), so its greedy tokens may be padding ids.
    vocab = cfg.padded_vocab if cfg.is_encdec else cfg.vocab_size
    b, p, max_len = (shape[k] for k in ("batch", "prompt_len", "max_len"))
    if gen.shape != (b, shape["gen_len"]) or gen.min() < 0 or \
            gen.max() >= vocab:
        raise AssertionError(f"{arch}: serve tokens out of range")

    inputs = serve_lm.model_inputs(cfg, b, p, 0, dev)
    forced = torch.from_numpy(gen[:, :TEACHER_STEPS]).to(dev).long()
    seq = torch.cat([inputs["tokens"], forced], dim=1)
    control_keys = FAMILY_CONTROL_KEYS.get(arch, (CONTROL_KEYS,) * 2)
    prompt_tile, decode_tile = (
        functools.partial(hidden_tile_attention, keys=keys)
        for keys in control_keys)

    def prefill(m=model, prm=params):
        return m.prefill(prm, inputs, max_len=max_len)

    def logits_at(prm, tokens, positions, plain):
        with torch.no_grad():
            if prm.cfg.is_encdec:
                enc = encdec.encode(prm, inputs["frames"], plain=plain)
                h = encdec.decoder_hidden(prm, enc, tokens, plain=plain)
                return encdec.logits_from_hidden(prm, h[:, positions])
            h, _, _ = transformer.backbone(
                prm, transformer.embed_tokens(prm, tokens), plain=plain)
            return transformer.logits_from_hidden(prm, h[:, positions])

    held, dtypes, prompt_read = {}, [], None
    with recurrence_ranges() as rec_calls:
        if flash_per_prefill:
            (logits, caches), held, dtypes = held_flash_calls(
                f"{arch} prefill", prefill, FAMILY_HELD_CALLS[arch])
        else:
            logits, caches = prefill()
    if not (torch.argmax(logits[:, -1], -1).cpu().numpy()
            == gen[:, 0]).all():
        raise AssertionError(f"{arch}: prefill's greedy token != serve's")
    if flash_per_prefill:
        # The prefill's logits and the prompt's at every 64th position:
        # the kernel route against the plain route, and the hidden-tile
        # control against the plain route.
        tol = limits["prompt"]
        plain_last, _ = prefill(Model(cfg, plain=True))
        pos = torch.tensor(prompt_positions(p), device=dev)
        plain_pos = logits_at(params, inputs["tokens"], pos, True)
        with plain_attention_replaced(prompt_tile):
            control_pos = logits_at(params, inputs["tokens"], pos, True)
        prompt_read = {
            "positions": pos.tolist(), "limits": list(tol),
            "prefill_kernel_vs_plain": logit_reading(logits, plain_last,
                                                     tol),
            "kernel_vs_plain": logit_reading(
                logits_at(params, inputs["tokens"], pos, False), plain_pos,
                tol),
            "control_vs_plain": logit_reading(control_pos, plain_pos, tol)}
        hold(f"{arch} prompt logits kernel vs plain",
             max(prompt_read["prefill_kernel_vs_plain"]["tol_ratio"],
                 prompt_read["kernel_vs_plain"]["tol_ratio"]),
             prompt_read["control_vs_plain"]["tol_ratio"])
        del plain_last, plain_pos, control_pos
    timings = recurrence_timings(rec_calls)
    del rec_calls

    def teacher_forced(m, prm, start):
        """Logits of the prompt's last token and of ``TEACHER_STEPS``
        decode steps of serve's tokens, from a prefill (``start``: its
        logits and caches, or None to run one)."""
        lg, cch = start or prefill(m, prm)
        steps = [lg[:, 0]]
        for j in range(TEACHER_STEPS):
            lg, cch = m.decode_step(prm, forced[:, j:j + 1], cch)
            steps.append(lg[:, 0])
        return torch.stack(steps, 1), cch

    def decode_readings(prm, steps, tol=None):
        """Decode steps against one full-sequence forward (the recurrent
        states against the chunked or scanned form, the ring caches past
        their wrap, the cross caches), and against the control."""
        tol = tol or (LOGIT_ATOL, LOGIT_RTOL)
        tail = slice(p - 1, None)
        sound = logit_reading(steps, logits_at(prm, seq, tail, False), tol)
        if "rwkv" in cfg.block_pattern:
            with wkv_state_zeroed(WKV_CONTROL_AT):
                control = logit_reading(steps, logits_at(prm, seq, tail,
                                                         False), tol)
        else:
            with plain_attention_replaced(decode_tile):
                control = logit_reading(steps, logits_at(prm, seq, tail,
                                                         True), tol)
        return {"limits": list(tol), "decode_vs_full": sound,
                "decode_vs_control_full": control}

    # Served dtype: read (and held where FAMILY_LIMITS holds it).
    steps, caches = teacher_forced(model, params, (logits, caches))
    held_dtype, atol, rtol = limits["decode"]
    served = decode_readings(params, steps, (atol, rtol)
                             if held_dtype == cfg.dtype else None)
    if held_dtype == cfg.dtype:
        decode_held = served
    else:
        # The same weights widened: decode and the full sequence then
        # differ by float32 rounding alone.
        wide_cfg = cfg.replace(dtype=held_dtype)
        wide_model = Model(wide_cfg)
        wide = wide_model.load(params.state_dict())
        wide_steps, _ = teacher_forced(wide_model, wide, None)
        decode_held = decode_readings(wide, wide_steps, (atol, rtol))
        del wide, wide_steps
    decode_held["dtype"] = held_dtype
    hold(f"{arch} teacher-forced decode vs full sequence ({held_dtype})",
         decode_held["decode_vs_full"]["tol_ratio"],
         decode_held["decode_vs_control_full"]["tol_ratio"])
    if "rwkv" in cfg.block_pattern:
        # The yardstick of bfloat16 rounding here: the full forward with
        # the scan form of the WKV against the chunked form (read).
        tail = slice(p - 1, None)
        with wkv_forms_swapped():
            scan_full = logits_at(params, seq, tail, False)
        served["full_scan_vs_chunked"] = logit_reading(
            scan_full, logits_at(params, seq, tail, False))
        del scan_full

    with recurrence_ranges():
        prefill_prof = device_profile(prefill)
        decode_prof = device_profile(lambda: model.decode_step(
            params, forced[:, :1], caches))
    del caches, logits, steps
    emit("lm_families", arch=arch, layers=cfg.num_layers,
         encoder_layers=cfg.encoder_layers, blocks=list(cfg.block_pattern),
         d_model=cfg.d_model, heads=[cfg.num_heads, cfg.num_kv_heads],
         head_dim=cfg.head_dim, d_ff=cfg.d_ff, vocab=cfg.vocab_size,
         params=n_params, dtype=cfg.dtype, **shape,
         encoder_seq=cfg.encoder_seq or None, init_s=init_s,
         prefill_ms=stats["prefill_ms"],
         decode_tokens_per_s=stats["decode_tokens_per_s"],
         launches=launches, max_memory_allocated=torch.cuda
         .max_memory_allocated(), held_flash_calls=held,
         flash_call_dtypes={d: dtypes.count(d) for d in sorted(set(dtypes))},
         control_keys={"prompt": [control_keys[0].start,
                                  control_keys[0].stop],
                       "decode": [control_keys[1].start,
                                  control_keys[1].stop]},
         prompt_logits=prompt_read, teacher_forced_steps=TEACHER_STEPS,
         decode_served_dtype=served, decode_held=decode_held,
         recurrence=timings, prefill_profile=prefill_prof,
         decode_step_profile=decode_prof,
         sample_output=stats["sample_output"],
         phase_s=time.perf_counter() - t_phase)
    return {"flash_launches": launches["flash_attention"],
            "recurrence": timings}


def phase_lm_families(dev, reset_counts, read_counts) -> dict:
    """The architectures of ``LM_FAMILIES``, one after the other (each
    one's weights are freed before the next is drawn)."""
    import torch
    t0 = time.perf_counter()
    out = {}
    for arch in LM_FAMILIES:
        out[arch] = lm_family_one(dev, arch, reset_counts, read_counts)
        torch.cuda.empty_cache()
    emit("lm_families_done", archs=list(LM_FAMILIES),
         phase_s=time.perf_counter() - t0)
    return out


def phase_lm_moe(dev, reset_counts, read_counts) -> dict:
    """Both MoE decoders of ``MOE_DEPTH``, one after the other (each
    one's weights are freed before the next is drawn).  Returns serve's
    flash launches by arch."""
    return {arch: lm_moe_one(dev, arch, depth, reset_counts, read_counts)
            for arch, depth in MOE_DEPTH.items()}


class train_ranges:
    """Within the block, the flash op's backward (the plain recompute and
    its gradient) and ``AdamW.update`` run inside the profiler ranges of
    ``TRAIN_RANGES``."""

    def __enter__(self):
        import torch
        from repro_torch.kernels.flash_attention import ops
        from repro_torch.optim.adamw import AdamW
        backward, update = ops._FlashAttention.backward, AdamW.update
        self.saved = backward, update
        names = list(TRAIN_RANGES)

        def ranged_backward(ctx, g):
            with torch.profiler.record_function(names[0]):
                return backward(ctx, g)

        def ranged_update(opt, *args, **kw):
            with torch.profiler.record_function(names[1]):
                return update(opt, *args, **kw)

        ops._FlashAttention.backward = staticmethod(ranged_backward)
        AdamW.update = ranged_update

    def __exit__(self, *exc):
        from repro_torch.kernels.flash_attention import ops
        from repro_torch.optim.adamw import AdamW
        ops._FlashAttention.backward = staticmethod(self.saved[0])
        AdamW.update = self.saved[1]


def _train_kind(event, name: str) -> str:
    while event is not None:
        if event.name in TRAIN_RANGES:
            return TRAIN_RANGES[event.name]
        event = event.cpu_parent
    if "flash_fwd" in name.lower():
        return "flash_forward"
    return "gemm" if _is_gemm(name) else "other"


def train_step_profile(fn) -> dict:
    """One run of ``fn`` (a train step) under ``torch.profiler`` within
    ``train_ranges``: host wall ms, device busy ms (kernels and copies
    summed; one stream), the idle share, and device ms by kind: the flash
    kernel's forward calls (the forward pass and the remat recompute),
    the attention backward (every kernel launched inside the flash op's
    backward: the plain recompute's einsums and softmax and their
    gradients), the optimizer (every kernel inside ``AdamW.update``),
    the other GEMMs, the rest."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with train_ranges(), profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy, launches = 0.0, 0
    kinds = dict.fromkeys(("gemm", "flash_forward", "attention_backward",
                           "optimizer", "other"), 0.0)
    for event in prof.events():
        if event.device_type == DeviceType.CUDA:
            if event.name in TRAIN_RANGES or getattr(
                    event, "is_user_annotation", False):
                continue                # a range's span, not a kernel
            launches += 1
            busy += event.time_range.elapsed_us() / 1e3
        else:
            for kernel in event.kernels:
                kinds[_train_kind(event, kernel.name)] += \
                    kernel.duration / 1e3
    if not busy:                        # the profiler saw no device work
        return {"wall_ms": wall_ms, "device_busy_ms": None}
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / wall_ms, "device_events": launches,
            "device_ms_by_kind": kinds,
            "unattributed_ms": busy - sum(kinds.values())}


def train_batch(cfg, shape: dict, dev) -> dict:
    """``TokenStream`` batch 0 of ``shape`` on the card."""
    import torch
    from repro_torch.data.tokens import TokenStream
    host = TokenStream(cfg.vocab_size, shape["seq_len"],
                       shape["global_batch"]).batch_at(0)
    return {k: torch.from_numpy(v).to(dev) for k, v in host.items()}


def train_step_readings(cfg, params, start: dict, batch: dict,
                        reset_counts, read_counts, *,
                        plain: bool = False) -> dict:
    """``params`` set to ``start``, then one ``train_bundle`` step
    (``AdamW()``, a fresh state) through the kernel or the plain
    attention, and the loss after it by the same route: the step's loss,
    grad norm, loss after, launches, peak memory and wall ms."""
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import AdamW

    with torch.no_grad():
        for k, p in params.named_parameters():
            p.copy_(start[k])
    b, s = batch["inputs"].shape
    bundle = steps.train_bundle(cfg, ShapeConfig("lm_train", s, b, "train"),
                                plain=plain)
    opt_state = AdamW().init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    _, opt_state, m = bundle.fn(params, opt_state, batch)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    moments = torch.cat([mu.flatten() for k, mu in opt_state.mu.items()
                         if ".attn.w" in k])
    del opt_state
    with torch.no_grad():
        after, _ = Model(cfg, plain=plain).loss_fn(params, batch)
    out = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
           "loss_after": float(after), "lr": float(m["lr"]),
           "launches": launches, "max_memory_allocated": peak,
           "wall_ms": wall_ms}
    for k in ("loss", "grad_norm", "loss_after"):
        if not math.isfinite(out[k]):
            raise AssertionError(f"{cfg.name} train step: {k} {out[k]}")
    if not bool(torch.isfinite(moments).all()):
        raise AssertionError(f"{cfg.name} train step: non-finite moments")
    return out, moments


def hold_train_step(label: str, held: tuple, sound: tuple, plain: tuple,
                    control: tuple) -> dict:
    """The kernel's step against the plain step, each a (readings, first
    moments) pair of ``train_step_readings``: loss before and after in
    units of ``LOSS_ATOL``, grad norm of ``GRAD_NORM_RTOL`` of the plain
    run's, the attention projections' first moments (relative L2) of
    ``MOMENT_RTOL``.  The readings of ``held`` must pass and the
    hidden-tile control must fail each of them; the others are read."""
    import torch
    want, want_mu = plain

    def ratios(run):
        r, mu = run
        return {"loss": abs(r["loss"] - want["loss"]) / LOSS_ATOL,
                "loss_after": abs(r["loss_after"] - want["loss_after"])
                / LOSS_ATOL,
                "grad_norm": abs(r["grad_norm"] - want["grad_norm"])
                / (GRAD_NORM_RTOL * want["grad_norm"]),
                "attention_moments": float(torch.linalg.vector_norm(
                    mu - want_mu) / torch.linalg.vector_norm(want_mu))
                / MOMENT_RTOL}
    got, ctl = ratios(sound), ratios(control)
    for k in held:
        hold(f"{label}: {k}", got[k], ctl[k])
    return {"held": list(held), "kernel_tol_ratio": got,
            "control_tol_ratio": ctl}


def train_kernel_vs_plain(cfg, shape: dict, dev, reset_counts, read_counts,
                          picks: dict) -> dict:
    """Weights drawn from seed 0 on the card; one train step through the
    kernel (its flash calls of ``picks`` held to plain), one through the
    plain attention and one through the hidden-tile control, from the
    same weights on the same batch.  Returns the readings and, under
    ``"params"`` / ``"start"`` / ``"batch"``, what a caller goes on
    with."""
    import torch
    from repro_torch.models.model import Model

    params = Model(cfg).init(torch.Generator(device=dev).manual_seed(0))
    start = {k: p.detach().clone() for k, p in params.named_parameters()}
    batch = train_batch(cfg, shape, dev)
    step = functools.partial(train_step_readings, cfg, params, start, batch,
                             reset_counts, read_counts)
    kernel, held, dtypes = held_flash_calls(f"{cfg.name} train step", step,
                                            picks)
    plain = step(plain=True)
    with plain_attention_replaced(hidden_tile_attention):
        control = step(plain=True)
    expected = 2 * cfg.num_layers if cfg.remat == "full" else cfg.num_layers
    want = dict.fromkeys(kernel[0]["launches"], 0) | {
        "flash_attention": expected}
    if kernel[0]["launches"] != want or any(plain[0]["launches"].values()):
        raise AssertionError(f"{cfg.name} train step launched "
                             f"{kernel[0]['launches']} (plain route "
                             f"{plain[0]['launches']}), expected {want}")
    readings = hold_train_step(f"{cfg.name} train step",
                               TRAIN_HELD[cfg.name], kernel, plain, control)
    return {"kernel": kernel[0], "plain": plain[0], "control": control[0],
            "held_flash_calls": held, "flash_call_dtypes": sorted(set(dtypes)),
            **readings, "params": params, "start": start, "batch": batch}


def train_resume(params, start: dict, root: Path, dev) -> dict:
    """``train`` of ``TRAIN_STEPS`` steps from ``start`` with a checkpoint
    every ``TRAIN_CKPT_EVERY``; the last checkpoint's parameters equal
    the trained ones bitwise; an asynchronous save holds its values
    while the parameters are updated in place at once; then the run is
    resumed from its first checkpoint, whose later losses must agree
    with the uninterrupted run's within ``LOSS_ATOL``."""
    import shutil
    import torch
    from repro_torch.checkpoint import ckpt
    from repro_torch.launch.train import train

    with torch.no_grad():
        for k, p in params.named_parameters():
            p.copy_(start[k])
    kw = dict(steps=TRAIN_STEPS, smoke=False, ckpt_every=TRAIN_CKPT_EVERY,
              log_every=1, verbose=False, params=params, **TRAIN_SHAPE)
    ckpt_dir = root / "run"
    t0 = time.perf_counter()
    whole = train(TRAIN_ARCH, ckpt_dir=str(ckpt_dir), **kw)
    train_s = time.perf_counter() - t0
    losses = [h["loss"] for h in whole]
    if len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"train losses {losses}")
    target = ({k: torch.empty_like(p, device="meta")
               for k, p in params.named_parameters()},)
    t0 = time.perf_counter()
    (saved,), _, step = ckpt.restore(ckpt_dir, target, device=dev)
    restore_s = time.perf_counter() - t0
    unequal = [k for k, p in params.named_parameters()
               if not torch.equal(saved[k], p.detach())]
    if step != TRAIN_STEPS or unequal:
        raise AssertionError(f"checkpoint of step {step}: {len(unequal)} "
                             f"tensors differ from the trained ones, e.g. "
                             f"{unequal[:3]}")
    del saved

    # An asynchronous save, then an in-place update at once (as the next
    # train step makes): the checkpoint holds the values of the save.
    before = {k: p.detach().clone() for k, p in params.named_parameters()}
    saver = ckpt.AsyncCheckpointer()
    saver.save(root / "async", 1, (params,))
    with torch.no_grad():
        for p in params.parameters():
            p.add_(1.0)
    saver.join()
    (back,), _, _ = ckpt.restore(root / "async", target, device=dev)
    if not all(torch.equal(back[k], before[k]) for k in before):
        raise AssertionError("an asynchronous save caught the in-place "
                             "update that followed it")
    del back, before

    # Killed after the first checkpoint: its later checkpoint removed,
    # the same call resumes from step TRAIN_CKPT_EVERY.
    shutil.rmtree(ckpt_dir / f"step_{TRAIN_STEPS:08d}")
    t0 = time.perf_counter()
    resumed = train(TRAIN_ARCH, ckpt_dir=str(ckpt_dir), **kw)
    resume_s = time.perf_counter() - t0
    if [h["step"] for h in resumed] != list(range(TRAIN_CKPT_EVERY,
                                                   TRAIN_STEPS)):
        raise AssertionError(f"resumed steps {[h['step'] for h in resumed]}")
    diffs = [abs(a["loss"] - b["loss"])
             for a, b in zip(whole[TRAIN_CKPT_EVERY:], resumed)]
    if not max(diffs) <= LOSS_ATOL:
        raise AssertionError(f"resumed losses differ by {max(diffs)} "
                             f"(limit {LOSS_ATOL})")
    ckpt_bytes = sum(f.stat().st_size for f in ckpt_dir.rglob("*.npy")
                     if f.parent.name == f"step_{TRAIN_STEPS:08d}")
    return {"history": whole, "resumed": resumed,
            "resume_max_loss_diff": max(diffs), "loss_atol": LOSS_ATOL,
            "train_s": train_s, "resume_s": resume_s,
            "restore_s": restore_s, "checkpoint_bytes": ckpt_bytes,
            "restored_bitwise_equal": True, "async_save_held": True}


def load_example(name: str):
    """``examples/<name>.py`` as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    return example


def train_example(reset_counts, read_counts, root: Path) -> dict:
    """``examples/train_lm_torch.py`` on the card (its defaults), its
    checkpoints under ``root``: the last loss below the first."""
    import torch
    example = load_example("train_lm_torch")
    reset_counts()
    t0 = time.perf_counter()
    history = example.main([*TRAIN_EXAMPLE_ARGS, "--ckpt-dir",
                            str(root / "example")])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    first, last = history[0], history[-1]
    if not last["loss"] < first["loss"]:
        raise AssertionError(f"example loss {first['loss']} -> "
                             f"{last['loss']}")
    return {"first_loss": first["loss"], "last_loss": last["loss"],
            "steps": last["step"] + 1, "tokens_per_s": last["tokens_per_s"],
            "wall_s": wall_s, "launches": read_counts()}


def phase_lm_train(dev, reset_counts, read_counts) -> dict:
    """Phase 20: the training step of ``TRAIN_ARCH`` at full width and
    depth, kernel against plain, both remat settings, timed and
    profiled; ``train`` with checkpoints and a resume; mistral's GQA and
    head dim 128 in training at ``TRAIN_GQA``'s depth; the example.
    Returns the flash launches by run."""
    import shutil
    import tempfile
    import torch
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.launch import steps
    from repro_torch.optim.adamw import AdamW
    from repro_torch.roofline.analysis import model_flops

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    cfg = get_config(TRAIN_ARCH)
    b, s = TRAIN_SHAPE["global_batch"], TRAIN_SHAPE["seq_len"]
    run = train_kernel_vs_plain(
        cfg, TRAIN_SHAPE, dev, reset_counts, read_counts,
        {"forward_first": 0, "forward_last": cfg.num_layers - 1,
         "recompute_last": -1})
    params, start, batch = run.pop("params"), run.pop("start"), \
        run.pop("batch")
    n_params = sum(p.numel() for p in params.parameters())

    # remat "none": the same weights, each layer's flash call once.
    from repro_torch.models.model import Model
    cfg_none = cfg.replace(remat="none")
    params_none = Model(cfg_none).load(params.state_dict())
    no_remat, _ = train_step_readings(cfg_none, params_none, start, batch,
                                      reset_counts, read_counts)
    del params_none
    if no_remat["launches"]["flash_attention"] != cfg.num_layers:
        raise AssertionError(f"remat none launched {no_remat['launches']}")

    # Warm steps, timed, then one under the profiler.
    shape = ShapeConfig("lm_train", s, b, "train")
    bundle = steps.train_bundle(cfg, shape)
    opt_state = AdamW().init(params)
    step_ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, opt_state, m = bundle.fn(params, opt_state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    profile = train_step_profile(
        lambda: bundle.fn(params, opt_state, batch))
    del opt_state
    flops = model_flops(cfg, shape)
    step_s = min(step_ms) / 1e3

    root = ROOT / "build"
    root.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="lm_train_", dir=root))
    try:
        resume = train_resume(params, start, tmp, dev)
        del params, start, batch
        torch.cuda.empty_cache()
        arch, depth, gqa_shape = TRAIN_GQA
        gqa_cfg = get_config(arch).replace(num_layers=depth)
        gqa = train_kernel_vs_plain(gqa_cfg, gqa_shape, dev, reset_counts,
                                    read_counts, {"last": -1})
        gqa_params = sum(p.numel() for p in gqa.pop("params").parameters())
        del gqa["start"], gqa["batch"]
        torch.cuda.empty_cache()
        example = train_example(reset_counts, read_counts, tmp)
    finally:
        shutil.rmtree(tmp)
    if tmp.exists():
        raise AssertionError(f"{tmp} was not removed")
    phase_s = time.perf_counter() - t_phase
    emit("lm_train", arch=TRAIN_ARCH, layers=cfg.num_layers,
         d_model=cfg.d_model, heads=[cfg.num_heads, cfg.num_kv_heads],
         head_dim=cfg.head_dim, params=n_params, dtype=cfg.dtype,
         remat=cfg.remat, **TRAIN_SHAPE, kernel_vs_plain=run,
         remat_none=no_remat, step_ms=step_ms,
         tokens_per_s=b * s / step_s, model_flops=flops,
         model_flops_share_of_bf16_peak=flops / step_s / BF16_OPS_PER_S,
         step_profile=profile, train=resume,
         gqa={"arch": arch, "layers": depth, "params": gqa_params,
              **gqa_shape, **gqa},
         example=example, grad_norm_rtol=GRAD_NORM_RTOL,
         moment_rtol=MOMENT_RTOL, loss_atol=LOSS_ATOL, phase_s=phase_s)
    return {"qwen_step_remat_full":
                run["kernel"]["launches"]["flash_attention"],
            "qwen_step_remat_none": no_remat["launches"]["flash_attention"],
            f"{arch}_{depth}_layers_step":
                gqa["kernel"]["launches"]["flash_attention"],
            f"example_{example['steps']}_steps":
                example["launches"]["flash_attention"]}


def profiled(fn, top: int = 0) -> tuple:
    """``fn()`` under ``torch.profiler`` (host and card): its result and
    the run's wall ms, the card's busy ms (its kernels, copies and sets
    summed), the NCCL kernels, the host ops' count and self ms and, with
    ``top``, the ``top`` ops by host self ms (name: [calls, ms])."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    host = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CPU]
    summary = {
        "wall_ms": wall,
        "device_busy_ms": sum(e.time_range.elapsed_us()
                              for e in device) / 1e3,
        "device_events": len(device),
        "nccl_launches": sum(1 for e in device
                             if "nccl" in e.name.lower()),
        "host_ops": sum(e.count for e in host),
        "host_self_ms": sum(e.self_cpu_time_total for e in host) / 1e3}
    if top:
        by_ms = sorted(host, key=lambda e: -e.self_cpu_time_total)[:top]
        summary["host_top"] = {e.key: [e.count, e.self_cpu_time_total / 1e3]
                               for e in by_ms}
    return out, summary


def _state_bytes(params, opt_state) -> int:
    from torch.distributed.tensor import DTensor
    tensors = list(params.parameters()) + list(opt_state.mu.values()) + \
        list(opt_state.nu.values())
    return sum((t.to_local() if isinstance(t, DTensor) else t).numel()
               * t.element_size() for t in tensors)


def mesh_train_turns(ctx, dev, reset_counts, read_counts,
                     arch: str = TRAIN_ARCH, train_shape: dict = TRAIN_SHAPE,
                     n_steps: int = MESH_TRAIN_STEPS,
                     profile: bool = True) -> dict:
    """``arch`` at ``train_shape``: the sharded train step in turns with
    the unsharded one, each from seed 0's weights, on the same batches
    (an encoder-decoder's frames drawn on the card from seed 0); per step
    the loss, grad norm, ms, flash launches (twice a forward's: each
    layer's attention is recomputed in the backward pass) and peak memory
    of each; with ``profile`` the NCCL kernels and host ops of one more
    step each way."""
    import torch
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.data.tokens import TokenStream
    from repro_torch.launch import steps
    from repro_torch.models.model import Model
    from repro_torch.models.transformer import DTYPES
    from repro_torch.optim.adamw import AdamW

    cfg = get_config(arch)
    b, s = train_shape["global_batch"], train_shape["seq_len"]
    shape = ShapeConfig("lm_mesh", s, b, "train")
    flash_per_step = 2 * (MESH_FAMILIES[arch] if cfg.is_encdec
                          else cfg.num_layers)
    opt = AdamW()
    model = Model(cfg)
    runs = {}
    for name, c in (("unsharded", None), ("sharded", ctx)):
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        if c is not None:
            params = model.shard(params, c)
        runs[name] = {"bundle": steps.train_bundle(cfg, shape, opt, ctx=c),
                      "state": [params, opt.init(params, c)], "steps": []}
    resident = {n: _state_bytes(*r["state"]) for n, r in runs.items()}
    stream = TokenStream(cfg.vocab_size, s, b)
    frames = torch.Generator(device=dev).manual_seed(0)
    for i in range(n_steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in stream.batch_at(i).items()}
        if cfg.is_encdec:       # in the config's dtype, as input_specs
            batch["frames"] = torch.randn(
                (b, cfg.encoder_seq, cfg.d_model), generator=frames,
                device=dev).to(DTYPES[cfg.dtype])
        order = ("unsharded", "sharded") if i % 2 == 0 else \
            ("sharded", "unsharded")
        for name in order:
            run = runs[name]
            reset_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            params, state, m = run["bundle"].fn(*run["state"], batch)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            run["state"] = [params, state]
            other = resident["sharded" if name == "unsharded"
                             else "unsharded"]
            run["steps"].append({
                "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                "ms": ms,
                "flash_launches": read_counts()["flash_attention"],
                "peak_bytes": torch.cuda.max_memory_allocated(),
                "peak_bytes_without_other_run":
                    torch.cuda.max_memory_allocated() - other})
    out = {n: r["steps"] for n, r in runs.items()}
    out.update(arch=arch, **train_shape, resident_state_bytes=resident)
    if profile:
        # one more step each way under the profiler: where the host time
        # goes
        profiles = {}
        for name in ("unsharded", "sharded"):
            run = runs[name]
            _, profiles[name] = profiled(
                lambda: run["bundle"].fn(*run["state"], batch),
                top=MESH_PROFILE_TOP)
        out["nccl_launches_sharded_step"] = \
            profiles["sharded"]["nccl_launches"]
        added = {k: [c, ms - profiles["unsharded"]["host_top"].get(
            k, [0, 0.0])[1]] for k, (c, ms) in
            profiles["sharded"]["host_top"].items()}
        out["profile"] = {
            **profiles, "host_self_ms_added_top": dict(sorted(
                added.items(), key=lambda kv: -kv[1][1])[:MESH_PROFILE_TOP])}
    for u, m_ in zip(out["unsharded"], out["sharded"]):
        if abs(u["loss"] - m_["loss"]) > LOSS_ATOL or abs(
                u["grad_norm"] - m_["grad_norm"]) > GRAD_NORM_RTOL * abs(
                    u["grad_norm"]):
            raise AssertionError(f"{arch}: sharded step {m_} != unsharded "
                                 f"{u}")
        if not u["flash_launches"] == m_["flash_launches"] == \
                flash_per_step:
            raise AssertionError(f"{arch}: flash launches a step: {u} / "
                                 f"{m_}, expected {flash_per_step}")
    out["loss_diff"] = [m_["loss"] - u["loss"] for u, m_ in
                        zip(out["unsharded"], out["sharded"])]
    out["grad_norm_diff"] = [m_["grad_norm"] - u["grad_norm"] for u, m_ in
                             zip(out["unsharded"], out["sharded"])]
    del runs
    torch.cuda.empty_cache()
    return out


def mesh_greedy(model, params, inputs, ctx, reset_counts,
                read_counts) -> dict:
    """A greedy prefill of ``inputs`` and ``MESH_SERVE``'s decode steps
    (on the mesh of ``ctx``, or without one): the logits of the prompt's
    last token and of each step, the tokens, the caches, the flash
    launches of the prefill and of all decode steps, prefill ms, mean
    decode-step ms and the peak memory."""
    import torch
    from repro_torch.launch import steps
    kw = MESH_SERVE
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    logits, caches = model.prefill(params, steps.local_batch(inputs, ctx),
                                   max_len=kw["max_len"], ctx=ctx)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    flash = read_counts()["flash_attention"]
    outs = [logits[:, -1:]]
    toks = [torch.argmax(outs[0], -1)]
    t0 = time.perf_counter()
    for _ in range(kw["gen_len"] - 1):
        logits, caches = model.decode_step(params, toks[-1], caches,
                                           ctx=ctx)
        outs.append(logits)
        toks.append(torch.argmax(logits, -1))
    torch.cuda.synchronize()
    return {"logits": torch.cat(outs, 1), "tokens": torch.cat(toks, 1),
            "caches": caches, "flash_launches": flash,
            "decode_flash_launches": read_counts()["flash_attention"]
            - flash,
            "prefill_ms": prefill_ms,
            "decode_step_ms": (time.perf_counter() - t0) * 1e3
            / (kw["gen_len"] - 1),
            "peak_bytes": torch.cuda.max_memory_allocated()}


def mesh_serve(ctx, dev, reset_counts, read_counts) -> dict:
    """``MESH_SERVE_ARCH`` at its ``MOE_DEPTH``: a greedy prefill + decode
    without the mesh, then the same weights placed on it (views on one
    rank) through the all_to_all path (prefill) and the psum path
    (decode) against the caches ``cache_specs`` splits; tokens equal,
    logits within ``LOGIT_ATOL``/``LOGIT_RTOL``, one flash launch a layer
    in the prefill and none in the decode steps, both ways."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.distributed import sharding
    from repro_torch.launch import serve_lm
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.model import Model

    depth = MOE_DEPTH[MESH_SERVE_ARCH]
    cfg = get_config(MESH_SERVE_ARCH).replace(num_layers=depth)
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    kw = MESH_SERVE
    inputs = serve_lm.model_inputs(cfg, kw["batch"], kw["prompt_len"], 0,
                                   dev)
    want = mesh_greedy(model, params, inputs, None, reset_counts,
                       read_counts)
    params = model.shard(params, ctx)
    paths = {"a2a": 0, "psum": 0}
    saved = {p: getattr(moe_lib, f"_{p}_path") for p in paths}

    def counted(p):
        def fn(*a, **k):
            paths[p] += 1
            return saved[p](*a, **k)
        return fn

    for p in paths:
        setattr(moe_lib, f"_{p}_path", counted(p))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, prof = profiled(lambda: mesh_greedy(
            model, params, inputs, ctx, reset_counts, read_counts))
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        for p, fn in saved.items():
            setattr(moe_lib, f"_{p}_path", fn)
    read = logit_reading(got["logits"], want["logits"])
    caches = got["caches"]
    out = {"arch": MESH_SERVE_ARCH, "layers": depth, **kw,
           "tokens_equal": bool(torch.equal(got["tokens"], want["tokens"])),
           "logits_bitwise_equal": bool(torch.equal(got["logits"],
                                                    want["logits"])),
           "logit_max_abs_diff": read["max_abs"],
           "logit_tol_ratio": read["tol_ratio"],
           "paths": paths, "flash_launches": got["flash_launches"],
           "unsharded_flash_launches": want["flash_launches"],
           "decode_flash_launches": [got["decode_flash_launches"],
                                     want["decode_flash_launches"]],
           "nccl_launches": prof["nccl_launches"], "mesh_ms_profiled": ms,
           "cache_spec_k": list(sharding.cache_specs(
               caches, ctx)[0]["k"]),
           "cache_slots": [caches[0].k.shape[1], caches[0].start],
           "peak_bytes": got["peak_bytes"]}
    if not out["tokens_equal"] or out["logit_tol_ratio"] > 1.0:
        raise AssertionError(f"mesh serve != unsharded: {out}")
    if paths != {"a2a": depth, "psum": depth * (kw["gen_len"] - 1)} or \
            out["flash_launches"] != depth or \
            out["unsharded_flash_launches"] != depth or \
            out["decode_flash_launches"] != [0, 0]:
        raise AssertionError(f"routes or launches: {out}")
    del params, caches, got, want
    torch.cuda.empty_cache()
    return out


def mesh_family_one(ctx, dev, arch: str, reset_counts, read_counts) -> dict:
    """One architecture of ``MESH_FAMILIES``: greedy prefill and decode
    with and without the mesh from the same weights and prompts (and
    frames), in turns (off, on, on, off: the same storage, placed on the
    mesh and not; a float32 copy off and on), held in ``FAMILY_LIMITS``'
    decode dtype at its limit (equal tokens, logits within the limit
    ``FAMILY_LIMITS`` gives that dtype) and read in bfloat16 at
    ``LOGIT_ATOL``/``LOGIT_RTOL``; the prefill's flash launches on and off
    the mesh equal ``MESH_FAMILIES``' count and the decode steps' are 0,
    the first mesh run's first and last flash call held to the plain
    version."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve_lm
    from repro_torch.models.model import Model

    t0 = time.perf_counter()
    cfg = get_config(arch)
    held_dtype, *held_tol = FAMILY_LIMITS[arch]["decode"]
    flash = MESH_FAMILIES[arch]
    kw = MESH_SERVE
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    inputs = serve_lm.model_inputs(cfg, kw["batch"], kw["prompt_len"], 0,
                                   dev)

    def turns(m, prm, served: bool) -> list:
        """(label, run) of greedy runs off, on, on and off the mesh (the
        served dtype, its first mesh run's flash calls held), or off and
        on (a float32 copy)."""
        off = m.load(prm.state_dict())      # shares the storage, unplaced
        on = m.shard(prm, ctx)
        order = (("unsharded", off, None), ("mesh", on, ctx))
        out = []
        for label, p_, c in order + (order[::-1] if served else ()):
            def run(p_=p_, c=c):
                return mesh_greedy(m, p_, inputs, c, reset_counts,
                                   read_counts)
            if served and c is not None and flash and not any(
                    lbl == "mesh" for lbl, _ in out):
                r, held, _ = held_flash_calls(f"{arch} mesh prefill", run,
                                              {"first": 0, "last": -1})
                r["held_flash_calls"] = held
            else:
                r = run()
            out.append((label, r))
        return out

    def reading(runs, tol) -> dict:
        want = runs[0][1]
        read = {"tokens_equal": True, "logits_bitwise_equal": True,
                "logit_max_abs_diff": 0.0, "logit_tol_ratio": 0.0,
                "logit_tol": list(tol)}
        for _, got in runs[1:]:
            r = logit_reading(got["logits"], want["logits"], tol)
            read["tokens_equal"] &= bool(torch.equal(got["tokens"],
                                                     want["tokens"]))
            read["logits_bitwise_equal"] &= bool(torch.equal(
                got["logits"], want["logits"]))
            read["logit_max_abs_diff"] = max(read["logit_max_abs_diff"],
                                             r["max_abs"])
            read["logit_tol_ratio"] = max(read["logit_tol_ratio"],
                                          r["tol_ratio"])
        for key in ("flash_launches", "decode_flash_launches", "prefill_ms",
                    "decode_step_ms", "peak_bytes"):
            for label in ("unsharded", "mesh"):
                read[f"{label}_{key}"] = [r[key] for lbl, r in runs
                                          if lbl == label]
        return read

    dtypes = {}
    if held_dtype != cfg.dtype:
        wide_model = Model(cfg.replace(dtype=held_dtype))
        wide = wide_model.load(params.state_dict())
        dtypes[held_dtype] = reading(turns(wide_model, wide, served=False),
                                     held_tol)
        del wide
        torch.cuda.empty_cache()
    runs = turns(model, params, served=True)
    dtypes[cfg.dtype] = reading(runs, held_tol if held_dtype == cfg.dtype
                                else (LOGIT_ATOL, LOGIT_RTOL))
    held = dtypes[held_dtype]
    out = {"arch": arch, "layers": cfg.num_layers,
           "encoder_layers": cfg.encoder_layers, "d_model": cfg.d_model,
           **kw, "held_dtype": held_dtype, "by_dtype": dtypes,
           "held_flash_calls": next((r.get("held_flash_calls", {})
                                     for lbl, r in runs if lbl == "mesh"),
                                    {})}
    if not held["tokens_equal"] or held["logit_tol_ratio"] > 1.0:
        raise AssertionError(f"{arch}: mesh greedy != unsharded: {out}")
    for launches in dtypes.values():
        if set(launches["mesh_flash_launches"]
               + launches["unsharded_flash_launches"]) != {flash} or set(
                launches["mesh_decode_flash_launches"]
                + launches["unsharded_decode_flash_launches"]) != {0}:
            raise AssertionError(f"{arch}: flash launches a prefill or in "
                                 f"decode: {out}")
    out["mesh_flash_launches"] = flash
    del runs, params
    torch.cuda.empty_cache()
    out["step_s"] = time.perf_counter() - t0
    return out


def phase_lm_mesh(dev, reset_counts, read_counts) -> dict:
    """Phase 21: the LM on a (1, 1) mesh of one NCCL rank: collectives on
    the group, the sharded train step against the unsharded one
    (``mesh_train_turns``) beside ``launch/dryrun.py``'s estimate of the
    same cell (a fake process group in its own process, no card), and
    the MoE decoder's mesh serve (``mesh_serve``), then the recurrent
    decoders and the encoder-decoder on the mesh (``mesh_family_one``)
    and whisper's sharded train step in turns with the unsharded one.
    Returns the flash launches by run."""
    import os
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import parallel
    from repro_torch.launch import mesh as mesh_lib

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    try:
        mesh_lib.init_process_group()
        ctx = mesh_lib.make_small_context(1, 1)
        if dist.get_backend() != "nccl" or ctx.mesh.device_type != "cuda":
            raise AssertionError(f"mesh on {dist.get_backend()}")
        group = ctx.group("model")

        def collectives():
            x = torch.arange(8.0, device=dev)
            dist.all_reduce(x, group=group)
            out = torch.empty_like(x)
            dist.all_to_all_single(out, x, group=group)
            gathered = torch.empty(8, device=dev)
            dist.all_gather_into_tensor(gathered, x, group=group)
            return out, gathered, x

        (a2a, gathered, reduced), coll = profiled(collectives)
        ref = torch.arange(8.0, device=dev)
        if not (torch.equal(a2a, ref) and torch.equal(gathered, ref)
                and torch.equal(reduced, ref)):
            raise AssertionError("one-rank collectives changed the data")
        if parallel.group_size(group) != 1:
            raise AssertionError("the (1, 1) mesh's group is not one rank")
        train = mesh_train_turns(ctx, dev, reset_counts, read_counts)
        serve = mesh_serve(ctx, dev, reset_counts, read_counts)
        families = {arch: mesh_family_one(ctx, dev, arch, reset_counts,
                                          read_counts)
                    for arch in MESH_FAMILIES}
        family_arch, family_shape, family_steps = MESH_TRAIN_FAMILY
        family_train = mesh_train_turns(
            ctx, dev, reset_counts, read_counts, family_arch, family_shape,
            family_steps, profile=False)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    # dryrun's estimate of the train cell, after the timed runs (its CPU
    # trace would contend with their host work)
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    dry_path = build / "lm_mesh_dryrun.json"
    dry_path.unlink(missing_ok=True)
    dry = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         TRAIN_ARCH, "--shape", "train_4k", "--device", "cpu",
         "--global-batch", str(TRAIN_SHAPE["global_batch"]), "--out",
         str(dry_path)], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 CUDA_VISIBLE_DEVICES="", REPRO_DRYRUN_DEVICES="1"),
        capture_output=True, text=True, timeout=900)
    if dry.returncode != 0:
        raise AssertionError(f"dryrun failed: {dry.stderr[-3000:]}")
    estimate = json.loads(dry_path.read_text())
    sharded_peak = max(s["peak_bytes_without_other_run"]
                       for s in train["sharded"])
    phase_s = time.perf_counter() - t_phase
    emit("lm_mesh", mesh=[1, 1], backend="nccl",
         collectives_nccl_launches=coll["nccl_launches"], train=train,
         dryrun={"mesh": estimate["mesh"], "memory": estimate["memory"],
                 "flops": estimate["flops"],
                 "collectives": estimate["collectives"],
                 "roofline": estimate["roofline"],
                 "seconds": estimate["seconds"]},
         dryrun_peak_over_measured=estimate["memory"]["peak_bytes"]
         / sharded_peak, measured_sharded_peak_bytes=sharded_peak,
         serve=serve, families=families, family_train=family_train,
         phase_s=phase_s)
    return {"qwen_sharded_step": train["sharded"][0]["flash_launches"],
            f"{MESH_SERVE_ARCH}_{serve['layers']}_layers_prefill":
                serve["flash_launches"],
            **{f"{arch}_prefill": f["mesh_flash_launches"]
               for arch, f in families.items()},
            f"{family_arch}_sharded_step":
                family_train["sharded"][0]["flash_launches"]}


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
                             "ph_phase_c", "ph_phase_a")},
         ptxas_note="flash_fwd_wgmma_kernel's registers are its launch "
                    "share; setmaxnreg leaves the producer warpgroup 24 and "
                    "gives each consumer warpgroup 240")

    # -- 3. phase-A kernel vs plain ---------------------------------------
    rng = np.random.default_rng(0)

    def as_dtype(img: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
        return to_device(img, dtype, dev)

    err = {name: 0.0 for name in libraries}
    dtypes = (torch.uint8, torch.int16, torch.int32, torch.float32,
              torch.bfloat16)
    n_cases = phase_a_cases(dev, rng, err)
    n = MAIN_SIZE * MAIN_SIZE
    frame = astro.generate_image(0, MAIN_SIZE)
    x_main = torch.from_numpy(frame).to(dev)
    a_ms = cuda_ms(lambda: ka.phase_a(x_main, strip_rows=8))
    a_dev_ms = device_ms(lambda: ka.phase_a(x_main, strip_rows=8))
    a_plain_ms = cuda_ms(lambda: ra.phase_a(x_main, strip_rows=8))
    a_bound_ms = phase_a_bound_ms(x_main)
    # The mixed batch's bucket and a wide frame (its strips span a cluster).
    timed_a = {}
    wide_frame = astro.generate_image(0, PHASE_A_WIDE)   # phases 12-13 too
    for label, x in (("bucket", survey_bucket(dev)),
                     ("wide", torch.from_numpy(wide_frame).to(dev))):
        check_phase_a(x, 8, f"{label} {tuple(x.shape)}", err)
        t_ms = cuda_ms(lambda: ka.phase_a(x, strip_rows=8))
        t_dev_ms = device_ms(lambda: ka.phase_a(x, strip_rows=8))
        bound = phase_a_bound_ms(x)
        timed_a[label] = dict(shape=list(x.shape), kernel_ms=t_ms,
                              device_ms=t_dev_ms, bound_ms=bound,
                              bound_share=bound / t_dev_ms,
                              layout=ka.strip_layout(8, x.shape[-1]))
        del x
    emit("phase_a", cases=n_cases + 2, bitwise_equal=True,
         shape=[MAIN_SIZE] * 2, dtype="float32", strip_rows=8,
         layout=ka.strip_layout(8, MAIN_SIZE), kernel_ms=a_ms,
         device_ms=a_dev_ms, plain_ms=a_plain_ms, bound_ms=a_bound_ms,
         bound_share=a_bound_ms / a_dev_ms, design=DESIGN["ph_phase_a"],
         **timed_a)

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

    # Per-stage device times of the same computation (the recorder's
    # stage events), with the kernels and with the plain versions.
    tv = torch.tensor(res.threshold, dtype=torch.float32, device=dev)
    stage_kw = dict(max_features=mf, max_candidates=mc, merge_impl="boruvka",
                    phase_c_impl="fused", strip_rows=cfg.strip_rows)

    def staged(use_pallas, kw=stage_kw, want=None):
        """Per-stage device times of one ``pixhomology`` call; the diagram
        must equal ``want``."""
        d, ms = stage_marks(lambda: pixhomology(
            x_run, tv, use_pallas=use_pallas, **kw))
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

    # -- 12-13. the tiled path and delta-PH at 10240² ------------------------
    tiled = phase_tiled(dev, wide_frame, reset_counts, read_counts, err)
    delta = phase_delta(wide_frame, tiled)

    # -- 14-16c. flash attention, LM serving, LM forward, the MoE decoders,
    # the other LM families --
    fa = phase_flash_attention(dev, rng, err)
    lm = phase_lm_serve(dev, reset_counts, read_counts)
    phase_lm_forward(dev, lm.pop("params"), reset_counts, read_counts)
    torch.cuda.empty_cache()                    # the 12 B weights are gone
    moe_launches = phase_lm_moe(dev, reset_counts, read_counts)
    torch.cuda.empty_cache()
    families = phase_lm_families(dev, reset_counts, read_counts)

    # -- 17. the distributed pipeline ----------------------------------------
    pipeline = phase_pipeline(reset_counts, read_counts, err)

    # -- 18. PH-as-a-service ---------------------------------------------------
    serving = phase_serving(reset_counts, read_counts, err)

    # -- 18b. the PH examples ------------------------------------------------
    ph_examples = phase_ph_examples(reset_counts, read_counts)

    # -- 19. the autotuner ---------------------------------------------------
    tuned = phase_autotune(dev, dict(
        frame=frame, threshold=res.threshold,
        main=diagram_to_numpy(res.diagram), survey=survey,
        survey_tv=survey_tv, mixed=diagram_to_numpy(mres.diagram),
        wide_frame=wide_frame, tiled=tiled), reset_counts, read_counts, err)
    del wide_frame

    # -- 20. the LM training step ---------------------------------------------
    torch.cuda.empty_cache()
    train_launches = phase_lm_train(dev, reset_counts, read_counts)

    # -- 21. the LM on a one-rank mesh -----------------------------------------
    torch.cuda.empty_cache()
    mesh_launches = phase_lm_mesh(dev, reset_counts, read_counts)

    # -- kernel table, card, result ----------------------------------------
    kernels = [
        {"name": "ph_phase_a", "route": "cuda",
         "source": "src/repro_torch/kernels/ph_phase_a/csrc/phase_a.cu",
         "replaces": "src/repro/kernels/ph_phase_a/kernel.py:52",
         "launches": launches["ph_phase_a"],
         "pipeline_launches": pipeline["launches"]["ph_phase_a"],
         "serving_launches": serving["launches"]["ph_phase_a"],
         "ph_examples_launches": {k: n["ph_phase_a"]
                                  for k, n in ph_examples.items()},
         "autotune_search_launches":
             tuned["search_launches"]["ph_phase_a"],
         "autotune_tuned_run_launches":
             tuned["tuned_launches"]["ph_phase_a"],
         "max_abs_err": err["ph_phase_a"],
         "ms": a_ms, "device_ms": a_dev_ms, "plain_ms": a_plain_ms,
         "bound_ms": a_bound_ms, "bound_by": "bytes", "library_ms": None,
         "design": DESIGN["ph_phase_a"]},
        {"name": "ph_phase_c_best_edge", "route": "cuda",
         "source": "src/repro_torch/kernels/ph_phase_c/csrc/best_edge.cu",
         "replaces": "src/repro/kernels/ph_phase_c/kernel.py:42",
         "launches": launches["ph_phase_c"],
         "tiled_launches": tiled["launches"]["ph_phase_c"],
         "delta_launches": delta["launches"],
         "pipeline_launches": pipeline["launches"]["ph_phase_c"],
         "serving_launches": serving["launches"]["ph_phase_c"],
         "serving_cache_tier_launches":
             serving["cache_tier_launches"]["ph_phase_c"],
         "ph_examples_launches": {k: n["ph_phase_c"]
                                  for k, n in ph_examples.items()},
         "autotune_search_launches":
             tuned["search_launches"]["ph_phase_c"],
         "autotune_tuned_run_launches":
             tuned["tuned_launches"]["ph_phase_c"],
         "max_abs_err": err["ph_phase_c"],
         "ms": e_ms, "device_ms": e_dev_ms, "plain_ms": e_plain_ms,
         "bound_ms": e_bound_ms, "bound_by": "bytes", "library_ms": e_lib_ms,
         "library_device_ms": e_timed["library_device_ms"],
         "seam_round": {k: tiled["seam_round"][k] for k in (
             "edges", "live_edges", "nv", "ms", "device_ms", "plain_ms",
             "bound_ms", "library_ms")},
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
         "moe_launches": moe_launches,
         "lm_families_launches": {arch: f["flash_launches"]
                                  for arch, f in families.items()},
         "lm_train_launches": train_launches,
         "lm_mesh_launches": mesh_launches,
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
