"""The port's hand-written CUDA kernels and engine on the card.

Every test here needs a CUDA device (``cuda`` marker) and skips without
one; the kernels have no CPU mode.  The file imports neither JAX nor the
reference package, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import json
import time

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_smoke_config
from repro_torch.core import diagram_to_numpy
from repro_torch.data import astro
from repro_torch.kernels.flash_attention import kernel as kfa
from repro_torch.kernels.flash_attention import ref as rfa
from repro_torch.kernels.ph_phase_a import kernel as ka
from repro_torch.kernels.ph_phase_a import ref as ra
from repro_torch.kernels.maxpool import kernel as kmp
from repro_torch.kernels.maxpool import ref as rmp
from repro_torch.kernels.ph_distance import kernel as kd
from repro_torch.kernels.ph_distance import ref as rd
from repro_torch.kernels.ph_phase_c import kernel as kc
from repro_torch.kernels.ph_phase_c import ref as rc
from repro_torch.launch import serve_lm
from repro_torch.models import transformer
from repro_torch.models.model import Model
from repro_torch.ph import PHConfig, PHEngine

DTYPES = (torch.uint8, torch.int16, torch.int32, torch.float32,
          torch.bfloat16)


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


def _image(dtype, shape, seed, levels=None):
    rng = np.random.default_rng(seed)
    img = (rng.integers(0, levels, size=shape) if levels
           else rng.normal(size=shape) * 40)
    if dtype == torch.uint8:
        img = np.clip(np.abs(img), 0, 255)
    return torch.from_numpy(img.astype(np.float32)).to(dtype).cuda()


def _phase_a_equal(x, s, what):
    kp, km = ka.phase_a(x, strip_rows=s)
    rp, rm = ra.phase_a(x, strip_rows=s)
    assert torch.equal(kp, rp) and torch.equal(km, rm), (what, s)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_phase_a_kernel_matches_plain_version(dtype):
    """Small and degenerate shapes, then every width regime of the kernel
    and its edges (S * W = 65,536 and a column either side, the widest
    cluster strip and a column more, widths 10240 and 16384) at S = 8
    and 16, the mixed batch's (5, 2048, 2048) bucket with its fill
    padding, signed zeros and a bfloat16 tie storm."""
    _need_cuda()
    for shape in ((13, 9), (1, 17), (17, 1), (1, 1), (40, 300)):
        for levels in (None, 3):
            x = _image(dtype, shape, sum(shape), levels)
            for s in (1, 3, 8, 16):
                _phase_a_equal(x, s, (dtype, shape, levels))
    _phase_a_equal(_image(dtype, (3, 21, 30), 5), 8, (dtype, "batch"))
    for s in (8, 16):
        narrow = ka.NARROW_ENTRIES // s
        cap = (ka.SMEM_BYTES - ka.STATIC_BYTES) // (
            4 * -(-s // ka.MAX_CLUSTER))
        assert ka.strip_layout(s, cap) == ("cluster", ka.MAX_CLUSTER)
        assert ka.strip_layout(s, cap + 1) == ("global", 1)
        for w, h in ((narrow - 1, 2 * s + 3), (narrow, 2 * s + 3),
                     (narrow + 1, 2 * s + 3), (10240, 2 * s + 3),
                     (16384, 2 * s + 3), (cap, s + 1), (cap + 1, s + 1)):
            for levels in (None, 3):
                x = _image(dtype, (h, w), w + s, levels)
                _phase_a_equal(x, s, (dtype, h, w, levels))
            if dtype in (torch.float32, torch.int32):
                r, c = np.mgrid[:h, :w]
                ramp = c * 2 * s - np.abs(r % s - s // 2)
                x = torch.from_numpy(ramp.astype(np.float32)).to(dtype)
                _phase_a_equal(x.cuda(), s, (dtype, h, w, "column ramp"))
    if dtype.is_floating_point:
        zeros = np.random.default_rng(1).choice(
            [0.0, -0.0, 1.0, -1.0], size=(19, 8193)).astype(np.float32)
        for s in (1, 8, 16):
            _phase_a_equal(torch.from_numpy(zeros).to(dtype).cuda(), s,
                           (dtype, "signed zeros"))
    frames = [astro.generate_window(i, 0, 0, h, w, size=2048)
              for i, (h, w) in enumerate(((2048, 2048), (2048, 1536),
                                          (1536, 1536), (1024, 2048),
                                          (1000, 1800)), start=10)]
    bucket = torch.full((5, 2048, 2048), float("-inf"))
    for i, f in enumerate(frames):
        bucket[i, :f.shape[0], :f.shape[1]] = torch.from_numpy(f)
    if dtype == torch.float32:
        _phase_a_equal(bucket.cuda(), 8, "survey bucket")
    if dtype == torch.bfloat16:
        _phase_a_equal(_image(dtype, (3, 2048, 2048), 2, 3), 8,
                       "bfloat16 tie storm")


@pytest.mark.cuda
@pytest.mark.parametrize("key_dtype", [torch.int32, torch.int64])
def test_best_edge_kernel_matches_plain_version(key_dtype):
    _need_cuda()
    rng = np.random.default_rng(0)
    pad = torch.iinfo(key_dtype).min
    for e, nv, dead in ((1, 1, 0.3), (7, 3, 0.3), (64, 5, 1.0),
                        (1 << 20, 4096, 0.3)):
        key = torch.from_numpy(rng.integers(-5, 5, size=e))
        key = torch.where(torch.from_numpy(rng.random(e) < dead), pad, key)
        key = key.to(key_dtype).cuda()
        ra_, rb_ = (torch.from_numpy(rng.integers(0, nv, size=e)
                                     .astype(np.int32)).cuda()
                    for _ in range(2))
        kb, kw = kc.best_edge_reduce(key, ra_, rb_, nv)
        pb, pw = rc.best_edge_reduce(key, ra_, rb_, nv)
        assert torch.equal(kb, pb) and torch.equal(kw, pw), (e, nv, dead)


@pytest.mark.cuda
@pytest.mark.parametrize("key_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("kind", ["tie_storm", "all_dead", "all_live",
                                  "min_plus_one"])
def test_best_edge_kernel_around_its_vectors(key_dtype, kind):
    """E from 1 to 33 around the 16-byte vectors (4 int32 or 2 int64 keys),
    on the tensor and on the view from lane 1 (a base 4 or 8 bytes past a
    16-byte boundary), and a large instance of the kind."""
    _need_cuda()
    rng = np.random.default_rng(len(kind))
    lo = torch.iinfo(key_dtype).min
    keys = {"tie_storm": [lo + 1, -1, 0, 3], "min_plus_one": [lo + 1]}.get(
        kind, list(range(-40, 40)))
    dead = {"all_dead": 1.0, "all_live": 0.0}.get(kind, 0.3)

    def instance(e, nv):
        key = torch.from_numpy(rng.choice(np.asarray(keys, np.int64), e))
        key = torch.where(torch.from_numpy(rng.random(e) < dead), lo, key)
        ra_, rb_ = (torch.from_numpy(rng.integers(0, nv, size=e)
                                     .astype(np.int32)).cuda()
                    for _ in range(2))
        return key.to(key_dtype).cuda(), ra_, rb_

    for e, nv in [(e, 1 + e % 5) for e in range(1, 34)] + [(200_001, 999)]:
        key, ra_, rb_ = instance(e + 1, nv)
        for view in (slice(0, e), slice(1, e + 1)):
            args = (key[view], ra_[view], rb_[view], nv)
            kb, kw = kc.best_edge_reduce(*args)
            pb, pw = rc.best_edge_reduce(*args)
            assert torch.equal(kb, pb) and torch.equal(kw, pw), (e, view)


@pytest.mark.cuda
@pytest.mark.parametrize("merge_impl,phase_c_impl",
                         [("scan", "fused"), ("boruvka", "xla"),
                          ("boruvka", "fused")])
def test_engine_on_card_matches_cpu(merge_impl, phase_c_impl):
    _need_cuda()
    frame = astro.generate_image(2, 128)
    cfg = PHConfig(merge_impl=merge_impl, phase_c_impl=phase_c_impl,
                   filter_level="filter_std")
    gpu = PHEngine(cfg).run(frame)
    assert gpu.diagram.birth.is_cuda
    cpu = PHEngine(cfg, device="cpu").run(frame)
    for a, b in zip(diagram_to_numpy(cpu.diagram),
                    diagram_to_numpy(gpu.diagram)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_maxpool_kernel_matches_plain_version(dtype):
    _need_cuda()
    cases = [_image(dtype, shape, sum(shape), levels)
             for shape in ((1, 1), (1, 29), (29, 1), (37, 53), (3, 20, 33))
             for levels in (None, 3)]
    fill = 0 if dtype == torch.uint8 else (
        torch.iinfo(dtype).min if not dtype.is_floating_point else -1.0)
    cases.append(torch.full((6, 7), fill, dtype=dtype, device="cuda"))
    # The edges of the kernel's tiles (32 rows by 32 16-byte vectors of
    # VEC values), batches, views whose base is not 16-byte aligned, signed
    # zeros.  Widths that are a multiple of VEC take the 16-byte loads and
    # stores: batches of them, and 4096 + VEC, whose last vector ends
    # inside a tile.
    vec = 16 // dtype.itemsize
    cases += [_image(dtype, shape, 7, levels=3)
              for shape in ((4095, 4097), (33, 129), (1, 4097),
                            (3, 33, 129), (3, 33, 128), (2, 40, 4096),
                            (33, 4096 + vec))]
    cases.append(_image(dtype, (41, 67), 8, levels=3)[1:])
    cases.append(_image(dtype, (1 + 40 * 64,), 10, levels=3)[1:]
                 .view(40, 64))
    for shape in ((37, 130), (37, 128)):
        zeros = np.random.default_rng(9).choice([0.0, -0.0, 1.0, -1.0],
                                                size=shape)
        cases.append(torch.from_numpy(zeros.astype(np.float32)).to(dtype)
                     .cuda() if dtype.is_floating_point else
                     _image(dtype, shape, 9, levels=3))
    for x in cases:
        kv, ka = kmp.maxargmaxpool3x3(x)
        rv, ra = rmp.maxargmaxpool3x3(x)
        assert torch.equal(kv, rv) and torch.equal(ka, ra), x.shape
        assert torch.equal(kmp.maxpool3x3(x), rmp.maxpool3x3(x))
        assert torch.equal(kmp.minpool3x3(x), rmp.minpool3x3(x))
        if dtype.is_floating_point:            # -0.0 pools below +0.0
            for got, want in ((kv, rv),
                              (kmp.maxpool3x3(x), rmp.maxpool3x3(x)),
                              (kmp.minpool3x3(x), rmp.minpool3x3(x))):
                assert torch.equal(torch.signbit(got), torch.signbit(want))


@pytest.mark.cuda
def test_distance_kernel_matches_plain_version():
    _need_cuda()
    rng = np.random.default_rng(3)
    for b, k, f in ((1, 1, 1), (3, 2, 5), (4, 16, 300), (5, 16, 5000)):
        pts = torch.from_numpy(rng.normal(size=(b, k, f)).astype(
            np.float32)).cuda()
        diag = torch.from_numpy(rng.normal(size=(b, k, f)).astype(
            np.float32)).cuda()
        prof = torch.sort(torch.from_numpy(np.abs(rng.normal(
            size=(b, f))).astype(np.float32)).cuda(), descending=True).values
        if b > 1:                          # a twin row: an exact zero
            pts[-1], diag[-1], prof[-1] = pts[0], diag[0], prof[0]
        ksw, kbn = kd.distance_matrix(pts, diag, prof)
        rsw, rbn = rd.distance_matrix(pts, diag, prof)
        assert torch.equal(kbn, rbn), (b, k, f)
        torch.testing.assert_close(ksw, rsw, rtol=1e-5, atol=0)
        assert torch.equal(ksw, ksw.T) and torch.equal(kbn, kbn.T)
        assert (ksw.diagonal() == 0).all() and (kbn.diagonal() == 0).all()
        if b > 1:
            assert ksw[0, b - 1] == 0


def _distance_tables(rng, b, k, f):
    """Rows in turn: Gaussian, pad-heavy (90 % zeros, as capacity pads
    project), heavy ties and signed zeros."""
    x = rng.normal(size=(b, k, f)) * 50
    mode = ((np.arange(b)[:, None] + np.arange(k)[None, :]) % 4)[..., None]
    x = np.where((mode == 1) & (rng.random((b, k, f)) < 0.9), 0.0, x)
    x = np.where(mode == 2, np.round(x / 40), x)
    x = np.where(mode == 3, rng.choice([0.0, -0.0, 1.5, -1.5],
                                       size=(b, k, f)), x)
    return torch.from_numpy(x.astype(np.float32)).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("f", [1, 4095, 4097, 65536, 131072])
@pytest.mark.parametrize("b", [1, 2, 17])
def test_distance_kernel_widths_and_batches(f, b):
    """F around the cluster sort's widths (131,072 takes the path for rows
    wider than one cluster), B of 1, 2 and 17; a twin row sits at exactly
    0."""
    _need_cuda()
    rng = np.random.default_rng(f + b)
    k = 16 if b * f <= 1 << 18 else 2
    pts, diag = _distance_tables(rng, b, k, f), _distance_tables(rng, b, k, f)
    prof = torch.sort(_distance_tables(rng, b, 1, f)[:, 0].abs(), dim=1,
                      descending=True).values.contiguous()
    if b > 1:
        pts[-1], diag[-1], prof[-1] = pts[0], diag[0], prof[0]
    ksw, kbn = kd.distance_matrix(pts, diag, prof)
    rsw, rbn = rd.distance_matrix(pts, diag, prof)
    assert torch.equal(kbn, rbn)
    torch.testing.assert_close(ksw, rsw, rtol=1e-5, atol=0)
    assert torch.equal(ksw, ksw.T) and torch.equal(kbn, kbn.T)
    assert not ksw.diagonal().any() and not kbn.diagonal().any()
    if b > 1:
        assert ksw[0, b - 1] == 0 and kbn[0, b - 1] == 0
    # Each stage on its own gives the same matrices.
    sort, pairs = kd.stages(pts, diag, prof)
    sort()
    ssw, sbn = pairs()
    assert torch.equal(ssw, ksw) and torch.equal(sbn, kbn)


@pytest.mark.cuda
def test_engine_paths_launch_the_new_kernels():
    _need_cuda()
    frames = [astro.generate_window(i, 0, 0, h, w, size=256)
              for i, (h, w) in enumerate(((256, 256), (256, 192),
                                          (200, 230)))]
    cfg = PHConfig(phase_a_impl="pooled", candidate_mode="paper",
                   merge_impl="boruvka", filter_level="filter_std")
    kmp.LIBRARY.launches = kd.LIBRARY.launches = 0
    gpu = PHEngine(cfg).run(frames[0])
    assert kmp.LIBRARY.launches > 0
    cpu = PHEngine(cfg, device="cpu").run(frames[0])
    for a, b in zip(diagram_to_numpy(cpu.diagram),
                    diagram_to_numpy(gpu.diagram)):
        np.testing.assert_array_equal(a, b)
    eng = PHEngine(cfg.replace(candidate_mode="exact"))
    batch = eng.run_batch(frames + [frames[1]])
    single = PHEngine(cfg.replace(
        candidate_mode="exact",
        max_features=batch.regrow.final_max_features,
        max_candidates=batch.regrow.final_max_candidates))
    for i, frame in enumerate(frames):
        one = diagram_to_numpy(single.run(frame).diagram)
        for a, b in zip(diagram_to_numpy(batch.diagram), one):
            np.testing.assert_array_equal(a[i], b)
    sw, bn = eng.distance_matrix(batch)
    assert kd.LIBRARY.launches == 1 and sw.is_cuda
    assert sw[1, 3] == 0 and bn[1, 3] == 0


def _same_diagrams(a, b):
    for x, y in zip(diagram_to_numpy(a), diagram_to_numpy(b)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.cuda
def test_run_tiled_on_card_equals_run_and_cpu():
    """512² through ``run_tiled`` (a (4, 4) grid of 128² tiles) on the
    card: the best-edge kernel serves the seam merge, and the diagram
    equals ``run`` on the card and ``run_tiled`` on the CPU."""
    _need_cuda()
    from repro_torch.ph import TileSpec
    frame = astro.generate_image(4, 512)
    cfg = PHConfig(merge_impl="boruvka", phase_c_impl="fused",
                   filter_level="filter_std",
                   tile=TileSpec(max_tile_pixels=128 * 128))
    kc.LIBRARY.launches = 0
    tiled = PHEngine(cfg).run_tiled(frame)
    assert tiled.config.tile.grid == (4, 4)
    assert kc.LIBRARY.launches > 0 and tiled.diagram.birth.is_cuda
    mf = tiled.config.max_features
    whole = PHEngine(cfg.replace(max_features=mf,
                                 regrow_features_ceiling=mf))
    _same_diagrams(whole.run(frame, tiled.threshold).diagram, tiled.diagram)
    cpu = PHEngine(cfg, device="cpu").run_tiled(frame)
    _same_diagrams(cpu.diagram, tiled.diagram)
    staged = PHEngine(cfg).stage_tiles(astro.AstroImage(4, 512))
    assert staged.pvals.is_cuda
    _same_diagrams(PHEngine(cfg).run_tiled(staged, tiled.threshold)
                   .diagram, tiled.diagram)


@pytest.mark.cuda
def test_seam_round_kernel_matches_plain_version(monkeypatch):
    """Every Boruvka round of a seam merge on the card, held bitwise to
    the plain version on the same inputs; delta runs equal cold runs."""
    _need_cuda()
    from repro_torch.data.astro import FrameSequence
    from repro_torch.kernels.ph_phase_c import ops as oc
    from repro_torch.ph import DeltaSpec, TileSpec
    rounds = []
    real = kc.best_edge_reduce

    def check(key, ra, rb, nv):
        got = real(key, ra, rb, nv)
        want = rc.best_edge_reduce(key, ra, rb, nv)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        rounds.append(key.shape[0])
        return got

    monkeypatch.setattr(oc.kernel, "best_edge_reduce", check)
    fs = FrameSequence(6, 256, grid=(4, 4), dirty_frac=0.2, stamp=5)
    cfg = PHConfig(merge_impl="boruvka", delta=DeltaSpec(),
                   tile=TileSpec(grid=(4, 4)))
    eng = PHEngine(cfg)
    tv = astro.AstroImage(6, 256).filter_threshold("filter_std")
    hits = []
    for i in (0, 1, 1):
        res = eng.run_delta(fs.frame(i), tv)
        hits.append(res.delta.hit)
        _same_diagrams(eng.run_tiled(fs.frame(i), tv).diagram, res.diagram)
    assert hits == ["miss", "partial", "full"] and rounds


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
def test_flash_attention_kernel_matches_plain_version(dtype, tol):
    """GQA 32/8, MQA, MHA, a window, non-causal, ragged Sq != Skv, rows
    with no visible key, hd 64/128/256, and the edges of the bfloat16
    kernel's tiles (128 query rows, 128 keys or 64 at hd 256: the 1032
    teacher-forced tokens, Skv 129 and 191, Sq one row into a tile, window
    edges inside a tile, hd 64 and 256 at a 128-row tile); the working
    type's tolerance (float32 without TF32: the plain version's einsums
    run in full float32)."""
    _need_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    for b, h, kv, sq, skv, hd, causal, window in (
            (1, 32, 8, 200, 200, 128, True, None),
            (2, 8, 1, 256, 256, 64, True, None),
            (2, 4, 4, 130, 130, 256, False, None),
            (1, 4, 2, 256, 256, 64, True, 100),
            (1, 4, 2, 70, 150, 128, False, None),
            (1, 2, 2, 8, 4, 64, True, 2),
            (1, 32, 8, 1032, 1032, 128, True, None),
            (1, 4, 2, 100, 129, 128, False, None),
            (1, 4, 2, 191, 191, 128, True, None),
            (1, 4, 2, 129, 129, 128, True, None),
            (1, 4, 2, 300, 300, 128, True, 70),
            (1, 4, 1, 129, 129, 64, True, None),
            (1, 4, 1, 129, 129, 256, True, None),
            (1, 4, 2, 256, 256, 256, True, 70)):
        q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                   .to(dtype).cuda() for s in ((b, h, sq, hd),
                                               (b, kv, skv, hd),
                                               (b, kv, skv, hd)))
        got = kfa.flash_attention_fwd(q, k, v, causal=causal, window=window)
        want = rfa.attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == want.shape
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)
        # Transposed (B, S, heads, hd) views go in without a copy.
        qt = q.transpose(1, 2).contiguous().transpose(1, 2)
        again = kfa.flash_attention_fwd(qt, k, v, causal=causal,
                                        window=window)
        assert torch.equal(again, got)
    with pytest.raises(ValueError, match="head dims"):
        kfa.flash_attention_fwd(q[..., :32], k[..., :32], v[..., :32])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
def test_flash_kernel_at_query_offsets(dtype, tol):
    """A rank's block of the query rows (``q_offset``): causal, windowed,
    ragged and non-causal, against the plain version; offset 0 is the
    whole-sequence kernel."""
    _need_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(1)
    for b, h, kv, sq, skv, hd, causal, window, off in (
            (1, 4, 2, 64, 256, 64, True, None, 192),
            (2, 8, 2, 128, 512, 128, True, None, 384),
            (1, 4, 1, 100, 300, 256, True, None, 150),
            (1, 4, 2, 128, 512, 128, True, 70, 300),
            (1, 2, 2, 64, 128, 128, False, None, 64)):
        q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                   .to(dtype).cuda() for s in ((b, h, sq, hd),
                                               (b, kv, skv, hd),
                                               (b, kv, skv, hd)))
        got = kfa.flash_attention_fwd(q, k, v, causal=causal, window=window,
                                      q_offset=off)
        want = rfa.attention(q, k, v, causal=causal, window=window,
                             q_offset=off)
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)
        # the same rows at the end of a whole query sequence
        whole = torch.cat([torch.randn_like(q[:, :, :1]).expand(
            b, h, off, hd), q], 2)
        full = kfa.flash_attention_fwd(whole, k, v, causal=causal,
                                       window=window)
        torch.testing.assert_close(full[:, :, off:].float(), got.float(),
                                   atol=tol, rtol=tol)
    with pytest.raises(ValueError, match="q_offset"):
        kfa.flash_attention_fwd(q, k, v, q_offset=-1)


@pytest.mark.cuda
def test_lm_mesh_one_rank_matches_unsharded():
    """A train step and a greedy serve on a (1, 1) mesh of one NCCL rank
    (``launch/mesh.py``): the same loss, grad norm and tokens as without
    the mesh."""
    _need_cuda()
    import torch.distributed as dist
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.tokens import TokenStream
    from repro_torch.launch import mesh, steps
    from repro_torch.optim.adamw import AdamW
    started = not dist.is_initialized()
    mesh.init_process_group()
    try:
        ctx = mesh.make_small_context(1, 1)
        cfg = get_smoke_config("qwen1_5_0_5b")
        shape = ShapeConfig("t", 32, 4, "train")
        batch = {k: torch.from_numpy(v).cuda() for k, v in
                 TokenStream(cfg.vocab_size, 32, 4).batch_at(0).items()}
        out = {}
        for c in (None, ctx):
            model = Model(cfg)
            params = model.init(torch.Generator("cuda").manual_seed(0))
            if c is not None:
                params = model.shard(params, c)
            opt = AdamW()
            bundle = steps.train_bundle(cfg, shape, opt, ctx=c)
            _, _, m = bundle.fn(params, opt.init(params, c), batch)
            tokens, _ = serve_lm.serve("qwen1_5_0_5b", params=params, ctx=c,
                                       batch=2, prompt_len=8, gen_len=4,
                                       max_len=16, verbose=False)
            out[c is None] = (float(m["loss"]), float(m["grad_norm"]),
                              tokens)
        assert out[True][:2] == out[False][:2]
        np.testing.assert_array_equal(out[True][2], out[False][2])
    finally:
        if started:
            dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [16, 96])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_op_routes_other_head_dims_to_plain_version(hd, dtype):
    """On the card the op sends head dims the kernel does not take to the
    plain version, a route by shape that launches nothing; the kernel
    itself still refuses them when called directly."""
    _need_cuda()
    from repro_torch.kernels.flash_attention import ops as fa_ops
    g = torch.Generator(device="cuda").manual_seed(hd)
    q, k, v = (torch.randn(2, n, 70, hd, device="cuda", generator=g)
               .to(dtype) for n in (8, 2, 2))
    kfa.LIBRARY.launches = 0
    got = fa_ops.flash_attention(q, k, v, True, None)
    assert kfa.LIBRARY.launches == 0 and not fa_ops.kernel_route(q)
    assert torch.equal(got, rfa.attention(q, k, v, causal=True))
    with pytest.raises(ValueError, match="head dims"):
        kfa.flash_attention_fwd(q, k, v)
    assert kfa.LIBRARY.launches == 0


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [(40, 8), (48, 8)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
def test_flash_kernel_at_moe_group_ratios(heads, dtype, tol):
    """GQA 40/8 (llama4 scout) and 48/8 (dbrx), group ratios 5 and 6, at
    hd 128 on (B, S, H, hd) views as the model passes them, a ragged
    length and a window included."""
    _need_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    h, kv = heads
    g = torch.Generator(device="cuda").manual_seed(h)
    for s, window in ((256, None), (300, None), (200, 70)):
        q, k, v = (torch.randn(2, s, n, 128, device="cuda", generator=g)
                   .to(dtype).transpose(1, 2) for n in (h, kv, kv))
        kfa.LIBRARY.launches = 0
        got = kfa.flash_attention_fwd(q, k, v, causal=True, window=window)
        assert kfa.LIBRARY.launches == 1
        want = rfa.attention(q, k, v, causal=True, window=window)
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama4_scout_17b_a16e", "dbrx_132b"])
def test_smoke_moe_serve_on_card_matches_cpu_run(arch):
    """The MoE smoke configs (hd 16) served on the card with the devices
    left at their defaults: attention takes the plain route (no flash
    launch), and the greedy tokens and prefill logits equal a host run of
    the same float32 weights."""
    _need_cuda()
    cfg = get_smoke_config(arch)
    cpu = Model(cfg, device="cpu")
    params = cpu.init(torch.Generator().manual_seed(0))
    state = {k: t.detach() for k, t in params.state_dict().items()}
    gpu_params = Model(cfg).load(state)
    assert gpu_params.blocks[0].moe["router"].is_cuda
    kw = dict(batch=2, prompt_len=40, gen_len=8, max_len=64, seed=1,
              verbose=False)
    kfa.LIBRARY.launches = 0
    got, _ = serve_lm.serve(arch, params=gpu_params, **kw)
    assert kfa.LIBRARY.launches == 0
    want, _ = serve_lm.serve(arch, device="cpu", params=params, **kw)
    np.testing.assert_array_equal(got, want)
    tokens = torch.from_numpy(serve_lm.make_prompts(cfg.vocab_size, 2, 40,
                                                    1)).long()
    lg_gpu, _ = transformer.prefill(gpu_params, tokens.cuda(), max_len=64)
    lg_cpu, _ = transformer.prefill(params, tokens, max_len=64)
    torch.testing.assert_close(lg_gpu.cpu(), lg_cpu, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("case", [
    (12, 12, 1500, 1500, 64, False, None),     # whisper's encoder
    (12, 12, 224, 1500, 64, False, None),      # its cross-attention
    (10, 1, 3072, 3072, 256, True, 2048),      # recurrentgemma's lattn
], ids=["encoder_1500", "cross_224x1500", "mqa10_hd256_window"])
def test_flash_kernel_at_lm_family_shapes(case, dtype, tol):
    """Whisper's non-causal ragged 1500-key encoder call and its
    cross-attention (Sq != Skv), and recurrentgemma's local attention (MQA
    10/1, hd 256, a 2048 window over 3072 tokens), on (B, S, H, hd)
    views as the model passes them."""
    _need_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    h, kv, sq, skv, hd, causal, window = case
    g = torch.Generator(device="cuda").manual_seed(sq + skv)
    q, k, v = (torch.randn(2, s, n, hd, device="cuda", generator=g)
               .to(dtype).transpose(1, 2)
               for s, n in ((sq, h), (skv, kv), (skv, kv)))
    kfa.LIBRARY.launches = 0
    got = kfa.flash_attention_fwd(q, k, v, causal=causal, window=window)
    assert kfa.LIBRARY.launches == 1 and got.dtype == dtype
    want = rfa.attention(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.float(), atol=tol,
                               rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["phi3_mini_3_8b", "rwkv6_3b",
                                  "recurrentgemma_2b", "whisper_small"])
def test_smoke_lm_family_serve_on_card_matches_cpu_run(arch):
    """The RWKV-6, RG-LRU, encoder-decoder and phi3 smoke configs served
    on the card with the devices left at their defaults (their head dims
    take the plain route: no flash launch) give the greedy tokens and
    prefill logits of a host run of the same float32 weights."""
    _need_cuda()
    cfg = get_smoke_config(arch)
    params = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    state = {k: t.detach() for k, t in params.state_dict().items()}
    gpu_params = Model(cfg).load(state)
    kw = dict(batch=2, prompt_len=40, gen_len=8, max_len=64, seed=1,
              verbose=False)
    kfa.LIBRARY.launches = 0
    got, _ = serve_lm.serve(arch, params=gpu_params, **kw)
    assert kfa.LIBRARY.launches == 0
    want, _ = serve_lm.serve(arch, device="cpu", params=params, **kw)
    np.testing.assert_array_equal(got, want)
    inputs = serve_lm.model_inputs(cfg, 2, 40, 1, "cpu")
    lg_cpu, _ = Model(cfg, device="cpu").prefill(params, inputs, max_len=64)
    lg_gpu, _ = Model(cfg).prefill(
        gpu_params, {k: t.cuda() for k, t in inputs.items()}, max_len=64)
    torch.testing.assert_close(lg_gpu.cpu(), lg_cpu, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_smoke_serve_on_card_matches_cpu_run():
    """The same float32 weights (smoke mistral, head_dim 64 so the kernel
    takes it) on the card and on the host: prefill logits within 1e-4,
    equal greedy tokens, one flash launch per layer for the prefill."""
    _need_cuda()
    cfg = get_smoke_config("mistral_nemo_12b").replace(head_dim=64)
    cpu = Model(cfg, device="cpu")
    params = cpu.init(torch.Generator().manual_seed(0))
    state = {k: t.detach() for k, t in params.state_dict().items()}
    gpu_params = Model(cfg).load(state)
    kw = dict(batch=2, prompt_len=40, gen_len=8, max_len=64, seed=1,
              verbose=False)
    kfa.LIBRARY.launches = 0
    got, _ = serve_lm.serve("mistral_nemo_12b", params=gpu_params, **kw)
    assert kfa.LIBRARY.launches == cfg.num_layers
    want, _ = serve_lm.serve("mistral_nemo_12b", device="cpu",
                             params=params, **kw)
    np.testing.assert_array_equal(got, want)
    tokens = torch.from_numpy(serve_lm.make_prompts(cfg.vocab_size, 2, 40,
                                                    1)).long()
    lg_gpu, _ = transformer.prefill(gpu_params, tokens.cuda(), max_len=64)
    lg_cpu, _ = transformer.prefill(params, tokens, max_len=64)
    torch.testing.assert_close(lg_gpu.cpu(), lg_cpu, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_start_d2h_pinned_copy_equals_cpu():
    """One D2H group: every CUDA leaf lands in pinned host memory equal to
    ``.cpu()``, host leaves pass through, one ``d2h_streams`` bump."""
    _need_cuda()
    from repro_torch.ph.overlap import OverlapCounters, start_d2h
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(1 << 20, device="cuda", generator=g)
    tree = {"x": x * 3, "i": [x.to(torch.int32), torch.tensor(7).cuda()],
            "bf": x.to(torch.bfloat16), "host": torch.arange(3)}
    counters = OverlapCounters()
    got = start_d2h(tree, counters).result()
    for key in ("x", "bf"):
        assert got[key].is_pinned() and torch.equal(got[key],
                                                    tree[key].cpu())
    assert torch.equal(got["i"][0], tree["i"][0].cpu())
    assert int(got["i"][1]) == 7 and got["host"] is tree["host"]
    assert counters.snapshot()["d2h_streams"] == 1


@pytest.mark.cuda
def test_staging_pool_never_reuses_a_slot_still_being_read():
    """A released slot whose reader is still queued (behind a device
    sleep) is not handed out again: the next batch gets another slot, and
    the queued computation reads the bytes that were staged for it.  Once
    the reader has finished, the slot is reused."""
    _need_cuda()
    from repro_torch.distributed.context import canonical_device
    from repro_torch.ph.overlap import StagingPool
    dev = (canonical_device("cuda"),)
    shape = (1, 512, 512)
    pool = StagingPool(reuse=True)
    a = pool.acquire(dev, shape, torch.float32, torch.float32)
    a.host_batch.copy_(torch.arange(512 * 512.0).reshape(shape))
    a.host_tvals.fill_(1.0)
    pool.upload(a)
    (xa,), (ta,) = a.ready()
    xa * 2 + ta        # load the kernels first: a lazy load may sync
    torch.cuda.synchronize()
    torch.cuda._sleep(1_000_000_000)        # the reader waits behind this
    out = xa * 2 + ta
    pool.release(a)
    b = pool.acquire(dev, shape, torch.float32, torch.float32)
    assert b is not a
    b.host_batch.fill_(-1.0)
    b.host_tvals.fill_(-1.0)
    pool.upload(b)
    torch.cuda.synchronize()
    assert torch.equal(out.cpu(), a.host_batch * 2 + 1.0)
    assert pool.acquire(dev, shape, torch.float32, torch.float32) is a


@pytest.mark.cuda
def test_begin_staged_enqueues_without_blocking():
    """A staged round's dispatch side (``load_round`` + ``begin_staged``)
    runs under sync debug mode "error" with the overlap on; resolving it
    gives the synchronous executor's diagram."""
    _need_cuda()
    from repro_torch.distributed.context import single_device_ctx
    from repro_torch.ph import OverlapSpec
    from repro_torch.pipeline.executor import ShardedPHExecutor
    from repro_torch.pipeline.scheduler import BucketRound, ImageMeta
    cfg = PHConfig(merge_impl="boruvka", filter_level="filter_std")
    rnd = BucketRound("whole", (256, 256), ((0, ImageMeta(3, (200, 200))),))
    over = ShardedPHExecutor(PHEngine(cfg.replace(overlap=OverlapSpec())),
                             single_device_ctx())
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = over.begin_staged(over.load_round(rnd))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    got = pending.resolve()[3]
    sync = ShardedPHExecutor(PHEngine(cfg), single_device_ctx())
    want = sync.run_staged(sync.load_round(rnd))[3]
    assert got.birth.device.type == "cpu"
    _same_diagrams(got, want)
    snap = over.engine.overlap_counters.snapshot()
    assert snap["h2d_transfers"] == 1 and snap["dispatch_syncs"] == 0


@pytest.mark.cuda
def test_run_distributed_on_card_equals_per_image_runs():
    """A small mixed survey with a tiled frame through ``run_distributed``
    on the card, synchronous and overlapped: equal summaries, and each
    equal to the summary of the engine's own ``run`` / ``run_tiled``; the
    overlapped run takes the default context (the engine's card alone) and
    copies one result to the host a round."""
    _need_cuda()
    from repro_torch.distributed.context import single_device_ctx
    from repro_torch.ph import OverlapSpec, TileSpec
    from repro_torch.pipeline.driver import _summarize
    images = [(0, 256), (1, 200), (2, 512), (3, 256)]
    cfg = PHConfig(merge_impl="boruvka", filter_level="filter_std",
                   tile=TileSpec(max_tile_pixels=256 * 256))
    ctx = single_device_ctx()
    kc.LIBRARY.launches = ka.LIBRARY.launches = 0
    sync = PHEngine(cfg).run_distributed(images, ctx=ctx)
    assert ka.LIBRARY.launches > 0 and kc.LIBRARY.launches > 0
    over = PHEngine(cfg.replace(overlap=OverlapSpec()))
    got = over.run_distributed(images)
    assert got.diagrams == sync.diagrams and got.rounds == sync.rounds
    snap = over.overlap_counters.snapshot()
    assert snap["dispatch_syncs"] == 0 and snap["h2d_transfers"] == 3
    assert snap["d2h_streams"] == got.rounds
    eng = PHEngine(cfg)
    for i, size in images:
        if size * size > 256 * 256:
            res = eng.run_tiled(astro.AstroImage(i, size))
        else:
            res = eng.run(astro.generate_image(i, size))
        assert _summarize(res.diagram) == sync.diagrams[i]


def _serving_engine(overlap, buckets=(64, 128)):
    from repro_torch.ph import OverlapSpec, ServeSpec
    return PHEngine(PHConfig(
        merge_impl="boruvka", phase_c_impl="fused", filter_level="filter_std",
        serve=ServeSpec(buckets=buckets, batch_cap=4, tick_interval_s=0.001),
        overlap=OverlapSpec() if overlap else None))


def _serving_images(n, buckets=(64, 128), seed=19):
    """Windows of an astro frame, sides 60-100 % of their bucket."""
    rng = np.random.default_rng(seed)
    frame = astro.generate_image(seed, max(buckets))
    out = []
    for k in range(n):
        b = buckets[k % len(buckets)]
        h, w = (int(rng.integers(int(b * 0.6), b + 1)) for _ in range(2))
        out.append(np.ascontiguousarray(frame[:h, :w]))
    return out


def _same_rows(want, got):
    assert np.array_equal(want.to_array(), got.to_array())
    assert int(want.diagram.n_unmerged) == int(got.diagram.n_unmerged)
    assert bool(want.diagram.overflow) == bool(got.diagram.overflow)


@pytest.mark.cuda
def test_warmed_server_on_card_builds_and_regrows_nothing():
    """After ``warmup`` a served stream on the card builds no plan, regrows
    nothing, launches phase A and best-edge, and never blocks the tick."""
    _need_cuda()
    from repro_torch.serving import PHServer
    eng = _serving_engine(overlap=True)
    imgs = _serving_images(12)
    with PHServer(eng) as srv:
        info = srv.warmup()
        assert info["plans"] == info["traces"] > 0
        regrows = len(eng.regrow_log)
        ka.LIBRARY.launches = kc.LIBRARY.launches = 0
        results = [f.result(timeout=300)
                   for f in [srv.submit(im) for im in imgs]]
        assert srv.steady_state_traces() == 0
        st = srv.stats()
    assert len(eng.regrow_log) == regrows
    assert ka.LIBRARY.launches > 0 and kc.LIBRARY.launches > 0
    assert st["failed"] == 0 and st["completed"] == len(imgs)
    assert st["overlap"]["dispatch_syncs"] == 0
    assert st["overlap"]["harvest_syncs"] > 0
    ref = PHEngine(PHConfig(merge_impl="boruvka", phase_c_impl="fused"))
    for im, res in zip(imgs, results):
        _same_rows(ref.run(im, res.threshold), res)


@pytest.mark.cuda
def test_server_tick_dispatch_enqueues_without_blocking():
    """The tick's dispatch of a warmed server (statistic, staging into a
    reused pinned slot, upload) under sync debug mode "error", with the
    harvest held back; resolving it afterwards gives ``run``'s rows."""
    _need_cuda()
    from repro_torch.serving import PHServer

    class Deferred:
        def __init__(self):
            self.calls = []

        def submit(self, fn, *args):
            self.calls.append((fn, args))

        def shutdown(self, wait=True):
            calls, self.calls = self.calls, []
            for fn, args in calls:
                fn(*args)

    eng = _serving_engine(overlap=True)
    eng.warmup()
    srv = PHServer(eng, start=False)
    srv._harvest.shutdown(wait=True)
    srv._harvest = deferred = Deferred()
    imgs = _serving_images(3, buckets=(128,))
    futs = [srv.submit(im) for im in imgs]
    bucket, reqs = srv._next_batch()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        handed = srv._dispatch(bucket, reqs)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert handed, futs[0].exception()
    assert not any(f.done() for f in futs) and len(deferred.calls) == 1
    srv.shutdown()              # runs the held harvest
    ref = PHEngine(PHConfig(merge_impl="boruvka", phase_c_impl="fused"))
    for im, f in zip(imgs, futs):
        res = f.result(timeout=0)
        _same_rows(ref.run(im, res.threshold), res)
    assert eng.overlap_counters.snapshot()["dispatch_syncs"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("overlap", [False, True])
def test_served_rows_are_host_tensors_equal_to_run(overlap):
    """Served rows live in host memory whether the engine leaves its
    batch's diagram on the card (no overlap) or streams it to pinned
    memory, and equal ``run`` on the card."""
    _need_cuda()
    from repro_torch.serving import PHServer
    eng = _serving_engine(overlap=overlap)
    imgs = _serving_images(6)
    with PHServer(eng) as srv:
        results = [f.result(timeout=300)
                   for f in [srv.submit(torch.from_numpy(im).cuda())
                             for im in imgs]]
    for im, res in zip(imgs, results):
        assert all(f.device.type == "cpu" and not f.is_pinned()
                   for f in res.diagram)
        _same_rows(eng.run(im, res.threshold), res)


@pytest.mark.cuda
def test_saturated_server_meets_admission_with_flat_device_memory():
    """Thresholds given (no statistic on the tick) and the harvest held:
    the tick stages at most ``staging_depth`` batches, the queue fills and
    admission rejects; two such rounds leave the same device memory and
    no more staging slots than the depth, and every accepted request
    equals ``run``."""
    _need_cuda()
    import threading

    from repro_torch.ph import ServeSpec
    from repro_torch.serving import AdmissionError, PHServer
    eng = _serving_engine(overlap=True, buckets=(128,))
    eng.warmup()
    depth = eng.overlap_spec().staging_depth
    spec = ServeSpec(buckets=((128, 128),), batch_cap=4, max_queue=4,
                     tick_interval_s=0.0, admission="reject")
    imgs = _serving_images(8, buckets=(128,))
    tvs = [eng.auto_threshold(im) for im in imgs]
    staged, memory, slots, served = [], [], [], []
    real_async = eng.run_batch_async

    def counted(*a, **kw):
        staged.append(1)
        return real_async(*a, **kw)

    eng.run_batch_async = counted
    for _ in range(2):
        srv = PHServer(eng, spec=spec)
        gate, finish = threading.Event(), srv._finish_batch
        srv._finish_batch = lambda *a: (gate.wait(60), finish(*a))
        staged.clear()
        futs, rejected = [], False
        try:
            for k in range(200):
                try:
                    futs.append((k % 8, srv.submit(imgs[k % 8], tvs[k % 8])))
                except AdmissionError:
                    rejected = True
                    break
                time.sleep(0.01)
            n_staged = len(staged)
        finally:
            gate.set()
        assert srv.drain(300)
        srv.shutdown()
        assert rejected and n_staged <= depth
        torch.cuda.synchronize()
        memory.append(torch.cuda.memory_allocated())
        slots.append(sum(len(v) for v in eng.staging._idle.values()))
        served += futs
    assert memory[0] == memory[1]
    assert max(slots) <= depth
    for k, f in served:
        _same_rows(eng.run(imgs[k], tvs[k]), f.result(0))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_phase_a_kernel_at_tuned_strip_heights(dtype):
    """The autotuner's strip heights 4 and 32: at S = 32 a 4096-wide strip
    spans a cluster of 3 blocks whose last block is ragged (11, 11, 10
    rows) and a 2048-wide strip fills exactly the 16-bit regime's 65,536
    entries; on ragged last strips, the stride-2 peak grid the searches
    measure on, and (float32) the 4096² astro frame and the survey
    bucket."""
    _need_cuda()
    from repro_torch.roofline.autotune import peak_grid
    assert ka.strip_layout(32, 4096) == ("cluster", 3)
    assert ka.strip_layout(32, 2048) == ("shared16", 1)
    assert 32 * 2048 == ka.NARROW_ENTRIES
    for s in (4, 32):
        for w in (2048, 4096):
            h = 2 * s + 3
            for levels in (None, 3):
                _phase_a_equal(_image(dtype, (h, w), w + s, levels), s,
                               (dtype, h, w, levels))
        for size in (2048, 4096):
            _phase_a_equal(peak_grid((size, size), dtype, "cuda"), s,
                           (dtype, "peak grid", size))
    if dtype == torch.float32:
        frame = torch.from_numpy(astro.generate_image(0, 4096)).cuda()
        frames = [astro.generate_window(i, 0, 0, h, w, size=2048)
                  for i, (h, w) in enumerate(((2048, 2048), (2048, 1536),
                                              (1536, 1536), (1024, 2048),
                                              (1000, 1800)), start=10)]
        bucket = torch.full((5, 2048, 2048), float("-inf"))
        for i, f in enumerate(frames):
            bucket[i, :f.shape[0], :f.shape[1]] = torch.from_numpy(f)
        for s in (4, 32):
            _phase_a_equal(frame, s, "astro 4096²")
            _phase_a_equal(bucket.cuda(), s, "survey bucket")


@pytest.mark.cuda
def test_autotune_on_card_persists_cuda_entries(tmp_path):
    """Both searches on the card write ``"cuda"`` entries that name it; a
    tuned engine's lookup launches nothing, and its ``run`` and
    ``run_tiled`` equal the untuned engine's through the kernels."""
    _need_cuda()
    from repro_torch.roofline import autotune as at
    from repro_torch.ph import TileSpec
    path = tmp_path / "cache.json"
    ka.LIBRARY.launches = kc.LIBRARY.launches = 0
    best = at.autotune((256, 256), "float32", path=path, measure_top=4,
                       trials=2)
    assert best.source == "measured"
    assert ka.LIBRARY.launches > 0 and kc.LIBRARY.launches > 0
    grid = at.autotune_grid((512, 512), torch.float32, path=path,
                            max_tile_pixels=128 * 128, trials=1)
    cache = json.loads(path.read_text())
    scalar, tiled = cache["256x256|float32|cuda"], cache["512x512|float32|cuda"]
    name = torch.cuda.get_device_name()
    assert scalar["device"] == tiled["device"] == name
    assert len(scalar["trials"]) == 4
    assert all(t["seconds"] > 0 and t["spread_s"] >= 0
               for t in scalar["trials"])
    assert tuple(tiled["tile_grid"]) == grid
    cfg = PHConfig(merge_impl="boruvka", filter_level="filter_std",
                   tile=TileSpec(max_tile_pixels=128 * 128))
    tuned = PHEngine(cfg.replace(autotune=True, autotune_cache=str(path)))
    ka.LIBRARY.launches = kc.LIBRARY.launches = 0
    eff = tuned._effective_config((256, 256), torch.float32)
    assert tuned._tuned_grid((512, 512), torch.float32) == grid
    assert ka.LIBRARY.launches == kc.LIBRARY.launches == 0
    assert (eff.strip_rows, eff.tournament_width) == (
        best.strip_rows, best.tournament_width)
    small, big = astro.generate_image(1, 256), astro.generate_image(2, 512)
    _same_diagrams(tuned.run(small).diagram, PHEngine(cfg).run(small).diagram)
    assert ka.LIBRARY.launches > 0
    res = tuned.run_tiled(big)
    assert tuple(res.config.tile.grid) == grid and kc.LIBRARY.launches > 0
    _same_diagrams(res.diagram, PHEngine(cfg).run_tiled(big).diagram)


def _smoke_train_setup(remat: str, seq: int = 128, batch: int = 2):
    """qwen smoke at head dim 64 (the kernel's route), weights from seed
    0 on the card, and TokenStream batch 0."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.tokens import TokenStream
    cfg = get_smoke_config("qwen1_5_0_5b").replace(head_dim=64, remat=remat)
    params = Model(cfg).init(torch.Generator(device="cuda").manual_seed(0))
    host = TokenStream(cfg.vocab_size, seq, batch).batch_at(0)
    return (cfg, params, ShapeConfig("train", seq, batch, "train"),
            {k: torch.from_numpy(v).cuda() for k, v in host.items()})


@pytest.mark.cuda
@pytest.mark.parametrize("remat", ["full", "none"])
def test_smoke_train_step_kernel_matches_plain(remat):
    """One train step through the kernel against one through the plain
    attention, same weights and batch (float32: the loss, grad norm and
    first moments at 1e-4); the kernel launches twice per layer under
    remat "full" (forward and recompute), once under "none", and the
    plain route never."""
    _need_cuda()
    from repro_torch.launch import steps
    from repro_torch.optim.adamw import AdamW
    cfg, params, shape, batch = _smoke_train_setup(remat)
    start = {k: p.detach().clone() for k, p in params.named_parameters()}
    out = {}
    for plain in (False, True):
        with torch.no_grad():
            for k, p in params.named_parameters():
                p.copy_(start[k])
        bundle = steps.train_bundle(cfg, shape, plain=plain)
        kfa.LIBRARY.launches = 0
        _, state, m = bundle.fn(params, AdamW().init(params), batch)
        torch.cuda.synchronize()
        out[plain] = (kfa.LIBRARY.launches, m, state.mu)
    per_layer = 2 if remat == "full" else 1
    assert out[False][0] == per_layer * cfg.num_layers and out[True][0] == 0
    for k in ("loss", "grad_norm"):
        torch.testing.assert_close(out[False][1][k], out[True][1][k],
                                   rtol=1e-4, atol=1e-4)
    for k, want in out[True][2].items():
        err = float((out[False][2][k] - want).abs().max())
        assert err <= 1e-4 * float(want.abs().max()), k


@pytest.mark.cuda
def test_async_checkpoint_holds_values_before_in_place_update(tmp_path):
    """A save, then at once the next train step, which updates the
    parameters in place: the checkpoint holds the values of the save."""
    _need_cuda()
    from repro_torch.checkpoint import ckpt
    from repro_torch.launch import steps
    from repro_torch.optim.adamw import AdamW
    cfg, params, shape, batch = _smoke_train_setup("full")
    opt = AdamW(lr=1e-2, warmup_steps=1)
    state = opt.init(params)
    bundle = steps.train_bundle(cfg, shape, opt)
    params, state, _ = bundle.fn(params, state, batch)
    before = {k: p.detach().cpu().clone()
              for k, p in params.named_parameters()}
    saver = ckpt.AsyncCheckpointer()
    saver.save(tmp_path, 1, (params, state))
    params, state, _ = bundle.fn(params, state, batch)
    saver.join()
    target = Model(cfg).init(torch.Generator(device="cuda").manual_seed(1))
    (got, st), _, step = ckpt.restore(tmp_path, (target, opt.init(target)),
                                      device="cpu")
    assert step == 1 and int(st.count) == 1
    moved = 0
    for k, p in params.named_parameters():
        assert torch.equal(got.get_parameter(k), before[k]), k
        moved += not torch.equal(p.detach().cpu(), before[k])
    assert moved > 0


@pytest.mark.cuda
@pytest.mark.parametrize("allow_inf", [False, True])
def test_check_finite_one_readback_on_card(allow_inf):
    """On the card the check is one min/max reduction and one readback,
    with or without ``allow_inf``, and a bad last element still raises
    the shared messages (NaN before inf)."""
    _need_cuda()
    from repro_torch import telemetry
    from repro_torch.core.packed_keys import check_finite
    x = torch.linspace(-3.0, 3.0, 4096 * 4096, device="cuda").view(4096, 4096)
    telemetry.reset()
    telemetry.enable()
    try:
        assert check_finite(x, allow_inf=allow_inf) is x
        counters = telemetry.snapshot()["counters"]
    finally:
        telemetry.disable()
        telemetry.reset()
    assert counters == {("readbacks", "check_finite"): 1}
    inf = x.clone()
    inf.view(-1)[-1] = float("inf")
    if allow_inf:
        assert check_finite(inf, allow_inf=True) is inf
    else:
        with pytest.raises(ValueError, match="infinite values collide"):
            check_finite(inf)
    nan = inf.clone()
    nan.view(-1)[0] = float("-inf")
    nan.view(-1)[-1] = float("nan")
    with pytest.raises(ValueError, match="NaN values cannot be ordered"):
        check_finite(nan, allow_inf=allow_inf)
