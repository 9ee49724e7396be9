"""The port's hand-written CUDA kernels and engine on the card.

Every test here needs a CUDA device (``cuda`` marker) and skips without
one; the kernels have no CPU mode.  The file imports neither JAX nor the
reference package, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_phase_a_kernel_matches_plain_version(dtype):
    _need_cuda()
    for shape in ((13, 9), (1, 17), (17, 1), (1, 1), (40, 300)):
        for levels in (None, 3):
            x = _image(dtype, shape, sum(shape), levels)
            for s in (1, 3, 8, 16):
                kp, km = ka.phase_a(x, strip_rows=s)
                rp, rm = ra.phase_a(x, strip_rows=s)
                assert torch.equal(kp, rp) and torch.equal(km, rm), \
                    (dtype, shape, levels, s)
    batch = _image(dtype, (3, 21, 30), 5)
    kp, km = ka.phase_a(batch, strip_rows=8)
    rp, rm = ra.phase_a(batch, strip_rows=8)
    assert torch.equal(kp, rp) and torch.equal(km, rm)


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
