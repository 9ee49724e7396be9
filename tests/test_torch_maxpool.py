"""Port parity: 3x3 pooling (repro_torch.kernels.maxpool) and the paths it
unlocks — pooled phase A and the paper's candidate rule — vs the reference.

The plain PyTorch pools are held bitwise to ``repro.kernels.maxpool.ref``
over every kernel dtype; pooled / paper PixHomology is held bitwise to the
JAX ``pixhomology`` (every ``Diagram`` field, ``n_unmerged`` included)
for each merge.  The reference's packed keys resolve to ranks without
64-bit mode, so the port's packed-key runs are held to the reference's
rank-key runs (the encodings are specified to give identical diagrams).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from _torch_parity import (DTYPES, assert_same, assert_same_diagram, host,
                           make_image, to_jax, to_torch)
from repro.core import num_candidates as jnum_candidates
from repro.core import pixhomology as jpixhomology
from repro.kernels.maxpool import kernel as jkernel
from repro.kernels.maxpool import ref as jref
from repro_torch.core import num_candidates, pixhomology
from repro_torch.core.grid import shift2d
from repro_torch.kernels.maxpool import ops, ref

SHAPES = [(1, 1), (1, 7), (7, 1), (5, 6), (13, 11), (17, 33)]
IMPLS = [("scan", "fused"), ("boruvka", "xla"), ("boruvka", "fused")]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_pools_match_reference(dtype, shape):
    for kind in ("gauss", "ties", "negative"):
        img = make_image(dtype, kind, seed=sum(shape), shape=shape)
        xj, xt = to_jax(img, dtype), to_torch(img, dtype)
        want_v, want_a = jref.maxargmaxpool3x3(xj)
        got_v, got_a = ops.maxargmaxpool3x3(xt)
        what = f"{dtype}{shape} {kind}"
        assert_same(want_v, got_v, f"maxpool value {what}")
        assert_same(want_a, got_a, f"argmax {what}")
        assert_same(jref.maxpool3x3(xj), ops.maxpool3x3(xt), f"max {what}")
        assert_same(jref.minpool3x3(xj), ops.minpool3x3(xt), f"min {what}")


def test_signed_zeros_and_batches():
    """-0.0 pools below +0.0 (as jnp.maximum/minimum order them); leading
    axes are batch axes with per-image flat indices."""
    img = np.array([[0.0, -0.0, 1.0], [-0.0, -0.0, 0.0], [-1.0, 0.0, -0.0]],
                   np.float32)
    for dtype in ("float32", "bfloat16"):
        xj, xt = to_jax(img, dtype), to_torch(img, dtype)
        for jf, tf in ((jref.maxpool3x3, ref.maxpool3x3),
                       (jref.minpool3x3, ref.minpool3x3)):
            want = np.asarray(jf(xj).astype(jnp.float32))
            got = tf(xt).float().numpy()
            np.testing.assert_array_equal(np.signbit(want), np.signbit(got))
            np.testing.assert_array_equal(want, got)
    batch = np.stack([make_image("int32", k, seed=3, shape=(9, 10))
                      for k in ("gauss", "ties", "negative")])
    bv, ba = ref.maxargmaxpool3x3(torch.from_numpy(batch))
    for i in range(3):
        v, a = ref.maxargmaxpool3x3(torch.from_numpy(batch[i]))
        assert torch.equal(bv[i], v) and torch.equal(ba[i], a)


def test_fill_valued_borders_follow_ref_not_pallas_kernel():
    """Border pixels equal to the pad fill (uint8 0, int32 min): the
    port's argmax never picks an out-of-image cell, as ``ref.py``
    specifies.  The reference's Pallas kernel (interpret mode) lets a pad
    cell win the tie there and returns an index outside the image or in
    the wrong row — a reference caveat (ROADMAP.md queue 3)."""
    cases = [np.zeros((5, 6), np.uint8),
             np.full((4, 7), np.iinfo(np.int32).min, np.int32)]
    zeros_uint8 = cases[0]
    for img in cases:
        want = np.asarray(jref.argmaxpool3x3(jnp.asarray(img)))
        _, got = ops.maxargmaxpool3x3(torch.from_numpy(img))
        np.testing.assert_array_equal(want, got.numpy())
        assert (got >= 0).all() and (got < img.size).all()
    _, pallas = jkernel.maxargmaxpool3x3(jnp.asarray(zeros_uint8),
                                         interpret=True)
    pallas = np.asarray(pallas)
    assert pallas[0, 5] == 12 and pallas[4].tolist() == list(range(31, 37))
    _, got = ops.maxargmaxpool3x3(torch.from_numpy(zeros_uint8))
    assert got[0, 5] == 11 and got[4].tolist() == [25, 26, 27, 28, 29, 29]


@pytest.mark.parametrize("kind", ["gauss", "ties"])
def test_keyed_steepest_pointers_match_reference(kind):
    """With flat indices as keys the keyed stencil is the arg-maxpool
    pointer; with other keys (the tiled path's global ids) it equals the
    reference's."""
    from repro.core.pixhomology import keyed_steepest_pointers as jkeyed
    from repro_torch.core import keyed_steepest_pointers, steepest_neighbors
    img = make_image("float32", kind, seed=6, shape=(9, 13))
    x = torch.from_numpy(img)
    flat = torch.arange(img.size, dtype=torch.int32).reshape(img.shape)
    assert torch.equal(keyed_steepest_pointers(x, flat).reshape(-1),
                       steepest_neighbors(x))
    keys = np.random.default_rng(7).permutation(img.size).astype(
        np.int32).reshape(img.shape)
    want = jkeyed(jnp.asarray(img), jnp.asarray(keys))
    got = keyed_steepest_pointers(x, torch.from_numpy(keys))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_shift2d_keeps_int64_sentinels_exact():
    """The paper rule's directional fills are the int64 key extremes; a
    double-valued fill would round ``iinfo(int64).max`` out of range."""
    x = torch.arange(6, dtype=torch.int64).reshape(2, 3)
    for fill in (torch.iinfo(torch.int64).max, torch.iinfo(torch.int64).min):
        y = shift2d(x, 1, -1, fill)
        assert y[1, 0] == fill and y[0, 0] == fill and y[0, 1] == 3


def _reference(img, dtype, **kw):
    n = img.size
    return jpixhomology(to_jax(img, dtype), merge_keys="rank",
                        max_features=n, max_candidates=n, **kw)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("candidate_mode", ["exact", "paper"])
def test_pooled_paths_match_reference(dtype, candidate_mode):
    for kind in ("gauss", "ties"):
        img = make_image(dtype, kind, seed=4, shape=(12, 11))
        n = img.size
        for merge_impl, impl in IMPLS:
            kw = dict(phase_a_impl="pooled", candidate_mode=candidate_mode,
                      merge_impl=merge_impl, phase_c_impl=impl)
            want = _reference(img, dtype, **kw)
            for keys in ("packed", "rank"):
                got = pixhomology(to_torch(img, dtype), merge_keys=keys,
                                  max_features=n, max_candidates=n, **kw)
                assert_same_diagram(want, got, f"{dtype} {kind} {kw} {keys}")


@pytest.mark.parametrize("phase_a_impl", ["fused", "pooled"])
def test_paper_mode_fused_phase_a_and_num_candidates(phase_a_impl):
    img = make_image("float32", "gauss", seed=5, shape=(12, 11))
    x = torch.from_numpy(img)
    for mode in ("exact", "paper"):
        for tv in (None, 10.0):
            want = int(jnum_candidates(jnp.asarray(img), mode, tv,
                                       phase_a_impl=phase_a_impl))
            assert num_candidates(x, mode, tv,
                                  phase_a_impl=phase_a_impl) == want
    want = _reference(img, "float32", phase_a_impl=phase_a_impl,
                      candidate_mode="paper", merge_impl="boruvka",
                      filtration="sublevel")
    got = pixhomology(x, max_features=img.size, max_candidates=img.size,
                      phase_a_impl=phase_a_impl, candidate_mode="paper",
                      merge_impl="boruvka", filtration="sublevel")
    assert_same_diagram(want, got, f"paper sublevel {phase_a_impl}")


def _greater(a, b):
    """``a > b`` with ``-0.0`` below ``+0.0``."""
    gt = a > b
    if a.dtype.is_floating_point:
        gt = gt | ((a == b) & torch.signbit(b) & ~torch.signbit(a))
    return gt


def _shifted(t, dr, dc):
    """``t[..., r + dr, c + dc]`` at (r, c), and where that cell lies in
    the image (elsewhere the value is an arbitrary 0, never compared)."""
    h, w = t.shape[-2:]
    out = torch.zeros_like(t)
    ok = torch.zeros((h, w), dtype=torch.bool)
    dst = (slice(max(0, -dr), h - max(0, dr)),
           slice(max(0, -dc), w - max(0, dc)))
    src = (slice(max(0, dr), h - max(0, -dr)),
           slice(max(0, dc), w - max(0, -dc)))
    out[(..., *dst)] = t[(..., *src)]
    ok[dst] = True
    return out, ok


def _separable_pools(x, minimum):
    """The CUDA kernel's two passes (``csrc/maxpool.cu``) in Python:
    per column the best of rows r-1, r, r+1, ties of the argmax going to
    the larger row; then per output the best of columns c-1, c, c+1, the
    argmax comparing (value, flat index).  Out-of-image cells are skipped
    by position.  Returns (pooled value, argmax flat index)."""
    h, w = x.shape[-2:]
    rows = torch.arange(h).reshape(h, 1).expand(h, w)
    cols = torch.arange(w).reshape(1, w).expand(h, w)

    def beats(a, b):
        return _greater(b, a) if minimum else _greater(a, b)

    pool, arg, row = x, x, rows.expand(x.shape)
    for dr in (-1, 1):                          # vertical pass
        v, ok = _shifted(x, dr, 0)
        pool = torch.where(ok & beats(v, pool), v, pool)
        wins = ok & ((v > arg) if dr < 0 else (v >= arg))
        arg = torch.where(wins, v, arg)
        row = torch.where(wins, rows + dr, row)
    out, best, idx = pool, arg, row * w + cols
    for dc in (-1, 1):                          # horizontal pass
        (p, ok), (a, _), (r, _) = (_shifted(t, 0, dc)
                                   for t in (pool, arg, row))
        i = r * w + cols + dc
        out = torch.where(ok & beats(p, out), p, out)
        wins = ok & ((a > best) | ((a == best) & (i > idx)))
        best = torch.where(wins, a, best)
        idx = torch.where(wins, i, idx)
    return out, idx.to(torch.int32)


def _pool_case(dtype, case):
    rng = np.random.default_rng(11)
    if case == "ties":
        img = make_image(dtype, "ties", seed=12, shape=(9, 14))
    elif case == "signed_zeros":
        img = rng.choice([0.0, -0.0, 1.0, -1.0], size=(8, 11))
        img = img.astype(np.float32 if dtype in ("float32", "bfloat16")
                         else dtype)
    elif case == "fill_border":
        fill = (np.iinfo(dtype).min if dtype in ("uint8", "int16", "int32")
                else -np.inf)
        img = np.array(make_image(dtype, "ties", seed=13, shape=(7, 10)))
        img[0, :] = img[-1, :] = img[:, 0] = img[:, -1] = fill
    else:                                       # a batch of three images
        img = np.stack([make_image(dtype, kind, seed=14, shape=(6, 9))
                        for kind in ("gauss", "ties", "negative")])
    return img


@pytest.mark.parametrize("case", ["ties", "signed_zeros", "fill_border",
                                  "batch"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_separable_passes_equal_plain_pools(dtype, case):
    """The kernel's separable order gives the plain pools bit for bit:
    heavy ties (a tied cell at row r+1 of the left column beats one at row
    r of the right column), signed zeros (-0.0 pools below +0.0, the
    argmax ties them), borders equal to the pad fill, batches; against
    the port's plain pools and the JAX package's."""
    img = _pool_case(dtype, case)
    x = to_torch(img, dtype)
    want_v, want_a = ref.maxargmaxpool3x3(x)
    got_v, got_a = _separable_pools(x, minimum=False)
    min_v, _ = _separable_pools(x, minimum=True)
    for got, want in ((got_v, want_v), (got_a, want_a),
                      (got_v, ref.maxpool3x3(x)),
                      (min_v, ref.minpool3x3(x))):
        assert got.dtype == want.dtype and torch.equal(got, want), case
        if got.dtype.is_floating_point:
            assert torch.equal(torch.signbit(got), torch.signbit(want))
    h, w = img.shape[-2:]                       # the JAX pools take 2-D
    for i, im in enumerate(img.reshape(-1, h, w)):
        xj = to_jax(im, dtype)
        jv, ja = jref.maxargmaxpool3x3(xj)
        for got, want in ((got_v, jv), (got_a, ja),
                          (got_v, jref.maxpool3x3(xj)),
                          (min_v, jref.minpool3x3(xj))):
            got = got.reshape(-1, h, w)[i]
            assert_same(want, got, f"{dtype} {case} vs the JAX package")
            np.testing.assert_array_equal(np.signbit(host(want)),
                                          np.signbit(host(got)))
