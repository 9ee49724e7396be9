"""Port parity: fused phase A (repro_torch.kernels.ph_phase_a) vs the reference.

The port's plain ``phase_a`` is held bitwise to the reference's XLA
``ref.phase_a`` over dtypes, tie-heavy images, ragged strips and
degenerate shapes, and to its Pallas kernel in interpret mode on a subset.
The CUDA kernel itself is tested on the card (tests/test_torch_cuda.py).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_parity import (DTYPES, assert_same, make_image, to_jax,
                           to_torch)
from repro.core import resolve_labels_frontier as jresolve_frontier
from repro.kernels.ph_phase_a import boundary_rows as jboundary_rows
from repro.kernels.ph_phase_a import kernel as jkernel
from repro.kernels.ph_phase_a import ref as jref
from repro_torch.core import resolve_labels, resolve_labels_frontier
from repro_torch.kernels.ph_phase_a import kernel as tkernel
from repro_torch.kernels.ph_phase_a import ops as tops
from repro_torch.kernels.ph_phase_a import ref as tref

SHAPES = [(13, 9), (1, 17), (17, 1), (1, 1)]


def _both(img, dtype, s):
    jp, jm = jref.phase_a(to_jax(img, dtype), strip_rows=s)
    tp, tm = tref.phase_a(to_torch(img, dtype), strip_rows=s)
    assert_same(jp, tp, f"ptr {dtype} S={s} {img.shape}")
    assert_same(jm, tm, f"mask {dtype} S={s} {img.shape}")
    return tp, tm


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["gauss", "ties"])
def test_plain_phase_a_matches_reference(dtype, kind):
    """13 rows: ragged last strip for S = 3 and 8."""
    img = make_image(dtype, kind, seed=len(kind), shape=(13, 9))
    for s in (1, 3, 8):
        _both(img, dtype, s)


@pytest.mark.parametrize("shape", [(1, 17), (17, 1), (1, 1)])
@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_plain_phase_a_degenerate_shapes(shape, dtype):
    img = make_image(dtype, "ties", seed=sum(shape), shape=shape)
    for s in (1, 3, 8):
        _both(img, dtype, s)


@pytest.mark.parametrize("dtype,s", [("float32", 3), ("uint8", 8),
                                     ("bfloat16", 1), ("int16", 5)])
def test_plain_phase_a_matches_pallas_interpret(dtype, s):
    img = make_image(dtype, "ties", seed=7, shape=(13, 9))
    jp, jm = jkernel.phase_a(to_jax(img, dtype), strip_rows=s,
                             interpret=True)
    tp, tm = tref.phase_a(to_torch(img, dtype), strip_rows=s)
    assert_same(jp, tp, "ptr vs Pallas interpret")
    assert_same(jm, tm, "mask vs Pallas interpret")


def test_ramp_and_fill_valued_images():
    """A column ramp makes in-strip chains as long as the width; images
    holding the dtype's fill value (uint8 0) must never pick an
    out-of-image neighbor."""
    ramp = np.tile(np.arange(40, dtype=np.float32), (6, 1))
    _both(ramp, "float32", 4)
    zeros = np.zeros((5, 6), np.uint8)
    zeros[2, 3] = 1
    _both(zeros, "uint8", 2)
    _both(np.full((4, 4), -32768, np.int16), "int16", 3)


def test_batched_phase_a_equals_per_image():
    imgs = np.stack([make_image("float32", "gauss", seed=i, shape=(9, 10))
                     for i in range(3)])
    bp, bm = tref.phase_a(torch.from_numpy(imgs), strip_rows=4)
    assert bp.shape == (3, 90)
    for i in range(3):
        p, m = tref.phase_a(torch.from_numpy(imgs[i]), strip_rows=4)
        assert torch.equal(bp[i], p) and torch.equal(bm[i], m)


@pytest.mark.parametrize("h,s", [(1, 8), (8, 8), (13, 8), (17, 4), (9, 1)])
def test_boundary_rows_and_frontier_resolution(h, s):
    np.testing.assert_array_equal(jboundary_rows(h, s),
                                  tops.boundary_rows(h, s))
    img = make_image("float32", "gauss", seed=h * s, shape=(h, 7))
    ptr, _ = tref.phase_a(torch.from_numpy(img), strip_rows=s)
    dense = resolve_labels(ptr)
    frontier = resolve_labels_frontier(ptr, (h, 7), s)
    assert torch.equal(dense, frontier)
    jptr, _ = jref.phase_a(jnp.asarray(img), strip_rows=s)
    jlabels = jax.jit(jresolve_frontier, static_argnums=(1, 2))(
        jptr, (h, 7), s)
    assert_same(jlabels, frontier, "frontier labels")


def test_dispatch_uses_plain_version_for_cpu_tensors():
    x = torch.from_numpy(make_image("float32", "gauss", seed=2))
    want = tref.phase_a(x, strip_rows=3)
    for use_pallas in (None, True, False):
        got = tops.fused_phase_a(x, strip_rows=3, use_pallas=use_pallas)
        assert all(torch.equal(a, b) for a, b in zip(want, got))
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.phase_a(x)
