"""Port parity: whole-image PixHomology (repro_torch.core) vs the reference.

Every diagram field is compared bitwise.  The reference's packed keys
resolve to ranks without 64-bit mode, so the port's packed-key diagrams
are held to the reference's rank-key diagrams and to the port's union-find
oracle; the encodings are specified to give identical diagrams.  One
reference merge (Boruvka, fused) stands for all three: the reference's own
suite holds its merges bit-identical to each other.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from _torch_parity import (DTYPES, assert_same_diagram, make_image, to_jax,
                           to_torch)
from repro.core import pixhomology as jpixhomology
from repro_torch.core import (Diagram, batched_pixhomology, diagram_from_numpy,
                              diagram_to_array, diagram_to_numpy,
                              num_candidates, persistence_oracle,
                              pixhomology)
from repro_torch.kernels.ph_phase_a import kernel as tkernel

SHAPE = (12, 11)
N = SHAPE[0] * SHAPE[1]
IMPLS = [("scan", "fused"), ("boruvka", "xla"), ("boruvka", "fused")]


def _reference(img, dtype, **kw):
    kw.setdefault("max_features", N)
    kw.setdefault("max_candidates", N)
    return jpixhomology(to_jax(img, dtype), merge_keys="rank",
                        merge_impl="boruvka", phase_c_impl="fused", **kw)


def _port(img, dtype, merge_impl, phase_c_impl, merge_keys="packed", **kw):
    kw.setdefault("max_features", N)
    kw.setdefault("max_candidates", N)
    return pixhomology(to_torch(img, dtype), merge_impl=merge_impl,
                       phase_c_impl=phase_c_impl, merge_keys=merge_keys,
                       strip_rows=4, **kw)


@pytest.mark.parametrize("dtype", DTYPES)
def test_pixhomology_matches_reference_and_oracle(dtype):
    img = make_image(dtype, "gauss", seed=1, shape=SHAPE)
    want = _reference(img, dtype, strip_rows=4)
    oracle = persistence_oracle(img)
    for merge_impl, impl in IMPLS:
        for keys in ("packed", "rank"):
            got = _port(img, dtype, merge_impl, impl, keys)
            what = f"{dtype} {merge_impl}/{impl}/{keys}"
            assert_same_diagram(want, got, what)
            np.testing.assert_array_equal(diagram_to_array(got), oracle,
                                          err_msg=what)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["ties", "negative"])
def test_pixhomology_matches_oracle_on_plateaus(dtype, kind):
    if dtype == "uint8" and kind == "negative":
        kind = "gauss"
    img = make_image(dtype, kind, seed=2, shape=(9, 14))
    oracle = persistence_oracle(img)
    for merge_impl, impl in IMPLS:
        got = pixhomology(to_torch(img, dtype), max_features=126,
                          max_candidates=126, merge_impl=merge_impl,
                          phase_c_impl=impl, strip_rows=3)
        np.testing.assert_array_equal(diagram_to_array(got), oracle)


@pytest.mark.parametrize("img", [np.zeros((1, 1), np.float32),
                                 np.full((4, 5), 3.0, np.float32),
                                 np.arange(7, dtype=np.float32)[None, :]])
def test_degenerate_images_match_oracle(img):
    for merge_impl, impl in IMPLS:
        got = pixhomology(torch.from_numpy(img), max_features=img.size,
                          max_candidates=img.size, merge_impl=merge_impl,
                          phase_c_impl=impl)
        np.testing.assert_array_equal(diagram_to_array(got),
                                      persistence_oracle(img))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sublevel_matches_reference(dtype):
    img = make_image(dtype, "gauss", seed=3, shape=SHAPE)
    want = _reference(img, dtype, strip_rows=4, filtration="sublevel")
    for merge_impl, impl in IMPLS:
        got = _port(img, dtype, merge_impl, impl, filtration="sublevel")
        assert_same_diagram(want, got, f"sublevel {merge_impl}/{impl}")
    with pytest.raises(ValueError, match="floating"):
        pixhomology(torch.zeros(3, 3, dtype=torch.int32),
                    filtration="sublevel")


@pytest.mark.parametrize("dtype,t,filtration", [
    ("float32", 10.0, "superlevel"), ("uint8", 33.5, "superlevel"),
    ("int16", 12.5, "superlevel"), ("float32", -5.0, "sublevel")])
def test_truncated_matches_reference(dtype, t, filtration):
    img = make_image(dtype, "gauss", seed=4, shape=SHAPE)
    jt = jnp.asarray(t, jnp.float32)
    want_t = jpixhomology(to_jax(img, dtype), jt, max_features=N,
                          max_candidates=N, merge_keys="rank",
                          merge_impl="boruvka", strip_rows=4,
                          filtration=filtration)
    plain = diagram_to_numpy(_port(img, dtype, "boruvka", "fused",
                                   filtration=filtration))
    assert not np.array_equal(plain.death, np.asarray(want_t.death))
    for merge_impl, impl in IMPLS:
        got = _port(img, dtype, merge_impl, impl, filtration=filtration,
                    truncate_value=torch.tensor(t, dtype=torch.float32))
        assert_same_diagram(want_t, got, f"truncated {merge_impl}/{impl}")


@pytest.mark.parametrize("merge_impl,impl", IMPLS)
def test_overflow_flag_and_partial_diagram_match_reference(merge_impl, impl):
    img = make_image("float32", "gauss", seed=5, shape=SHAPE)
    kw = dict(max_features=4, max_candidates=6, strip_rows=4)
    want = jpixhomology(jnp.asarray(img), merge_keys="rank",
                        merge_impl=merge_impl, phase_c_impl=impl, **kw)
    got = pixhomology(torch.from_numpy(img), merge_impl=merge_impl,
                      phase_c_impl=impl, **kw)
    assert bool(got.overflow)
    assert_same_diagram(want, got, f"overflow {merge_impl}/{impl}")


def test_batched_equals_per_image_runs():
    imgs = np.stack([make_image("float32", "gauss", seed=s, shape=SHAPE)
                     for s in range(3)])
    tvs = torch.tensor([-1e9, 5.0, 20.0])
    for merge_impl, impl in IMPLS:
        kw = dict(max_features=N, max_candidates=N, merge_impl=merge_impl,
                  phase_c_impl=impl, strip_rows=4)
        bd = batched_pixhomology(torch.from_numpy(imgs), tvs, **kw)
        assert bd.birth.shape == (3, N)
        for i in range(3):
            one = pixhomology(torch.from_numpy(imgs[i]), tvs[i], **kw)
            for a, b in zip(bd, one):
                assert torch.equal(a[i], b)


def test_num_candidates_and_unported_modes():
    from repro.core import num_candidates as jnum
    img = make_image("float32", "gauss", seed=6, shape=SHAPE)
    assert num_candidates(torch.from_numpy(img)) == int(
        jnum(jnp.asarray(img)))
    assert num_candidates(torch.from_numpy(img), truncate_value=10.0) == int(
        jnum(jnp.asarray(img), truncate_value=10.0))
    x = torch.from_numpy(img)
    for kw in (dict(phase_a_impl="pooled"), dict(candidate_mode="paper")):
        assert_same_diagram(_reference(img, "float32", **kw),
                            _port(img, "float32", "boruvka", "fused", **kw),
                            f"formerly unported {kw}")
    with pytest.raises(ValueError, match="non-finite"):
        pixhomology(torch.tensor([[1.0, float("nan")]]))


def test_diagram_numpy_round_trip():
    img = make_image("bfloat16", "gauss", seed=7, shape=SHAPE)
    want = _reference(img, "bfloat16", strip_rows=4)
    fields = [np.asarray(jnp.asarray(f).astype(jnp.float32))
              if f.dtype == jnp.bfloat16 else np.asarray(f) for f in want]
    d = diagram_from_numpy(fields, value_dtype=torch.bfloat16)
    assert isinstance(d, Diagram) and d.birth.dtype == torch.bfloat16
    assert_same_diagram(want, d, "from_numpy")
    back = diagram_to_numpy(d)
    for a, b in zip(fields, back):
        np.testing.assert_array_equal(a, b)
    assert tkernel.DTYPE_CODES   # every kernel dtype is a DTYPES member
    assert {str(k).split(".")[1] for k in tkernel.DTYPE_CODES} == set(DTYPES)


def test_subnormal_pixels_follow_ieee_order():
    """The reference's CPU backend flushes subnormals to zero when it
    compares (ROADMAP queue 3); the port compares them exactly, as the
    numpy oracle does."""
    img = np.array([[1e-45, 0, 3e-45], [0, 2e-45, 0], [1e-45, 0, 0]],
                   np.float32)
    for merge_impl, impl in IMPLS:
        got = pixhomology(torch.from_numpy(img), max_features=9,
                          max_candidates=9, merge_impl=merge_impl,
                          phase_c_impl=impl)
        np.testing.assert_array_equal(diagram_to_array(got),
                                      persistence_oracle(img))


@pytest.mark.parametrize("kind", ["gauss", "ties"])
def test_exact_candidates_from_keys_match_reference_and_mask(kind):
    """The key-based candidate test (the pooled path's) equals the
    reference's and the bitmask-based test on the same labels."""
    from repro.core import exact_candidates as jexact
    from repro_torch.core import (exact_candidates, exact_candidates_masked,
                                  pack_keys, phase_a, phase_b,
                                  total_order_rank)
    img = make_image("float32", kind, seed=8, shape=SHAPE)
    x = torch.from_numpy(img)
    pa = phase_a(x, strip_rows=4)
    labels = phase_b(pa, SHAPE, strip_rows=4).reshape(SHAPE)
    rank = total_order_rank(x.reshape(-1)).reshape(SHAPE)
    want = jexact(jnp.asarray(rank.numpy()), jnp.asarray(labels.numpy()))
    masked = exact_candidates_masked(pa.hi_mask.reshape(SHAPE), labels)
    for keys in (rank, pack_keys(x.reshape(-1)).reshape(SHAPE)):
        got = exact_candidates(keys, labels)
        np.testing.assert_array_equal(np.asarray(want), got.numpy())
        assert torch.equal(got, masked)
