"""Port parity: bucket padding (repro_torch.pipeline) and the mixed-shape,
deduplicating ``PHEngine.run_batch`` vs the reference engine.

The padding functions are held to ``repro.pipeline.padding`` on the same
inputs; mixed-shape batches to the JAX engine's ``run_batch`` (every
field, bitwise) and to single ``run`` calls on each image (count-trimmed
rows where the capacities differ, as the reference's own padding test
compares them).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_parity import assert_same, assert_same_diagram, host
from repro.core import Diagram as JDiagram
from repro.data import astro as jastro
from repro.pipeline import padding as jpad
from repro.pipeline.scheduler import bucket_shape as jbucket_shape
from repro.ph import PHConfig as JConfig
from repro.ph import PHEngine as JEngine
from repro_torch.core import Diagram
from repro_torch.data import astro
from repro_torch.ph import PHConfig, PHEngine
from repro_torch.pipeline import padding
from repro_torch.pipeline.scheduler import bucket_shape

SHAPES = [(32, 32), (32, 24), (24, 24), (16, 32), (15, 29)]


def _frames(dup=True):
    imgs = [astro.generate_window(i, 0, 0, h, w, size=32)
            for i, (h, w) in enumerate(SHAPES)]
    if dup:
        imgs.append(imgs[2].copy())
    return imgs


def _cfg(**kw):
    kw.setdefault("max_features", 64)
    kw.setdefault("max_candidates", 128)
    kw.setdefault("strip_rows", 4)
    return kw


def _image(seed, shape=(13, 11)):
    """The reference padding test's image: bumps on low noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]].astype(np.float32)
    img = rng.normal(0.0, 0.1, shape).astype(np.float32)
    for _ in range(5):
        cy, cx = rng.uniform(0, shape[0]), rng.uniform(0, shape[1])
        img += rng.uniform(0.5, 2.0) * np.exp(
            -((yy - cy) ** 2 + (xx - cx) ** 2) / 6.0).astype(np.float32)
    return img


def _trimmed_equal(row_of, one, what):
    """Row ``row_of`` of a batched diagram equals the single-run diagram
    ``one`` on its valid rows and scalar fields."""
    c = int(one.count)
    for name, a, b in zip(one._fields, row_of, one):
        a, b = host(a), host(b)
        if b.ndim:
            a, b = a[:c], b[:c]
        np.testing.assert_array_equal(a, b, err_msg=f"{what} {name}")


# ---------------------------------------------------------------------------
# Padding functions and buckets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["uint8", "int16", "int32", "float32"])
@pytest.mark.parametrize("filtration", ["superlevel", "sublevel"])
def test_padding_functions_match_reference(dtype, filtration):
    if filtration == "sublevel" and dtype != "float32":
        with pytest.raises(ValueError, match="floating"):
            padding.pad_fill_value(getattr(torch, dtype), filtration)
        return
    rng = np.random.default_rng(1)
    img = (rng.normal(size=(5, 7)) * 40 + 100).astype(dtype)
    img[4, 6] = img.min() - 1 if filtration == "superlevel" \
        else img.max() + 1                        # extremum on the margin
    x = torch.from_numpy(img)
    assert padding.pad_fill_value(x.dtype, filtration) == \
        jpad.pad_fill_value(img.dtype, filtration)
    for t in (None, 3.5, float("inf")):
        assert padding.pad_threshold(x, t, filtration) == \
            jpad.pad_threshold(img, t, filtration)
    want_fix = jpad.pad_fixup(img, filtration)
    got_fix = padding.pad_fixup(x, filtration)
    assert got_fix[:2] == want_fix[:2] and got_fix[3] == want_fix[3]
    assert got_fix[2].item() == want_fix[2]
    for bucket in ((5, 7), (8, 8), (6, 16)):
        assert_same(jpad.pad_image(img, bucket, filtration),
                    padding.pad_image(x, bucket, filtration),
                    f"pad_image {bucket}")
    with pytest.raises(ValueError, match="exceeds"):
        padding.pad_image(x, (4, 8), filtration)

    # unpad: the same padded-frame diagram fields through both copies.
    f, wb = 6, 16
    p = np.array([3, 17, 40, -1, 95, -1], np.int32)
    vals = np.arange(f).astype(img.dtype)
    fields = (vals, vals[::-1].copy(), p, p[::-1].copy(), np.int32(4),
              np.int32(0), np.bool_(False))
    want = jpad.unpad_diagram(JDiagram(*fields), want_fix, (8, wb))
    got = padding.unpad_diagram(
        Diagram(*(torch.as_tensor(np.array(a)) for a in fields)), got_fix,
        (8, wb))
    assert_same_diagram(want, got, "unpad_diagram")
    empty = fields[:4] + (np.int32(0),) + fields[5:]
    got = padding.unpad_diagram(
        Diagram(*(torch.as_tensor(np.array(a)) for a in empty)), got_fix,
        (8, wb))
    assert_same_diagram(jpad.unpad_diagram(JDiagram(*empty), want_fix,
                                           (8, wb)), got, "unpad count 0")


def test_pad_threshold_raises_like_reference_and_buckets():
    img = np.array([[0, 3], [2, 1]], np.uint8)      # min == uint8 fill
    with pytest.raises(ValueError, match="cannot pad"):
        jpad.pad_threshold(img, None)
    with pytest.raises(ValueError, match="cannot pad"):
        padding.pad_threshold(torch.from_numpy(img), None)
    for shape in ((1, 1), (3, 5), (16, 17), (1000, 1800), (2048, 1536)):
        for rounding in ("pow2", "exact"):
            assert bucket_shape(shape, rounding) == \
                jbucket_shape(shape, rounding)
    with pytest.raises(ValueError):
        bucket_shape((3, 3), "bogus")


# ---------------------------------------------------------------------------
# Mixed-shape run_batch
# ---------------------------------------------------------------------------

MIXED_CASES = [
    dict(filter_level="filter_std"),
    dict(),                                               # VANILLA
    dict(filtration="sublevel"),
    dict(phase_a_impl="pooled", merge_impl="boruvka", phase_c_impl="xla"),
    dict(candidate_mode="paper", merge_impl="boruvka"),
]


@pytest.mark.parametrize("kw", MIXED_CASES)
def test_mixed_run_batch_matches_reference_engine(kw):
    imgs = _frames()
    jres = JEngine(JConfig(**_cfg(**kw))).run_batch(imgs)
    eng = PHEngine(PHConfig(**_cfg(**kw)), device="cpu")
    tres = eng.run_batch(imgs)
    assert_same_diagram(jres.diagram, tres.diagram, f"mixed {kw}")
    np.testing.assert_array_equal(np.asarray(jres.threshold),
                                  np.asarray(tres.threshold))
    assert vars(tres.regrow) == vars(jres.regrow)
    # Twin rows fan out from one computation.
    for a in tres.diagram:
        assert torch.equal(a[2], a[5])
    if kw.get("candidate_mode") == "paper":
        return    # the paper rule is not pad-invariant (ROADMAP queue 3)
    for i, im in enumerate(imgs):
        _trimmed_equal([a[i] for a in tres.diagram], eng.run(im).diagram,
                       f"{kw} row {i}")


@pytest.mark.parametrize("filtration", ["superlevel", "sublevel"])
def test_padded_batch_extremum_on_border(filtration):
    img = _image(11)
    ext = np.argmin(img) if filtration == "superlevel" else np.argmax(img)
    r, c = np.unravel_index(ext, img.shape)
    img[-1, -1], img[r, c] = img[r, c], img[-1, -1]
    cfg = _cfg(filtration=filtration, max_features=256, max_candidates=256)
    eng = PHEngine(PHConfig(**cfg), device="cpu")
    padded = eng.run_batch([img], bucket=(16, 16))
    _trimmed_equal([a[0] for a in padded.diagram], eng.run(img).diagram,
                   f"border {filtration}")
    jpadded = JEngine(JConfig(**cfg)).run_batch([img], bucket=(16, 16))
    assert_same_diagram(jpadded.diagram, padded.diagram, f"vs ref {filtration}")


def test_bf16_mixed_batch_matches_reference_runs():
    """The reference cannot pad bfloat16 (numpy has no ``iinfo`` for it,
    ROADMAP queue 3); the port's padded rows equal the reference's
    single runs.  Explicit thresholds: the two packages take the
    filter-level statistic of a bfloat16 image in different precisions
    (ROADMAP queue 3)."""
    imgs = [np.asarray(jnp.asarray(im, jnp.bfloat16)) for im in _frames()]
    tvs = [100.0, 105.5, None, 98.25, 110.0, None]
    tres = PHEngine(PHConfig(**_cfg()), device="cpu").run_batch(imgs, tvs)
    assert tres.diagram.birth.dtype == torch.bfloat16
    mf = tres.regrow.final_max_features
    mc = tres.regrow.final_max_candidates
    jeng = JEngine(JConfig(**_cfg(max_features=mf, max_candidates=mc)))
    for i, im in enumerate(imgs):
        _trimmed_equal([a[i] for a in tres.diagram],
                       jeng.run(im, truncate_value=tvs[i]).diagram,
                       f"bf16 row {i}")


def test_dedupe_fans_out_and_forced_bucket():
    imgs = _frames()
    eng = PHEngine(PHConfig(**_cfg(filter_level="filter_std")), device="cpu")
    calls = eng.plan_stats()["calls"]
    res = eng.run_batch(imgs)
    one_dispatch = eng.plan_stats()["calls"] - calls
    plain = eng.run_batch(imgs, dedupe=False)
    assert_same_diagram(plain.diagram, res.diagram, "dedupe vs none")
    np.testing.assert_array_equal(plain.threshold, res.threshold)
    assert one_dispatch == 1 and res.diagram.birth.shape[0] == 6

    # A uniform (B, H, W) batch with repeated frames and explicit
    # thresholds: rows differing only in threshold stay apart.
    frame = astro.generate_image(3, 16)
    stack = np.stack([frame, frame, frame])
    tvs = [5.0, 5.0, 9.0]
    assert eng._dedupe_batch(stack, tvs)[0] == [0, 2]
    got = eng.run_batch(stack, tvs)
    want = eng.run_batch(stack, tvs, dedupe=False)
    assert_same_diagram(want.diagram, got.diagram, "uniform dedupe")
    assert eng._dedupe_batch(stack[:1], None) is None

    # bucket= forces a uniform batch into a padded dispatch.
    forced = eng.run_batch(stack[:2], bucket=(32, 32), dedupe=False)
    jforced = JEngine(JConfig(**_cfg(filter_level="filter_std"))).run_batch(
        stack[:2], bucket=(32, 32), dedupe=False)
    assert_same_diagram(jforced.diagram, forced.diagram, "forced bucket")


def test_mixed_batch_errors():
    eng = PHEngine(PHConfig(**_cfg()), device="cpu")
    a = np.zeros((3, 4), np.float32) + np.arange(4, dtype=np.float32)
    b = np.ones((5, 2), np.int32)
    with pytest.raises(ValueError, match="mixed dtypes"):
        eng.run_batch([a, b])
    with pytest.raises(ValueError, match="thresholds for"):
        eng.run_batch([a, a[:2]], [1.0, 2.0, 3.0])
    with pytest.raises(ValueError, match="2D"):
        eng.run_batch([a, np.zeros(3, np.float32)])
    with pytest.raises(ValueError, match="at least one"):
        eng.run_batch([])
    assert jax  # both engines share the inputs above
