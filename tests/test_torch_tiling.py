"""Port parity: the halo-tiled path (repro_torch.core.tiling, run_tiled).

The port's tiled diagrams are held bitwise, field by field, to the
reference's tiled diagrams (``repro.core.tiling``; its packed keys resolve
to ranks without 64-bit mode, so both of the port's encodings are held to
the reference's rank output), to the port's whole-image ``run`` (exact
candidates) and to the union-find oracle.  Inputs are made from a seed
with numpy.  The reference's module-level ``tiled_pixhomology`` caches
its compiled programs by shape, so every case of one shape, dtype and
grid compiles once.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from _torch_parity import (DTYPES, assert_same, assert_same_diagram,
                           make_image, to_jax, to_torch)
from repro.core import tiling as jtiling
from repro.data import astro as jastro
from repro.ph import PHConfig as JConfig
from repro.ph import PHEngine as JEngine
from repro_torch.core import diagram_to_array, persistence_oracle, tiling
from repro_torch.data import astro as tastro
from repro_torch.ph import FilterLevel, PHConfig, PHEngine, TileSpec

SHAPE = (12, 12)
# Every grid kind on float32 (one tile, square tiles, oblong tiles, 1-px
# tiles); the other dtypes on oblong and 1-px tiles (each grid costs the
# reference a compile).
GRIDS = {"float32": [(1, 1), (2, 2), (2, 3), SHAPE]}
GRIDS_OTHER = [(2, 3), SHAPE]


def _engine(**kw):
    return PHEngine(PHConfig(**kw), device="cpu")


def _full_caps(n, grid=None, **kw):
    return dict(max_features=n, tile=dict(
        grid=grid, max_features_per_tile=n, max_candidates_per_tile=n), **kw)


def _reference(img, dtype, grid, tv=None, filtration="superlevel", n=None,
               tf=None, tk=None):
    """The reference's tiled diagram (rank keys, its packed resolution)."""
    n = img.size if n is None else n
    tvj = None
    if tv is not None:
        tdt = jnp.float32 if dtype != "bfloat16" else jnp.bfloat16
        tvj = jnp.asarray(tv, tdt)
    return jtiling.tiled_pixhomology(
        to_jax(img, dtype), tvj, grid=tuple(grid), max_features=n,
        tile_max_features=n if tf is None else tf,
        tile_max_candidates=n if tk is None else tk, merge_keys="rank",
        filtration=filtration)


def _check_all(img, dtype, grid, tv=None, filtration="superlevel",
               what=""):
    """Reference tiled == port tiled (both encodings, host array and
    stacks) == port whole-image run == oracle (unthresholded)."""
    n = img.size
    want = _reference(img, dtype, grid, tv, filtration).diagram
    x = to_torch(img, dtype)
    for keys in ("packed", "rank"):
        cfg = _full_caps(n, grid, merge_keys=keys, filtration=filtration,
                         merge_impl="boruvka", max_candidates=n)
        eng = _engine(**cfg)
        got = eng.run_tiled(x, tv)
        label = f"{what} {dtype} grid={grid} {keys}"
        assert not got.regrow.overflow, label
        assert_same_diagram(want, got.diagram, label)
        assert_same_diagram(got.diagram, eng.run(x, tv).diagram,
                            f"{label} vs run")
    if tv is None and filtration == "superlevel":
        np.testing.assert_array_equal(diagram_to_array(got.diagram),
                                      persistence_oracle(img), err_msg=label)


# ---------------------------------------------------------------------------
# Bit-identity: reference, whole-image run, oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_tiled_matches_reference_run_and_oracle(dtype):
    img = make_image(dtype, "gauss", seed=1, shape=SHAPE)
    for grid in GRIDS.get(dtype, GRIDS_OTHER):
        _check_all(img, dtype, grid)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["ties", "negative"])
def test_tiled_ties_and_plateaus(dtype, kind):
    """Heavy value ties: the per-tile key must reproduce the global
    (value, index) order exactly; a constant image is decided by the
    index tie-break alone."""
    if dtype == "uint8" and kind == "negative":
        kind = "gauss"
    img = make_image(dtype, kind, seed=2, shape=SHAPE)
    _check_all(img, dtype, (2, 3), what=kind)
    _check_all(np.zeros(SHAPE, img.dtype), dtype, (2, 3), what="constant")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiled_sublevel_matches_reference(dtype):
    img = make_image(dtype, "gauss", seed=4, shape=SHAPE)
    _check_all(img, dtype, (2, 3), filtration="sublevel")
    _check_all(img, dtype, (2, 3), tv=0.25, filtration="sublevel")


@pytest.mark.parametrize("dtype,tv", [("float32", -0.5), ("float32", 0.3),
                                      ("int16", 12.5), ("bfloat16", 10.0)])
def test_tiled_truncation_matches_reference(dtype, tv):
    img = make_image(dtype, "gauss", seed=5, shape=SHAPE)
    _check_all(img, dtype, (2, 3), tv=tv)


def _ramp():
    return np.arange(16 * 16, dtype=np.float32).reshape(16, 16)


def _ridge():
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:16, 0:16].astype(np.float32)
    return (-((yy - 8) ** 2) * 0.1 + xx * 0.01 + rng.normal(
        scale=1e-3, size=(16, 16))).astype(np.float32)


def _two_blobs():
    yy, xx = np.mgrid[0:8, 0:16].astype(np.float32)
    img = (2.0 * np.exp(-((yy - 4) ** 2 + (xx - 3) ** 2) / 6.0)
           + 1.5 * np.exp(-((yy - 4) ** 2 + (xx - 12) ** 2) / 6.0))
    return (img + np.random.default_rng(1).normal(
        scale=1e-4, size=img.shape)).astype(np.float32)


SPANNING = [
    ("ramp_one_basin", _ramp, (4, 4)),          # every chain exits by seams
    ("ridge_across_rows", _ridge, (4, 4)),
    ("saddle_on_seam", _two_blobs, (1, 2)),     # seam column between blobs
    ("saddle_on_seam_2x2", _two_blobs, (2, 2)),
    ("single_pixel", lambda: np.array([[3.5]], np.float32), (1, 1)),
    ("row_of_tiles", lambda: np.random.default_rng(6).normal(
        size=(1, 8)).astype(np.float32), (1, 4)),
]


@pytest.mark.parametrize("name,make,grid", SPANNING,
                         ids=[c[0] for c in SPANNING])
def test_basins_spanning_tiles(name, make, grid):
    """Basins and merge saddles that span several tiles (or sit on a
    seam), and degenerate tiles."""
    _check_all(make(), "float32", grid, what=name)


# ---------------------------------------------------------------------------
# Entry points, overflow flags, tile extraction
# ---------------------------------------------------------------------------

def test_overflow_flags_and_partial_diagram_match_reference():
    """Undersized capacities at both levels: the two flags, the per-tile
    counts and the partial diagram equal the reference's."""
    img = make_image("float32", "gauss", seed=7, shape=(16, 16))
    for mf, tf, tk in ((4, 64, 64), (256, 2, 2), (3, 2, 64)):
        want = _reference(img, "float32", (4, 4), n=mf, tf=tf, tk=tk)
        got = tiling.tiled_pixhomology(
            torch.from_numpy(img), grid=(4, 4), max_features=mf,
            tile_max_features=tf, tile_max_candidates=tk)
        label = f"caps {(mf, tf, tk)}"
        assert_same_diagram(want.diagram, got.diagram, label)
        for name in ("tile_overflow", "merge_overflow", "n_tile_roots",
                     "n_tile_cands"):
            assert_same(getattr(want, name), getattr(got, name),
                        f"{label} {name}")


def test_stacks_entry_and_halo_gidx():
    """``tiled_pixhomology_stacks`` on split stacks equals the host-image
    entry; the arithmetic gidx maps equal split index images and the
    reference's; split value tiles equal the reference's."""
    h, w, grid = 24, 36, (2, 3)
    img = make_image("float32", "gauss", seed=8, shape=(h, w))
    x = torch.from_numpy(img)
    gidx2d = torch.arange(h * w, dtype=torch.int32).reshape(h, w)
    split = tiling.split_tiles(gidx2d, grid, -1)
    jsplit = np.asarray(jtiling.split_tiles(
        jnp.asarray(img), grid, float("-inf")))
    assert_same(jsplit, tiling.split_tiles(x, grid, float("-inf")))
    stack = tiling.halo_gidx_stack((h, w), grid, range(6), "cpu")
    assert_same(split, stack, "gidx stack")
    for t in range(6):
        np.testing.assert_array_equal(tiling.halo_gidx_tile((h, w), grid, t),
                                      split[t].numpy(), err_msg=f"tile {t}")
        np.testing.assert_array_equal(
            tiling.halo_gidx_tile((h, w), grid, t),
            jtiling.halo_gidx_tile((h, w), grid, t))
    kw = dict(grid=grid, max_features=h * w, tile_max_features=h * w,
              tile_max_candidates=h * w)
    whole = tiling.tiled_pixhomology(x, **kw)
    stacks = tiling.tiled_pixhomology_stacks(
        tiling.split_tiles(x, grid, float("-inf")), split, shape=(h, w),
        **kw)
    assert_same_diagram(whole.diagram, stacks.diagram, "stacks")
    with pytest.raises(ValueError):
        tiling.tiled_pixhomology_stacks(split[:5].float(), split[:5],
                                        shape=(h, w), **kw)


def test_choose_and_validate_grid_match_reference():
    for shape in ((96, 64), (64, 64), (10240, 10240), (12, 18), (7, 13),
                  (1, 8)):
        for budget in (0, 1, 16, 100, 1024, 1 << 20):
            assert tiling.choose_grid(shape, budget) == \
                jtiling.choose_grid(shape, budget), (shape, budget)
    assert tiling.choose_grid((10240, 10240), 1 << 20) == (10, 10)
    for bad in ((5, 2), (0, 2), (2, 0)):
        with pytest.raises(ValueError):
            tiling.validate_grid((12, 12), bad)
    tiling.validate_grid((12, 12), (3, 4))


# ---------------------------------------------------------------------------
# Tile providers (data/astro.py) and staged tiles
# ---------------------------------------------------------------------------

def test_astro_provider_and_cost_helpers_match_reference():
    """``AstroImage.halo_tile`` equals slices of ``generate_image`` (with
    the fill outside the frame) and the reference's tiles; the cost
    helpers and the frame sequence equal the reference's."""
    size, grid = 40, (2, 4)
    img = tastro.generate_image(2, size)
    padded = np.pad(img, 1, constant_values=-np.inf)
    prov, jprov = tastro.AstroImage(2, size), jastro.AstroImage(2, size)
    tr, tc = size // grid[0], size // grid[1]
    for t in range(grid[0] * grid[1]):
        r0, c0 = (t // grid[1]) * tr, (t % grid[1]) * tc
        tile = prov.halo_tile(t, grid)
        np.testing.assert_array_equal(
            tile, padded[r0:r0 + tr + 2, c0:c0 + tc + 2], err_msg=str(t))
        np.testing.assert_array_equal(tile, jprov.halo_tile(t, grid))
        np.testing.assert_array_equal(prov.halo_tile(t, grid, fill=np.inf),
                                      jprov.halo_tile(t, grid, fill=np.inf))
    for level in ("filter_std", "filter_light"):
        assert prov.filter_threshold(level, sample=16) == \
            jprov.filter_threshold(level, sample=16)
        assert tastro.estimate_cost(img, level) == \
            jastro.estimate_cost(img, level)
    assert prov.filter_threshold("vanilla") is None
    assert tastro.estimate_cost_from_id(3, 256) == \
        jastro.estimate_cost_from_id(3, 256)
    fs = tastro.FrameSequence(4, 48, grid=(4, 4), dirty_frac=0.2, stamp=3)
    jfs = jastro.FrameSequence(4, 48, grid=(4, 4), dirty_frac=0.2, stamp=3)
    for i in range(3):
        np.testing.assert_array_equal(fs.frame(i), jfs.frame(i))
        np.testing.assert_array_equal(fs.dirty_tiles(i), jfs.dirty_tiles(i))


class _NoThreshold:
    """A provider without ``filter_threshold``."""

    def __init__(self, prov):
        self.prov = prov
        self.shape = prov.shape
        self.dtype = np.float32

    def halo_tile(self, t, grid, fill=-np.inf):
        return self.prov.halo_tile(t, grid, fill=fill)


def test_run_tiled_provider_and_staged_tiles_match_reference():
    """Provider (windowed loading, threshold from the provider) and staged
    stacks equal the host-array path and the reference's provider run."""
    cfg = dict(max_features=4096, filter_level="filter_std",
               tile=dict(grid=(2, 2), max_features_per_tile=1024,
                         max_candidates_per_tile=2048))
    eng = _engine(**cfg)
    prov = tastro.AstroImage(9, 48)
    res = eng.run_tiled(prov)
    want = JEngine(JConfig(**cfg)).run_tiled(jastro.AstroImage(9, 48))
    assert res.threshold == want.threshold == prov.filter_threshold(
        "filter_std", sample=1024)
    assert_same_diagram(want.diagram, res.diagram, "provider")
    img = tastro.generate_image(9, 48)
    assert_same_diagram(res.diagram, eng.run_tiled(img, res.threshold)
                        .diagram, "host array")
    staged = eng.stage_tiles(prov)
    assert staged.shape == (48, 48) and staged.grid == (2, 2)
    assert staged.pvals.device.type == "cpu"
    assert_same_diagram(res.diagram, eng.run_tiled(staged, res.threshold)
                        .diagram, "staged")
    # a staged run needs its threshold; a provider without one raises
    assert eng.run_tiled(staged).threshold is None
    with pytest.raises(ValueError):
        eng.run_tiled(_NoThreshold(prov))
    with pytest.raises(ValueError):
        eng.run_tiled(staged, res.threshold, grid=(4, 4))
    with pytest.raises(ValueError):
        _engine(filter_level="filter_std", filtration="sublevel") \
            .provider_threshold(prov)


def test_staged_tiles_follow_config_dtype_and_sublevel_fill():
    """The config dtype policy applies to staged tiles as to host images;
    sublevel stages the +inf halo fill and equals the host path."""
    prov = tastro.AstroImage(5, 32)
    img = tastro.generate_image(5, 32)
    for cfg in (dict(dtype="int32"), dict(dtype="bfloat16"),
                dict(filtration="sublevel")):
        eng = _engine(**_full_caps(1024, (2, 2), **cfg))
        staged = eng.stage_tiles(prov)
        if cfg.get("filtration") == "sublevel":
            assert torch.isinf(staged.pvals[0, 0, 0]) \
                and staged.pvals[0, 0, 0] > 0
        got = eng.run_tiled(staged)
        assert_same_diagram(eng.run_tiled(img).diagram, got.diagram,
                            str(cfg))
        assert_same_diagram(eng.run(img).diagram, got.diagram, str(cfg))


def test_load_tile_stacks_preallocates_on_the_device():
    prov = tastro.AstroImage(1, 24)
    staged = tiling.load_tile_stacks(prov, (2, 3), device="cpu")
    jstaged = jtiling.load_tile_stacks(jastro.AstroImage(1, 24), (2, 3))
    assert_same(jstaged.pvals, staged.pvals, "pvals")
    assert_same(jstaged.pgidx, staged.pgidx, "pgidx")
    with pytest.raises(ValueError):
        tiling.load_tile_stacks(prov, (5, 3), device="cpu")


# ---------------------------------------------------------------------------
# Engine: per-level regrow, memo, plan cache, limits
# ---------------------------------------------------------------------------

REGROW_CASES = [
    ("tile_level", dict(max_features=64, tile=dict(
        grid=(2, 2), max_features_per_tile=1, max_candidates_per_tile=1))),
    ("seam_level", dict(max_features=2, tile=dict(
        grid=(2, 2), max_features_per_tile=16,
        max_candidates_per_tile=16))),
]


@pytest.mark.parametrize("name,cfg", REGROW_CASES,
                         ids=[c[0] for c in REGROW_CASES])
def test_run_tiled_regrow_matches_reference(name, cfg):
    """Per-level regrow: attempts, the final capacities of both levels,
    the regrow log and the diagram equal the reference engine's, and the
    regrown result equals the oracle."""
    img = np.random.default_rng(len(name)).normal(size=(8, 8)).astype(
        np.float32)
    jeng, eng = JEngine(JConfig(**cfg)), _engine(**cfg)
    want, got = jeng.run_tiled(img), eng.run_tiled(img)
    assert vars(got.regrow) == vars(want.regrow), name
    assert got.regrow.attempts >= 1 and not got.regrow.overflow
    assert got.config.max_features == want.config.max_features
    assert got.config.tile == TileSpec(**vars(want.config.tile))
    assert [(r["from"], r["to"]) for r in eng.regrow_log] == \
        [(tuple(r["from"]), tuple(r["to"])) for r in jeng.regrow_log]
    assert_same_diagram(want.diagram, got.diagram, name)
    np.testing.assert_array_equal(got.to_array(), persistence_oracle(img))
    if name == "seam_level":      # only the merge level grew
        assert got.config.tile.max_features_per_tile == 16


def test_run_tiled_regrow_limits():
    """``max_regrows``, the ceilings of both levels and ``auto_regrow``
    off: the residual overflow is reported, never hidden."""
    img = np.random.default_rng(9).normal(size=(16, 16)).astype(np.float32)
    tight = dict(grid=(4, 4), max_features_per_tile=1,
                 max_candidates_per_tile=1)
    res = _engine(max_features=512, max_regrows=1,
                  tile=tight).run_tiled(img)
    assert res.regrow.attempts == 1 and res.regrow.overflow
    assert bool(res.diagram.overflow)
    res = _engine(max_features=2, max_candidates=8,
                  regrow_features_ceiling=4, regrow_candidates_ceiling=8,
                  tile=dict(tight, grid=(2, 2))).run_tiled(img)
    assert res.config.max_features <= 4
    assert res.config.tile.max_features_per_tile <= 4
    assert res.config.tile.max_candidates_per_tile <= 8
    assert res.regrow.overflow          # capped below need, reported
    eng = _engine(max_features=4, auto_regrow=False, tile=tight)
    res = eng.run_tiled(img)
    assert res.regrow.attempts == 0 and res.regrow.overflow
    assert not eng.regrow_log


def test_run_tiled_regrow_is_sticky_and_plans_are_cached():
    img = np.random.default_rng(8).normal(size=(12, 12)).astype(np.float32)
    eng = _engine(max_features=4, tile=TileSpec(
        grid=(3, 3), max_features_per_tile=2, max_candidates_per_tile=2))
    r1 = eng.run_tiled(img)
    assert r1.regrow.attempts >= 1
    assert all(r["kind"] == "tiled" for r in eng.regrow_log)
    r2 = eng.run_tiled(img)
    assert r2.regrow.attempts == 0 and r2.config == r1.config
    assert eng.plan_stats()["hits"] >= 1
    assert_same_diagram(r1.diagram, r2.diagram, "sticky")
    small = _engine(max_features=256, tile=TileSpec(
        grid=(3, 3), max_features_per_tile=16, max_candidates_per_tile=32))
    small.run_tiled(img)
    small.run_tiled(img.copy())
    assert small.plan_stats()["traces"] == 1
    assert small.plan_stats()["calls"] == 2


def test_run_tiled_grid_choice_routing_and_paper_mode():
    eng = _engine(tile=TileSpec(max_tile_pixels=32 * 32))
    assert eng.should_tile(64 * 64) and not eng.should_tile(32 * 32)
    assert not _engine().should_tile(1 << 30)
    img = make_image("float32", "gauss", seed=9, shape=(64, 48))
    res = eng.run_tiled(img)
    assert res.config.tile.grid == tiling.choose_grid((64, 48), 32 * 32)
    assert_same_diagram(_engine(max_features=res.config.max_features)
                        .run(img).diagram, res.diagram, "auto grid")
    with pytest.raises(ValueError):
        _engine(candidate_mode="paper").run_tiled(np.zeros((4, 4),
                                                           np.float32))
    with pytest.raises(ValueError):
        eng.run_tiled(np.zeros((4, 4, 2), np.float32))
    with pytest.raises(ValueError):
        eng.run_tiled(np.zeros((6, 6), np.float32), grid=(4, 4))


def test_run_tiled_filter_level_threshold_matches_run():
    """Without an explicit threshold the host image's filter-level
    statistic applies, as in ``run``."""
    img = tastro.generate_image(3, 48)
    cfg = _full_caps(48 * 48, (3, 2), filter_level=FilterLevel.STD)
    eng = _engine(**cfg)
    res = eng.run_tiled(img)
    assert res.threshold == eng.run(img).threshold
    assert_same_diagram(eng.run(img).diagram, res.diagram, "filter_std")
    want = JEngine(JConfig(**cfg)).run_tiled(img)
    assert res.threshold == want.threshold
    assert_same_diagram(want.diagram, res.diagram, "filter_std reference")


def test_seam_round_uses_the_best_edge_dispatch(monkeypatch):
    """``phase_c_impl="fused"`` sends every Boruvka round of the seam
    merge through the phase-C dispatch (the kernel on the card, its plain
    version here); ``"xla"`` never does; both give the same bits."""
    from repro_torch.kernels.ph_phase_c import ops
    calls = []
    real = ops.best_edge_reduce

    def spy(key, ra, rb, nv, **kw):
        calls.append((key.shape[0], nv))
        return real(key, ra, rb, nv, **kw)

    monkeypatch.setattr(ops, "best_edge_reduce", spy)
    img = make_image("float32", "gauss", seed=10, shape=(16, 16))
    fused = _engine(**_full_caps(256, (2, 2), phase_c_impl="fused"))
    xla = _engine(**_full_caps(256, (2, 2), phase_c_impl="xla"))
    a = fused.run_tiled(img)
    assert calls, "the seam merge never reached the best-edge dispatch"
    n_fused = len(calls)
    b = xla.run_tiled(img)
    assert len(calls) == n_fused
    assert_same_diagram(a.diagram, b.diagram, "fused vs xla")
