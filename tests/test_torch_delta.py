"""Port parity: delta-PH (repro_torch.core.delta, run_delta) and its frame
store (repro_torch.cache).

The load-bearing property: ``run_delta`` is **bitwise equal** to a cold
``run_tiled`` of the same frame for every dirty mask (none, one tile, all,
a transient straddling a seam, a seam-elder flip, random masks), and a
frame sequence classifies and computes as the reference's ``run_delta``
does.  Plus: the halo dirtying neighbours, the hash algorithms, verify
mode against injected collisions, the LRU stores, and regrow inside a
delta run.  Inputs are made from a seed with numpy.
"""
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

import jax.numpy as jnp

from _torch_parity import assert_same_diagram
from repro.cache import DiagramCache as JDiagramCache
from repro.core import tiling as jtiling
from repro.ph import DeltaSpec as JDeltaSpec
from repro.ph import PHConfig as JConfig
from repro.ph import PHEngine as JEngine
from repro_torch.cache import (CacheStats, DiagramCache, FrameCacheEntry,
                               LRUCache)
from repro_torch.core import delta as dm
from repro_torch.core import tiling
from repro_torch.data.astro import AstroImage, FrameSequence
from repro_torch.ph import DeltaSpec, FilterLevel, PHConfig, PHEngine, \
    TileSpec

GRID = (4, 4)
SIZE = 48          # 12x12 tiles, 16 tiles to classify


def _img(seed=0):
    return np.random.default_rng(seed).normal(
        size=(SIZE, SIZE)).astype(np.float32)


def _engine(**kw):
    kw.setdefault("delta", DeltaSpec(cache_entries=64))
    kw.setdefault("tile", TileSpec(grid=GRID, max_features_per_tile=64,
                                   max_candidates_per_tile=64))
    return PHEngine(PHConfig(**kw), device="cpu")


@pytest.fixture(scope="module")
def engine():
    """Shared engine: one plan cache across the bit-identity matrix."""
    return _engine()


def _same(a, b, msg=""):
    assert_same_diagram(a.diagram, b.diagram, msg)


def _same_as_reference(frame, got, msg=""):
    """``got`` (a PHResult) equals the reference's tiled diagram of
    ``frame`` at the capacities ``got`` ran at."""
    tile = got.config.tile
    want = jtiling.tiled_pixhomology(
        jnp.asarray(frame), grid=tile.grid,
        max_features=got.config.max_features,
        tile_max_features=tile.max_features_per_tile,
        tile_max_candidates=tile.max_candidates_per_tile, merge_keys="rank")
    assert_same_diagram(want.diagram, got.diagram, f"{msg} vs reference")


def _perturb(img, tiles, bump=5.0):
    """+bump at the centre of each listed tile — strictly interior, so
    exactly those tiles' halo windows change."""
    out = img.copy()
    tr, tc = SIZE // GRID[0], SIZE // GRID[1]
    for t in tiles:
        r0, c0 = (t // GRID[1]) * tr, (t % GRID[1]) * tc
        out[r0 + tr // 2, c0 + tc // 2] += bump
    return out


class _Provider:
    """A tile provider over a host frame."""

    def __init__(self, img):
        self.img, self.shape, self.dtype = img, img.shape, np.float32

    def halo_tile(self, t, grid, fill=-np.inf):
        img = self.img
        gr, gc = grid
        tr, tc = img.shape[0] // gr, img.shape[1] // gc
        out = np.full((tr + 2, tc + 2), fill, np.float32)
        r0, c0 = (t // gc) * tr, (t % gc) * tc
        y0, y1 = max(0, r0 - 1), min(img.shape[0], r0 + tr + 1)
        x0, x1 = max(0, c0 - 1), min(img.shape[1], c0 + tc + 1)
        out[y0 - (r0 - 1):y1 - (r0 - 1),
            x0 - (c0 - 1):x1 - (c0 - 1)] = img[y0:y1, x0:x1]
        return out


# ---------------------------------------------------------------------------
# Cache stores (the port's copy against the reference's behaviour)
# ---------------------------------------------------------------------------

def test_lru_cache_eviction_counters_and_capacity():
    c = LRUCache(2)
    c.put("a", 1)
    c.put("b", 2)
    assert c.get("a") == 1            # refresh a: b is now the stalest
    c.put("c", 3)
    assert c.get("b") is None and c.get("c") == 3 and len(c) == 2
    assert c.stats.snapshot() == dict(hits=2, partial_hits=0, misses=1,
                                      inserts=3, evictions=1, collisions=0)
    with pytest.raises(ValueError):
        LRUCache(0)
    with pytest.raises(ValueError):
        DiagramCache(0)


def _entry(digests, caps=(8, 4, 4), raw=None, tag=None):
    return FrameCacheEntry(digests=digests, state=tag, result=tag,
                           capacities=caps, tile_bytes=raw)


@pytest.mark.parametrize("store", ["port", "reference"])
def test_diagram_cache_classification_matches_reference(store):
    """Hit, best partial (fewest dirty tiles, equal capacities only),
    miss, LRU eviction and in-place replacement; both stores agree."""
    if store == "port":
        cache, entry = DiagramCache(2), _entry
    else:
        from repro.cache import FrameCacheEntry as JEntry
        cache = JDiagramCache(2)

        def entry(digests, caps=(8, 4, 4), raw=None, tag=None):
            return JEntry(digests=digests, state=tag, result=tag,
                          capacities=caps, tile_bytes=raw)
    ctx = ("ctx",)
    a, b = (b"1", b"2", b"3", b"4"), (b"1", b"x", b"3", b"4")
    cache.put(ctx, entry(a, tag="A"))
    cache.put(ctx, entry(tuple(b"1 y 3 z".split()), tag="far"))
    kind, got, _ = cache.lookup(ctx, a, capacities=(8, 4, 4))
    assert (kind, got.state) == ("hit", "A")
    kind, got, dirty = cache.lookup(ctx, b, capacities=(8, 4, 4))
    assert (kind, got.state) == ("partial", "A")
    np.testing.assert_array_equal(dirty, [False, True, False, False])
    assert cache.lookup(ctx, b, capacities=(16, 4, 4))[0] == "miss"
    assert cache.lookup(("other",), a)[0] == "miss"
    cache.put(ctx, entry(a, tag="A2"))             # replaces in place
    assert len(cache) == 2
    cache.put(ctx, entry(b, tag="B"))              # evicts the stalest
    assert cache.stats.evictions == 1 and len(cache) == 2
    assert cache.lookup(ctx, a)[1].state == "A2"
    # verify mode: hash-equal but byte-different tiles become dirty
    cache.put(ctx, entry(a, raw=(b"p", b"q", b"r", b"s"), tag="V"))
    kind, got, dirty = cache.lookup(ctx, a, capacities=(8, 4, 4),
                                    tile_bytes=(b"p", b"Q", b"r", b"s"))
    assert kind == "partial" and dirty.tolist() == [False, True, False,
                                                    False]
    assert cache.stats.collisions == 1
    snap = cache.stats.snapshot()
    assert CacheStats(**snap).snapshot() == snap


def test_dirty_bucket_and_delta_stats():
    assert [dm.dirty_bucket(d, 16) for d in (1, 2, 3, 9, 16)] == \
        [1, 2, 4, 16, 16]
    assert dm.dirty_bucket(5, 6) == 6
    with pytest.raises(ValueError):
        dm.dirty_bucket(0, 16)
    assert dm.DeltaStats(16, 2, "partial").dirty_frac == 2 / 16
    assert dm.DeltaStats(0, 0, "full").dirty_frac == 0.0


# ---------------------------------------------------------------------------
# Hashing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("filtration", ["superlevel", "sublevel"])
def test_frame_digests_host_and_staged_agree(filtration):
    img = _img(7)
    fill = np.inf if filtration == "sublevel" else -np.inf
    staged = tiling.load_tile_stacks(_Provider(img), GRID, fill=fill,
                                     device="cpu")
    host, _ = dm.frame_digests(img, GRID, filtration=filtration)
    tensor, _ = dm.frame_digests(torch.from_numpy(img), GRID,
                                 filtration=filtration)
    got, raw = dm.frame_digests(staged, GRID, with_bytes=True)
    assert host == tensor == got and len(raw) == 16
    assert raw[0] == staged.pvals[0].numpy().tobytes()
    bf = torch.from_numpy(img).to(torch.bfloat16)
    d_bf, _ = dm.frame_digests(bf, GRID)
    assert d_bf != host and len(set(d_bf)) == 16


def test_halo_hashing_dirties_neighbours_of_border_changes():
    """A change on a tile border enters the neighbours' halo windows, so
    they hash dirty too."""
    img = _img(8)
    tr = SIZE // GRID[0]
    img2 = img.copy()
    img2[tr, tr] += 1.0       # top-left corner pixel of tile (1, 1)
    a, _ = dm.frame_digests(img, GRID)
    b, _ = dm.frame_digests(img2, GRID)
    assert sorted(np.flatnonzero([x != y for x, y in zip(a, b)])) == \
        [0, 1, 4, 5]


def test_hash_algos_all_work_and_unknown_raises():
    img = _img(9)
    seen = set()
    for algo in dm.HASH_ALGOS:
        d, _ = dm.frame_digests(img, GRID, algo=algo)
        assert len(d) == 16 and len(set(d)) == 16
        seen.add(len(d[0]))
    assert seen == {16, 20}           # blake2b-128 and md5; sha1
    with pytest.raises(ValueError):
        dm.hasher("crc32")
    with pytest.raises(ValueError):
        dm.frame_digests(np.zeros((4, 4, 2), np.float32), GRID)


# ---------------------------------------------------------------------------
# Bit-identity matrix: run_delta == cold run_tiled
# ---------------------------------------------------------------------------

def _seam_straddle(img):
    """One transient crossing the tile-row seam at SIZE // GRID[0]."""
    out = img.copy()
    s = SIZE // GRID[0]
    out[s - 2:s + 2, 30:34] += 5.0
    return out


def _seam_elder_flip(img):
    """Flip which side of a seam holds the elder maximum by changing one
    tile's interior only."""
    out = img.copy()
    tr, tc = SIZE // GRID[0], SIZE // GRID[1]
    out[tr // 2, tc // 2] = float(np.abs(img).max()) + 10.0
    return out


DIRTY_CASES = [
    ("none", lambda im: im.copy()),
    ("single_tile", lambda im: _perturb(im, [5])),
    ("all_tiles", lambda im: _perturb(im, range(16))),
    ("seam_straddle", _seam_straddle),
    ("seam_elder_flip", _seam_elder_flip),
]


@pytest.mark.parametrize("name,mutate", DIRTY_CASES,
                         ids=[c[0] for c in DIRTY_CASES])
def test_delta_bit_identical_across_dirty_masks(engine, name, mutate):
    base = _img(1)
    frame = mutate(base)
    engine.run_delta(base)                      # prime the store
    got = engine.run_delta(frame)
    _same(engine.run_tiled(frame), got, name)
    _same_as_reference(frame, got, name)
    if name == "none":
        assert got.delta.hit == "full" and got.delta.n_dirty == 0
    else:
        assert got.delta.hit in ("partial", "miss")
        assert got.delta.n_dirty >= 1


@settings(max_examples=6, deadline=None)
@given(st.integers(0, 2 ** 16 - 1))
def test_delta_bit_identical_on_random_dirty_masks(bitmask):
    """Any dirty-tile subset reproduces the cold diagram."""
    eng = _RANDOM_ENGINE
    base = _img(2)
    tiles = [t for t in range(16) if bitmask >> t & 1]
    frame = _perturb(base, tiles, bump=3.0 + bitmask % 7)
    eng.run_delta(base)
    got = eng.run_delta(frame)
    _same(eng.run_tiled(frame), got, f"mask={bitmask:04x}")
    _same_as_reference(frame, got, f"mask={bitmask:04x}")
    if not tiles:
        assert got.delta.hit == "full"
    else:
        assert got.delta.n_dirty == len(tiles)


# One frame in the store: each example's frame is classified against the
# base it just stored, not against an earlier example's frame.
_RANDOM_ENGINE = _engine(delta=DeltaSpec(cache_entries=1))


@pytest.mark.parametrize("filtration,dtype", [("superlevel", "bfloat16"),
                                              ("sublevel", None),
                                              ("superlevel", "int32")])
def test_delta_dtypes_and_sublevel_match_cold(filtration, dtype):
    eng = _engine(filtration=filtration, dtype=dtype)
    base = _img(3) * 20
    for frame in (base, _perturb(base, [2, 9], bump=40.0), base):
        got = eng.run_delta(frame)
        _same(eng.run_tiled(frame), got, f"{filtration} {dtype}")
    assert got.delta.hit == "full"
    tv = -5.0 if filtration == "sublevel" else 5.0
    got = eng.run_delta(base, truncate_value=tv)
    assert got.delta.hit == "miss"
    _same(eng.run_tiled(base, tv), got, "thresholded")


def test_delta_threshold_is_part_of_the_context(engine):
    """Same bytes under another threshold must not reuse state: a miss,
    never a wrong answer."""
    img = _img(4)
    a = engine.run_delta(img, truncate_value=0.0)
    b = engine.run_delta(img, truncate_value=0.5)
    assert a.delta.hit in ("miss", "partial") and b.delta.hit == "miss"
    _same(engine.run_tiled(img, 0.5), b, "tv=0.5")
    assert engine.run_delta(img, truncate_value=0.0).delta.hit == "full"


def test_delta_accepts_staged_tiles_and_providers(engine):
    img = _img(5)
    staged = tiling.load_tile_stacks(_Provider(img), GRID, device="cpu")
    want = engine.run_tiled(img)
    got = engine.run_delta(staged)
    _same(want, got, "staged")
    _same_as_reference(img, got, "staged")
    # the host-array form of the same frame is a full hit on its entry
    assert engine.run_delta(img).delta.hit == "full"
    frame = _perturb(img, [6])
    got = engine.run_delta(tiling.load_tile_stacks(_Provider(frame), GRID,
                                                   device="cpu"))
    assert got.delta.hit == "partial" and got.delta.n_dirty == 1
    _same(engine.run_tiled(frame), got, "staged partial")
    assert engine.run_delta(_Provider(frame)).delta.hit == "full"


def test_delta_disabled_is_a_cold_run_tiled():
    img = _img(6)
    for spec in (None, DeltaSpec(enabled=False)):
        eng = _engine(delta=spec)
        res = eng.run_delta(img)
        assert res.delta == dm.DeltaStats(16, 16, "cold")
        _same(eng.run_tiled(img), res, "disabled")
    with pytest.raises(ValueError):
        _engine(candidate_mode="paper").run_delta(img)


def test_run_sequence_full_hits_after_first_pass(engine):
    frames = [_img(10), _perturb(_img(10), [3]), _img(10)]
    first = [r.delta.hit for r in engine.run_sequence(frames, 0.1)]
    again = [r.delta.hit for r in engine.run_sequence(frames, [0.1] * 3)]
    assert first == ["miss", "partial", "full"]
    assert again == ["full", "full", "full"]
    assert engine.run_delta(frames[1], 0.1).threshold == 0.1


def test_frame_sequence_matches_reference_run_delta():
    """A survey stream through both packages: the same hit kinds, dirty
    counts equal to ``FrameSequence.dirty_tiles``, and the same
    diagrams; the reference's cold run_tiled agrees with the port's."""
    fs = FrameSequence(21, SIZE, grid=GRID, dirty_frac=0.1, stamp=3)
    cfg = dict(tile=dict(grid=GRID, max_features_per_tile=64,
                         max_candidates_per_tile=64))
    eng = _engine(**cfg)
    jeng = JEngine(JConfig(delta=JDeltaSpec(cache_entries=8), **cfg))
    frames = [fs.frame(i) for i in (0, 1, 2)] + [fs.frame(2)]
    # One threshold for the stream (a per-frame statistic would move with
    # the transients and make every frame a miss).
    tv = AstroImage(21, SIZE).filter_threshold("filter_std")
    kinds = []
    for i, (got, want) in enumerate(zip(eng.run_sequence(frames, tv),
                                        jeng.run_sequence(frames, tv))):
        assert (got.delta.hit, got.delta.n_dirty) == \
            (want.delta.hit, want.delta.n_dirty), i
        assert got.threshold == want.threshold
        assert_same_diagram(want.diagram, got.diagram, f"frame {i}")
        kinds.append(got.delta.hit)
    assert kinds == ["miss", "partial", "partial", "full"]
    hits = [r.delta.n_dirty for r in eng.run_sequence(frames[1:3], tv)]
    assert hits == [0, 0]
    hits = [r.delta.n_dirty for r in
            _engine(**cfg).run_sequence(frames, tv)]
    assert hits == [16, len(fs.dirty_tiles(1)), len(fs.dirty_tiles(2)), 0]
    _same(eng.run_tiled(frames[2], tv), got, "cold frame 2")


def test_frame_sequence_dirty_tiles_match_hash_classification():
    fs = FrameSequence(3, SIZE, grid=GRID, dirty_frac=0.2, stamp=3)
    d0, _ = dm.frame_digests(fs.frame(0), GRID)
    for i in (1, 2, 3):
        di, _ = dm.frame_digests(fs.frame(i), GRID)
        dirty = np.flatnonzero([a != b for a, b in zip(d0, di)])
        np.testing.assert_array_equal(dirty, fs.dirty_tiles(i))
    assert fs.dirty_tiles(0).size == 0
    for bad in (dict(size=50), dict(dirty_frac=1.5),
                dict(size=32, stamp=15)):
        kw = dict(size=SIZE, grid=GRID)
        kw.update(bad)
        with pytest.raises(ValueError):
            FrameSequence(0, **kw)


# ---------------------------------------------------------------------------
# Collisions, retries, regrow inside a delta run
# ---------------------------------------------------------------------------

def test_verify_mode_detects_injected_hash_collision(monkeypatch):
    """All-frames-collide digests + verify: the byte compare demotes the
    colliding tiles to dirty, the diagram stays right, and the collision
    counter records it."""
    eng = _engine(delta=DeltaSpec(cache_entries=8, verify=True))
    base = _img(11)
    frame = _perturb(base, [2, 7])
    real = dm.frame_digests

    def colliding(source, grid, *, algo="blake2b", with_bytes=False, **kw):
        digests, raw = real(source, grid, algo=algo, with_bytes=True, **kw)
        return tuple(b"\x00" * 16 for _ in digests), \
            (raw if with_bytes else None)

    monkeypatch.setattr(dm, "frame_digests", colliding)
    eng.run_delta(base)
    got = eng.run_delta(frame)              # digests say "identical frame"
    monkeypatch.setattr(dm, "frame_digests", real)
    _same(eng.run_tiled(frame), got, "collision")
    assert got.delta.hit == "partial" and got.delta.n_dirty == 2
    assert eng.delta_cache_stats()["collisions"] == 2


def test_without_verify_identical_digests_are_trusted(monkeypatch):
    """Control for the collision test: without verify the forged exact
    match returns the cached result."""
    eng = _engine(delta=DeltaSpec(cache_entries=8))
    base = _img(12)
    real = dm.frame_digests

    def colliding(source, grid, *, algo="blake2b", with_bytes=False, **kw):
        digests, raw = real(source, grid, algo=algo, with_bytes=with_bytes,
                            **kw)
        return tuple(b"\x01" * 16 for _ in digests), raw

    monkeypatch.setattr(dm, "frame_digests", colliding)
    first = eng.run_delta(base)
    hit = eng.run_delta(_perturb(base, [2]))
    assert hit.delta.hit == "full"
    _same(first, hit, "trusted")


def test_repeated_runs_replace_and_cached_state_is_not_mutated(engine):
    """A partial run scatters into a copy: the entry it started from keeps
    its own frame's rows, so a later hit on it stays right."""
    img = _img(13)
    first = engine.run_delta(img)
    digests, _ = dm.frame_digests(img, GRID)

    def cached_state():
        key = [k for k in engine._delta_cache._entries if k[1] == digests]
        return engine._delta_cache._entries[key[0]].state

    kept = [t.clone() for t in cached_state()]
    before = len(engine._delta_cache)
    engine.run_delta(img)                   # full hit: no insert
    engine.run_delta(_perturb(img, [1]))    # partial from img's entry
    engine.run_delta(_perturb(img, [1]))    # full hit on the new entry
    assert len(engine._delta_cache) == before + 1
    assert all(torch.equal(a, b) for a, b in zip(kept, cached_state()))
    _same(first, engine.run_delta(img), "replayed")


def test_failed_frame_inserts_nothing_and_retry_hits():
    eng = _engine()
    fs = FrameSequence(21, SIZE, grid=GRID, dirty_frac=0.1, stamp=3)
    armed = [True]

    def frames():
        yield fs.frame(0)
        if armed[0]:
            armed[0] = False
            raise RuntimeError("loader died")
        yield fs.frame(1)

    it = eng.run_sequence(frames())
    next(it)
    with pytest.raises(RuntimeError):
        next(it)
    inserts = eng.delta_cache_stats()["inserts"]
    out = list(eng.run_sequence(fs.frames(3)))
    assert [r.delta.hit for r in out] == ["full", "partial", "partial"]
    assert eng.delta_cache_stats()["inserts"] == inserts + 2
    _same(eng.run_tiled(fs.frame(2)), out[2], "post-fault")


def _counts(img):
    """(roots per tile, diagram rows) of a frame at full capacities."""
    td = tiling.tiled_pixhomology(
        torch.from_numpy(img), grid=GRID, max_features=SIZE * SIZE,
        tile_max_features=144, tile_max_candidates=144)
    return td.n_tile_roots, int(td.diagram.count)


def _checker_tile(img, t):
    """Tile ``t``'s interior (one pixel in from its edges) made a lattice
    of isolated maxima two pixels apart: more roots in that tile alone."""
    out = img.copy()
    tr, tc = SIZE // GRID[0], SIZE // GRID[1]
    r0, c0 = (t // GRID[1]) * tr, (t % GRID[1]) * tc
    yy, xx = np.mgrid[0:tr - 2, 0:tc - 2]
    out[r0 + 1:r0 + tr - 1, c0 + 1:c0 + tc - 1] = \
        10.0 + ((yy % 2 == 0) & (xx % 2 == 0))
    return out


def test_delta_regrow_invalidates_on_tile_level_and_keeps_rows_on_merge():
    """A tile-capacity regrow recomputes every tile (the cached state is
    capacity-shaped: the run becomes a miss); a merge-only regrow keeps
    the fresh rows (still a partial hit).  Both equal a cold run."""
    base = _img(14)
    frame = _checker_tile(base, 5)
    roots_base, count_base = _counts(base)
    roots_frame, count_frame = _counts(frame)
    assert int(roots_frame[5]) > int(roots_base.max())
    assert count_frame > count_base
    # tile level: the base fits the tile capacity, tile 5 of the frame not
    eng = _engine(max_features=SIZE * SIZE, tile=TileSpec(
        grid=GRID, max_features_per_tile=int(roots_base.max()),
        max_candidates_per_tile=144))
    assert eng.run_delta(base).regrow.attempts == 0
    got = eng.run_delta(frame)
    assert got.regrow.attempts >= 1 and got.delta.hit == "miss"
    assert got.delta.n_dirty == 16
    assert got.config.tile.max_features_per_tile >= int(roots_frame[5])
    assert {r["kind"] for r in eng.regrow_log} == {"delta"}
    _same(eng.run_tiled(frame), got, "tile regrow")
    # merge level only: the diagram outgrows max_features, tiles fit
    eng = _engine(max_features=count_base, tile=TileSpec(
        grid=GRID, max_features_per_tile=144, max_candidates_per_tile=144))
    assert eng.run_delta(base).regrow.attempts == 0
    got = eng.run_delta(frame)
    assert got.regrow.attempts >= 1 and got.delta.hit == "partial"
    assert got.delta.n_dirty == 1
    assert got.config.max_features >= count_frame
    assert got.config.tile.max_features_per_tile == 144
    _same(eng.run_tiled(frame), got, "merge regrow")


def test_delta_result_config_and_stats_snapshot():
    eng = _engine(filter_level=FilterLevel.VANILLA)
    assert eng.delta_cache_stats() == CacheStats().snapshot()
    res = eng.run_delta(_img(16))
    assert res.config.tile.grid == GRID and res.delta.n_tiles == 16
    assert eng.delta_cache_stats()["misses"] == 1
    prov = AstroImage(0, SIZE)
    eng2 = _engine(filter_level=FilterLevel.STD)
    r = eng2.run_delta(prov)
    assert r.threshold == eng2.provider_threshold(prov)
    _same(eng2.run_tiled(prov), r, "provider")
