"""A source-injection stream through ``run_sequence`` on the CPU, held to
the benchmark's plain reference.

The stream is the benchmark's own recipe (``bench/recipes/
star_field_stream.py``) at 256² with a 4 x 4 grid: a base star field and
8 realisations, each adding one Gaussian source to one tile.  Run after
the base against a frame store of 4 entries (fewer than the
realisations, as in the benchmark's cell), every realisation is a
partial hit with exactly its own dirty tile, twice round the pool, and
every diagram equals the reference's (``bench/references/
superlevel_ph0.py``, loaded by path) in every field and a cold
``run_tiled``'s bit for bit.  A resubmitted realisation is a full hit; a
source astride a tile border dirties both tiles and stays exact.
"""
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import delta as dm
from repro_torch.ph import DeltaSpec, PHConfig, PHEngine, TileSpec

BENCH = Path(__file__).resolve().parents[1] / "bench"
if str(BENCH) not in sys.path:
    sys.path.append(str(BENCH))

import harness.spec as spec  # noqa: E402
import harness.threshold as threshold  # noqa: E402

SIZE, GRID, POOL, SEED = 256, (4, 4), 8, 2 ** 31 + 2027
FRAME = {"size": SIZE, "dtype": "float32", "density_per_px": 0.0034,
         "sky": 100.0, "read_noise": 5.0, "amp_min": 10.0,
         "amp_max": 5000.0, "sigma_min": 1.0, "sigma_max": 2.5,
         "stamp": 15, "count_spread": 0.4,
         "inject": {"grid": list(GRID), "dirty_frac": 1 / 16,
                    "sources_per_tile": 1, "amp": 2000.0,
                    "amp_factor_min": 0.5, "amp_factor_max": 1.5,
                    "sigma_min": 1.0, "sigma_max": 2.5, "stamp": 15}}


def _reference():
    path = BENCH / "references" / "superlevel_ph0.py"
    mod_spec = importlib.util.spec_from_file_location(
        "stream_test_superlevel_ph0", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


REF = _reference()


def _engine(delta=True):
    return PHEngine(PHConfig(
        merge_impl="boruvka", tile=TileSpec(grid=GRID),
        delta=DeltaSpec(cache_entries=4) if delta else None), device="cpu")


@pytest.fixture(scope="module")
def stream():
    recipe = spec.load_module("recipes", "star_field_stream", BENCH)
    frames, dirty = recipe.draw(FRAME, POOL, SEED, "cpu")
    t = threshold.variant2(frames[0], 1.0, 2.0)
    return frames.numpy(), dirty, t


def _exact(frame, t, result, cold):
    """Every field equal to the reference's, and bitwise to ``cold``."""
    want = REF.expected((frame[None], [t]), "cpu")
    got = tuple(f.cpu() for f in result.diagram)
    assert REF.compare(want, got) == dict.fromkeys(REF.LIMITS, 0)
    for a, b in zip(result.diagram, cold.diagram):
        assert torch.equal(a, b)


def _changed_tiles(a, b):
    da, _ = dm.frame_digests(a, GRID)
    db, _ = dm.frame_digests(b, GRID)
    return [i for i, (x, y) in enumerate(zip(da, db)) if x != y]


def test_stream_partial_hits_are_exact(stream):
    frames, dirty, t = stream
    eng, cold = _engine(), _engine(delta=False)
    order = [0] + list(range(1, POOL + 1)) * 2
    results = list(eng.run_sequence((frames[i] for i in order), t))
    assert results[0].delta.hit == "miss"
    for i, res in zip(order[1:], results[1:]):
        assert res.delta.hit == "partial"
        assert res.delta.n_dirty == len(dirty[i - 1]) == 1
        assert _changed_tiles(frames[0], frames[i]) == \
            dirty[i - 1].tolist()
    for k, i in enumerate(order[:POOL + 1]):
        _exact(frames[i], t, results[k],
               cold.run_tiled(frames[i], truncate_value=t))
    for k in range(POOL + 1, len(order)):
        for a, b in zip(results[k].diagram,
                        results[k - POOL].diagram):
            assert torch.equal(a, b)
    assert eng.delta_cache_stats()["partial_hits"] == 2 * POOL


def test_resubmitted_realisation_is_a_full_hit(stream):
    frames, _, t = stream
    eng = _engine()
    first = [eng.run_delta(frames[i], t) for i in (0, 1)]
    again = eng.run_delta(frames[1], t)
    assert [r.delta.hit for r in first] == ["miss", "partial"]
    assert again.delta.hit == "full" and again.delta.n_dirty == 0
    _exact(frames[1], t, again, _engine(delta=False).run_tiled(
        frames[1], truncate_value=t))


def test_source_astride_a_tile_border_dirties_both(stream):
    frames, _, t = stream
    tile = SIZE // GRID[1]
    frame = frames[0].copy()
    yy, xx = np.mgrid[-7:8, -7:8].astype(np.float32)
    row, col = tile + tile // 2, 2 * tile        # tiles 5 and 6 meet
    frame[row - 7:row + 8, col - 7:col + 8] += 2500.0 * np.exp(
        -(yy ** 2 + xx ** 2) / (2.0 * 1.7 ** 2))
    assert _changed_tiles(frames[0], frame) == [5, 6]
    eng = _engine()
    eng.run_delta(frames[0], t)
    res = eng.run_delta(frame, t)
    assert res.delta.hit == "partial" and res.delta.n_dirty == 2
    _exact(frame, t, res, _engine(delta=False).run_tiled(
        frame, truncate_value=t))
