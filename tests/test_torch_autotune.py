"""Port parity: the autotuner (repro_torch.roofline) and the engine's lookup.

Every test of the reference's ``tests/test_autotune.py`` except its
``perf_gate`` tests, against ``repro_torch.roofline.autotune``: the disk
cache round-trips and ``lookup`` is a pure read (a miss is DEFAULTS, not a
search); tuned knobs fold into the engine's effective config
deterministically and never change a diagram; the tile-grid search.  The
port's searches pass ``backend="cpu"`` (its ``backend=None`` means the
CUDA device) and its model and trial functions take the device.  Then
parity with the JAX package: cache keys, lookups of the committed
``artifacts/autotune_cache.json`` (read only), grid candidates, effective
configs and tuned diagrams under one cache file; the cost sources
(``per_tile_cost``, ``ph_program_cost``, the LM counts).
"""
import json
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from _torch_parity import assert_same_diagram
from repro.configs import base as jbase
from repro.ph import PHConfig as JConfig
from repro.ph import PHEngine as JEngine
from repro.roofline import analysis as janalysis
from repro.roofline import autotune as jat
from repro_torch.configs import base as tbase
from repro_torch.core import tiling
from repro_torch.ph import PHConfig, PHEngine, TileSpec
from repro_torch.roofline import analysis
from repro_torch.roofline import autotune as at

_REPO = Path(__file__).resolve().parents[1]
COMMITTED_CACHE = _REPO / "artifacts" / "autotune_cache.json"


# ---------------------------------------------------------------------------
# cache round-trip + graceful fallback
# ---------------------------------------------------------------------------

def test_cache_round_trip(tmp_path):
    path = tmp_path / "cache.json"
    key = at.cache_key((64, 64), "float32", "cpu")
    at.save_cache({key: {"strip_rows": 16, "phase_c_block": 256,
                         "tournament_width": 4, "source": "measured"}},
                  path)
    got = at.lookup((64, 64), "float32", path=path, backend="cpu")
    assert got == at.TunedParams(16, 256, 4, "cache")
    # Unknown shape in the same file: DEFAULTS, source "default".
    assert at.lookup((128, 128), "float32", path=path,
                     backend="cpu") == at.DEFAULTS


def test_lookup_never_measures(tmp_path, monkeypatch):
    # The engine-facing call must stay a pure cache read even on a miss.
    def boom(*a, **k):
        raise AssertionError("lookup must not build or measure")
    monkeypatch.setattr(at, "model_score", boom)
    monkeypatch.setattr(at, "measure", boom)
    monkeypatch.setattr(at, "_build", boom)
    assert at.lookup((32, 32), "float32", path=tmp_path / "missing.json",
                     backend="cpu") == at.DEFAULTS


@pytest.mark.parametrize("content", [
    "not json {", json.dumps(["a", "list"]),
    json.dumps({"32x32|float32|cpu": "not-a-dict"}),
    json.dumps({"32x32|float32|cpu": {"strip_rows": "NaN?"}}),
])
def test_lookup_corrupt_cache_falls_back(tmp_path, content):
    path = tmp_path / "cache.json"
    path.write_text(content)
    assert at.lookup((32, 32), "float32", path=path,
                     backend="cpu") == at.DEFAULTS


def test_autotune_all_candidates_fail_returns_defaults(tmp_path,
                                                       monkeypatch):
    path = tmp_path / "cache.json"
    monkeypatch.setattr(at, "model_score",
                        lambda *a, **k: (_ for _ in ()).throw(RuntimeError))
    got = at.autotune((16, 16), "float32", path=path, backend="cpu")
    assert got == at.DEFAULTS
    assert not path.exists()    # nothing persisted on total failure


def test_autotune_persists_and_short_circuits(tmp_path, monkeypatch):
    path = tmp_path / "cache.json"
    space = [at.TunedParams(4, 256, 2, "candidate"),
             at.TunedParams(8, 1024, 2, "candidate")]
    scores = {4: 1.0, 8: 2.0}
    monkeypatch.setattr(at, "model_score",
                        lambda s, d, p: scores[p.strip_rows])
    monkeypatch.setattr(at, "measure", lambda s, d, p, trials, device: 0.01)
    got = at.autotune((16, 16), "float32", path=path, backend="cpu",
                      measure_top=1, trials=1, space=space)
    assert (got.strip_rows, got.phase_c_block, got.source) == (4, 256,
                                                               "measured")
    entry = json.loads(path.read_text())["16x16|float32|cpu"]
    assert entry["strip_rows"] == 4 and entry["source"] == "measured"
    # Every scored candidate's model and measured seconds ride along; a
    # host entry names no card.
    assert [(t["strip_rows"], t["model_s"], t["seconds"])
            for t in entry["trials"]] == [(4, 1.0, 0.01), (8, 2.0, None)]
    assert "device" not in entry
    # Existing entry short-circuits: a re-tune may not build anything.
    def boom(*a, **k):
        raise AssertionError("existing entry must short-circuit")
    monkeypatch.setattr(at, "model_score", boom)
    monkeypatch.setattr(at, "measure", boom)
    again = at.autotune((16, 16), "float32", path=path, backend="cpu")
    assert (again.strip_rows, again.source) == (4, "cache")


def test_autotune_model_only_budget(tmp_path, monkeypatch):
    # measure_top=0: zero measurement budget, the roofline rank decides.
    path = tmp_path / "cache.json"
    space = [at.TunedParams(4, 256, 2, "candidate"),
             at.TunedParams(8, 1024, 2, "candidate")]
    monkeypatch.setattr(at, "model_score",
                        lambda s, d, p: 1.0 if p.strip_rows == 8 else 2.0)
    monkeypatch.setattr(
        at, "measure",
        lambda *a, **k: (_ for _ in ()).throw(AssertionError("no trials")))
    got = at.autotune((16, 16), "float32", path=path, backend="cpu",
                      measure_top=0, space=space)
    assert (got.strip_rows, got.source) == (8, "model")


def test_autotune_real_search_smoke(tmp_path):
    # End to end on a tiny image: real program, real trial, real cache.
    path = tmp_path / "cache.json"
    got = at.autotune((8, 8), "float32", path=path, backend="cpu",
                      measure_top=1, trials=1,
                      space=[at.TunedParams(4, 256, 2, "candidate")])
    assert got.source == "measured"
    assert at.lookup((8, 8), "float32", path=path,
                     backend="cpu").source == "cache"


# ---------------------------------------------------------------------------
# engine folding: deterministic plan keys, unchanged diagrams
# ---------------------------------------------------------------------------

def _engine(tmp_cache, **kw):
    return PHEngine(PHConfig(max_features=256, max_candidates=256,
                             merge_impl="boruvka", autotune=True,
                             autotune_cache=str(tmp_cache), **kw),
                    device="cpu")


def test_effective_config_folds_cache_deterministically(tmp_path):
    path = tmp_path / "cache.json"
    key = at.cache_key((12, 11), "float32", "cpu")   # the engine's device
    at.save_cache({key: {"strip_rows": 4, "phase_c_block": 256,
                         "tournament_width": 4, "source": "measured"}},
                  path)
    eng = _engine(path)
    eff = eng._effective_config((12, 11), torch.float32)
    assert (eff.strip_rows, eff.phase_c_block,
            eff.tournament_width) == (4, 256, 4)
    # Deterministic: a second resolve (memoized) and a fresh engine over
    # the same cache produce the same plan key.
    eff2 = eng._effective_config((12, 11), torch.float32)
    assert eff2.plan_key() == eff.plan_key()
    assert _engine(path)._effective_config(
        (12, 11), torch.float32).plan_key() == eff.plan_key()
    # The tuned knobs are plan-key-bearing: defaults select a different
    # plan.
    base = PHConfig(max_features=256, max_candidates=256,
                    merge_impl="boruvka")
    assert eff.plan_key() != base.plan_key()
    # Unknown shape: the config's own fields stand, plan key unchanged
    # relative to autotune-off (autotune itself is not in the plan key).
    miss = eng._effective_config((7, 7), torch.float32)
    assert miss.strip_rows == base.strip_rows
    assert miss.plan_key() == base.plan_key()


def test_autotuned_engine_diagram_unchanged(tmp_path):
    # Tuned knobs only re-block the computation: the diagram is
    # bit-identical to the default engine's.
    rng = np.random.default_rng(0)
    img = (rng.standard_normal((12, 11)) * 50).astype(np.float32)
    path = tmp_path / "cache.json"
    at.save_cache({at.cache_key((12, 11), "float32", "cpu"): {
        "strip_rows": 4, "phase_c_block": 256, "tournament_width": 4,
        "source": "measured"}}, path)
    got = _engine(path).run(img).diagram
    want = PHEngine(PHConfig(max_features=256, max_candidates=256,
                             merge_impl="boruvka"),
                    device="cpu").run(img).diagram
    for f in ("birth", "death", "p_birth", "p_death", "count"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      getattr(want, f).numpy(), f)


def test_missing_cache_file_engine_falls_back(tmp_path):
    eng = _engine(tmp_path / "never_written.json")
    eff = eng._effective_config((12, 11), torch.float32)
    assert eff.strip_rows == eng.config.strip_rows
    assert eff.phase_c_block == eng.config.phase_c_block


# ---------------------------------------------------------------------------
# tile-grid search: candidates, persistence, engine folding
# ---------------------------------------------------------------------------

def test_grid_candidates_divide_and_rank():
    got = at.grid_candidates((128, 128))
    assert got[:4] == [(2, 2), (4, 4), (8, 8), (16, 16)]
    for gr, gc in at.grid_candidates((96, 64), limit=12):
        assert 96 % gr == 0 and 64 % gc == 0
        assert 96 // gr >= 8 and 64 // gc >= 8
        assert 2 <= gr * gc <= 1024
    # max_tile_pixels caps the coarse end of the space
    for gr, gc in at.grid_candidates((128, 128), max_tile_pixels=32 * 32):
        assert (128 // gr) * (128 // gc) <= 32 * 32
    assert len(at.grid_candidates((128, 128), limit=2)) == 2


def test_grid_model_score_orders_by_traffic():
    # More tiles -> more halo+table bytes for one image: the model must
    # rank a finer grid as costlier on a fixed shape.
    a = at.grid_model_score((128, 128), "float32", (2, 2), device="cpu")
    b = at.grid_model_score((128, 128), "float32", (8, 8), device="cpu")
    assert 0 < a < b


def test_grid_only_cache_entry_keeps_default_scalars(tmp_path):
    path = tmp_path / "cache.json"
    key = at.cache_key((64, 64), "float32", "cpu")
    at.save_cache({key: {"tile_grid": [4, 4],
                         "tile_grid_source": "model"}}, path)
    got = at.lookup((64, 64), "float32", path=path, backend="cpu")
    assert got.tile_grid == (4, 4)
    # scalar knobs keep config defaults: source stays "default" so the
    # engine does not fold DEFAULTS over the user's scalar settings
    assert got.source == "default"
    assert got.strip_rows == at.DEFAULTS.strip_rows


def test_autotune_grid_persists_and_short_circuits(tmp_path, monkeypatch):
    path = tmp_path / "cache.json"
    monkeypatch.setattr(at, "grid_model_score",
                        lambda s, d, g, device: float(g[0] * g[1]))
    monkeypatch.setattr(at, "measure_grid",
                        lambda s, d, g, trials, device: 0.01 * g[0])
    got = at.autotune_grid((64, 64), "float32", path=path, backend="cpu",
                           measure_top=2, trials=1,
                           space=[(2, 2), (4, 4)])
    assert got == (2, 2)
    entry = json.loads(path.read_text())["64x64|float32|cpu"]
    assert entry["tile_grid"] == [2, 2]
    assert entry["tile_grid_source"] == "measured"
    assert entry["tile_grid_trials"] == [
        {"grid": [2, 2], "model_bytes": 4.0, "seconds": 0.02,
         "spread_s": 0.0},
        {"grid": [4, 4], "model_bytes": 16.0, "seconds": 0.04,
         "spread_s": 0.0}]

    def boom(*a, **k):
        raise AssertionError("existing tile_grid must short-circuit")
    monkeypatch.setattr(at, "grid_model_score", boom)
    monkeypatch.setattr(at, "measure_grid", boom)
    assert at.autotune_grid((64, 64), "float32", path=path,
                            backend="cpu") == (2, 2)


def test_autotune_grid_model_only_and_all_fail(tmp_path, monkeypatch):
    path = tmp_path / "cache.json"
    monkeypatch.setattr(at, "grid_model_score",
                        lambda s, d, g, device: float(g[0]))
    monkeypatch.setattr(
        at, "measure_grid",
        lambda *a, **k: (_ for _ in ()).throw(AssertionError("no trials")))
    got = at.autotune_grid((64, 64), "float32", path=path, backend="cpu",
                           measure_top=0, space=[(4, 4), (2, 2)])
    assert got == (2, 2)
    entry = json.loads(path.read_text())["64x64|float32|cpu"]
    assert entry["tile_grid_source"] == "model"
    # every candidate failing -> None, nothing persisted
    monkeypatch.setattr(
        at, "grid_model_score",
        lambda *a, **k: (_ for _ in ()).throw(RuntimeError("boom")))
    assert at.autotune_grid((32, 32), "float32", path=path,
                            backend="cpu", space=[(2, 2)]) is None
    assert "32x32|float32|cpu" not in json.loads(path.read_text())


def test_autotune_grid_and_scalars_share_one_entry(tmp_path, monkeypatch):
    # Both searches merge into ONE cache entry per shape family, and one
    # lookup recovers both (scalars flip source to "cache").
    path = tmp_path / "cache.json"
    monkeypatch.setattr(at, "grid_model_score", lambda s, d, g, device: 1.0)
    monkeypatch.setattr(at, "measure_grid",
                        lambda s, d, g, trials, device: 0.01)
    at.autotune_grid((16, 16), "float32", path=path, backend="cpu",
                     trials=1, space=[(2, 2)])
    monkeypatch.setattr(at, "model_score", lambda s, d, p: 1.0)
    monkeypatch.setattr(at, "measure", lambda s, d, p, trials, device: 0.01)
    at.autotune((16, 16), "float32", path=path, backend="cpu",
                measure_top=1, trials=1,
                space=[at.TunedParams(4, 256, 2, "candidate")])
    raw = json.loads(path.read_text())
    assert list(raw) == ["16x16|float32|cpu"]
    entry = raw["16x16|float32|cpu"]
    assert entry["tile_grid"] == [2, 2] and entry["strip_rows"] == 4
    got = at.lookup((16, 16), "float32", path=path, backend="cpu")
    assert got.tile_grid == (2, 2) and got.strip_rows == 4
    assert got.source == "cache"


def test_engine_folds_tuned_grid_into_tiled_runs(tmp_path):
    rng = np.random.default_rng(3)
    img = rng.standard_normal((32, 32)).astype(np.float32)
    path = tmp_path / "cache.json"
    at.save_cache({at.cache_key((32, 32), "float32", "cpu"): {
        "tile_grid": [2, 2], "tile_grid_source": "model"}}, path)
    eng = _engine(path)
    res = eng.run_tiled(img)
    assert tuple(res.config.tile.grid) == (2, 2)
    # bit-identical to pinning the same grid by hand
    want = PHEngine(PHConfig(max_features=256, max_candidates=256,
                             merge_impl="boruvka"),
                    device="cpu").run_tiled(img, grid=(2, 2))
    for f in res.diagram._fields:
        np.testing.assert_array_equal(getattr(res.diagram, f).numpy(),
                                      getattr(want.diagram, f).numpy(), f)
    # an explicit spec grid always wins over the tuned one
    pinned = PHEngine(PHConfig(max_features=256, max_candidates=256,
                               merge_impl="boruvka", autotune=True,
                               autotune_cache=str(path),
                               tile=TileSpec(grid=(4, 4))), device="cpu")
    assert tuple(pinned.run_tiled(img).config.tile.grid) == (4, 4)


def test_engine_ignores_stale_tuned_grid(tmp_path):
    # A cached grid that no longer divides the shape must be skipped,
    # not crash the run.
    rng = np.random.default_rng(4)
    img = rng.standard_normal((32, 32)).astype(np.float32)
    path = tmp_path / "cache.json"
    at.save_cache({at.cache_key((32, 32), "float32", "cpu"): {
        "tile_grid": [5, 5], "tile_grid_source": "model"}}, path)
    res = _engine(path).run_tiled(img)
    assert 32 % res.config.tile.grid[0] == 0


def test_autotune_grid_real_search_smoke(tmp_path):
    path = tmp_path / "cache.json"
    got = at.autotune_grid((16, 16), "float32", path=path, backend="cpu",
                           measure_top=1, trials=1, space=[(2, 2)])
    assert got == (2, 2)
    assert at.lookup((16, 16), "float32", path=path,
                     backend="cpu").tile_grid == (2, 2)


# ---------------------------------------------------------------------------
# the port's own contracts
# ---------------------------------------------------------------------------

def test_measured_trial_that_raises_propagates(tmp_path, monkeypatch):
    # The model stage may skip a candidate; a failing trial must surface
    # (on the card it is a kernel failing at some strip height).
    path = tmp_path / "cache.json"

    def fail(*a, **k):
        raise RuntimeError("trial failed")
    monkeypatch.setattr(at, "measure", fail)
    with pytest.raises(RuntimeError, match="trial failed"):
        at.autotune((16, 16), "float32", path=path, backend="cpu",
                    measure_top=2, trials=1)
    monkeypatch.setattr(at, "measure_grid", fail)
    with pytest.raises(RuntimeError, match="trial failed"):
        at.autotune_grid((16, 16), "float32", path=path, backend="cpu",
                         trials=1, space=[(2, 2)])
    assert not path.exists()


def test_candidate_space_holds_phase_c_block_at_its_default():
    # Only strip_rows reaches the measured program: tournament_width (no
    # tournament in the Boruvka-fused program) and phase_c_block (no
    # effect in the port) stay at DEFAULTS.
    space = at.candidate_space((64, 64))
    assert [p.strip_rows for p in space] == [4, 8, 16, 32]
    assert {p.phase_c_block for p in space} == {at.DEFAULTS.phase_c_block}
    assert {p.tournament_width for p in space} == {
        at.DEFAULTS.tournament_width}
    assert {p.source for p in space} == {"candidate"}
    # strip heights bounded by the image; a 3-row image keeps its height
    assert {p.strip_rows for p in at.candidate_space((12, 64))} == {4, 8}
    assert {p.strip_rows for p in at.candidate_space((3, 64))} == {3}


def test_backend_none_means_the_cuda_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        at.cache_key((8, 8), "float32")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert at.cache_key((8, 8), torch.float32) == "8x8|float32|cuda"
    assert at.DEFAULT_CACHE_PATH.name == "autotune_cache_torch.json"


def test_real_search_ranks_every_candidate(tmp_path):
    # The real model over the whole space, then real trials of the two
    # best: the entry lists all 4 candidates in model order.
    path = tmp_path / "cache.json"
    got = at.autotune((32, 32), "float32", path=path, backend="cpu",
                      measure_top=2, trials=2)
    entry = json.loads(path.read_text())["32x32|float32|cpu"]
    trials = entry["trials"]
    assert len(trials) == 4
    scores = [t["model_s"] for t in trials]
    assert scores == sorted(scores) and scores[0] > 0
    assert sum(t["seconds"] is not None for t in trials) == 2
    assert all(t["spread_s"] >= 0 for t in trials[:2])
    assert got.source == "measured"
    assert got.strip_rows in {t["strip_rows"] for t in trials[:2]}


def _fake_seconds(monkeypatch, name, seconds):
    """``at.<name>`` returns the next of ``seconds[candidate]`` per call
    and logs the order of the calls."""
    calls = []

    def fake(s, d, c, trials, device):
        assert trials == 1
        calls.append(c)
        return seconds[c][sum(x == c for x in calls) - 1]
    monkeypatch.setattr(at, name, fake)
    return calls


@pytest.mark.parametrize("s8, s4, kept", [
    ([0.010, 0.012, 0.011], [0.009, 0.013, 0.0095], 8),   # within spread
    ([0.010, 0.012, 0.011], [0.008, 0.0095, 0.0085], 4),  # every trial wins
])
def test_autotune_keeps_the_default_unless_beaten_beyond_spread(
        tmp_path, monkeypatch, s8, s4, kept):
    path = tmp_path / "cache.json"
    space = [at.TunedParams(4, 1024, 2, "candidate"),
             at.TunedParams(8, 1024, 2, "candidate")]
    monkeypatch.setattr(at, "model_score",
                        lambda s, d, p: float(p.strip_rows))
    calls = _fake_seconds(monkeypatch, "measure",
                          {space[0]: s4, space[1]: s8})
    got = at.autotune((16, 16), "float32", path=path, backend="cpu",
                      measure_top=2, trials=3, space=space)
    assert (got.strip_rows, got.source) == (kept, "measured")
    # Rounds: every candidate once a round, in model order.
    assert [c.strip_rows for c in calls] == [4, 8] * 3
    trials = json.loads(path.read_text())["16x16|float32|cpu"]["trials"]
    assert [(t["strip_rows"], t["seconds"], t["spread_s"])
            for t in trials] == [(4, min(s4), max(s4) - min(s4)),
                                 (8, min(s8), max(s8) - min(s8))]


@pytest.mark.parametrize("kept_grid", [True, False])
def test_autotune_grid_keeps_choose_grid_unless_beaten_beyond_spread(
        tmp_path, monkeypatch, kept_grid):
    path = tmp_path / "cache.json"
    incumbent = tiling.choose_grid((32, 32), 256)
    other = (4, 4) if incumbent != (4, 4) else (2, 8)
    fast = [0.001, 0.0011] if not kept_grid else [0.001, 0.003]
    monkeypatch.setattr(at, "grid_model_score",
                        lambda s, d, g, device: 0.0 if g == other else 1.0)
    _fake_seconds(monkeypatch, "measure_grid",
                  {other: fast, incumbent: [0.002, 0.002]})
    got = at.autotune_grid((32, 32), "float32", path=path, backend="cpu",
                           max_tile_pixels=256, trials=2,
                           space=[incumbent, other])
    assert got == (incumbent if kept_grid else other)
    rows = json.loads(path.read_text())["32x32|float32|cpu"][
        "tile_grid_trials"]
    assert [tuple(r["grid"]) for r in rows] == [other, incumbent]
    assert rows[1]["spread_s"] == 0.0


@pytest.mark.parametrize("dtype", ["uint8", "int16", "int32", "float32",
                                   "bfloat16"])
@pytest.mark.parametrize("shape", [(7, 5), (9, 1), (512, 512)])
def test_peak_grid_is_the_reference_trial_input(dtype, shape):
    want = np.asarray(jat._build(shape, dtype, jat.DEFAULTS)[1])
    got = at.peak_grid(shape, dtype, "cpu")
    assert got.dtype == getattr(torch, dtype)
    if dtype == "bfloat16":
        got, want = got.view(torch.int16), want.view(np.int16)
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["uint8", "int16", "int32", "float32",
                                  "bfloat16"])
def test_cache_key_spells_dtypes_as_the_reference(name):
    want = jat.cache_key((12, 7), jnp.dtype(name), "cpu")
    assert at.cache_key((12, 7), getattr(torch, name), "cpu") == want
    assert at.cache_key((12, 7), name, "cpu") == want


@pytest.mark.parametrize("shape", [(128, 128), (256, 256), (512, 512),
                                   (1024, 1024), (64, 64)])
def test_lookup_of_the_committed_cache_matches_the_reference(shape):
    before = COMMITTED_CACHE.read_bytes()
    want = jat.lookup(shape, "float32", path=COMMITTED_CACHE, backend="cpu")
    got = at.lookup(shape, torch.float32, path=COMMITTED_CACHE,
                    backend="cpu")
    assert _same_params(got, want)
    assert COMMITTED_CACHE.read_bytes() == before


def _same_params(a, b) -> bool:
    return (a.strip_rows, a.phase_c_block, a.tournament_width, a.source,
            a.tile_grid) == (b.strip_rows, b.phase_c_block,
                             b.tournament_width, b.source, b.tile_grid)


@pytest.mark.parametrize("shape", [(128, 128), (96, 64), (10240, 10240),
                                   (37, 120), (64, 8), (4096, 2048)])
@pytest.mark.parametrize("max_tile_pixels", [None, 1024, 1 << 20])
def test_grid_candidates_match_the_reference(shape, max_tile_pixels):
    for limit in (2, 6, 12):
        assert at.grid_candidates(shape, max_tile_pixels=max_tile_pixels,
                                  limit=limit) == jat.grid_candidates(
            shape, max_tile_pixels=max_tile_pixels, limit=limit)


def _one_cache(tmp_path):
    """One cache file both packages read: scalars for 12x11, a grid for
    32x32 (each package's CPU key is ``...|cpu``)."""
    path = tmp_path / "cache.json"
    jat.save_cache({
        jat.cache_key((12, 11), "float32", "cpu"): {
            "strip_rows": 4, "phase_c_block": 256, "tournament_width": 4,
            "source": "measured"},
        jat.cache_key((32, 32), "float32", "cpu"): {
            "strip_rows": 16, "phase_c_block": 1024, "tournament_width": 2,
            "source": "measured", "tile_grid": [2, 4],
            "tile_grid_source": "measured"}}, path)
    return path


def _engines(path):
    kw = dict(max_features=256, max_candidates=256, merge_impl="boruvka",
              autotune=True, autotune_cache=str(path))
    return JEngine(JConfig(**kw)), PHEngine(PHConfig(**kw), device="cpu")


@pytest.mark.parametrize("shape", [(12, 11), (32, 32), (7, 7)])
def test_effective_config_matches_the_jax_engine(tmp_path, shape):
    jeng, teng = _engines(_one_cache(tmp_path))
    want = jeng._effective_config(shape, jnp.dtype(jnp.float32))
    got = teng._effective_config(shape, torch.float32)
    for f in ("strip_rows", "phase_c_block", "tournament_width"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.stage_signature() == want.stage_signature()
    assert teng._tuned_grid(shape, torch.float32) == \
        jeng._tuned_grid(shape, jnp.dtype(jnp.float32))


def test_tuned_runs_match_the_jax_engine(tmp_path):
    jeng, teng = _engines(_one_cache(tmp_path))
    rng = np.random.default_rng(7)
    small = (rng.standard_normal((12, 11)) * 50).astype(np.float32)
    assert_same_diagram(jeng.run(small).diagram, teng.run(small).diagram,
                        "run 12x11")
    # The tuned strip height reached the port's plan.
    plan = next(p for k, p in teng._plans.items() if k[0] == "single")
    assert plan.fn.keywords["strip_rows"] == 4
    assert plan.fn.keywords["tournament_width"] == 4
    big = (rng.standard_normal((32, 32)) * 50).astype(np.float32)
    assert_same_diagram(jeng.run(big).diagram, teng.run(big).diagram,
                        "run 32x32")
    want, got = jeng.run_tiled(big), teng.run_tiled(big)
    assert tuple(got.config.tile.grid) == tuple(want.config.tile.grid) \
        == (2, 4)
    assert_same_diagram(want.diagram, got.diagram, "run_tiled 32x32")


def test_autotune_off_keeps_plan_keys(tmp_path):
    # Without autotune nothing changes: the plan keys carry the config's
    # own plan key, whatever the cache holds.
    path = _one_cache(tmp_path)
    off = PHEngine(PHConfig(max_features=256, max_candidates=256,
                            merge_impl="boruvka", autotune_cache=str(path)),
                   device="cpu")
    img = np.random.default_rng(8).standard_normal((12, 11)).astype(
        np.float32)
    off.run(img)
    assert {k[-1] for k in off._plans} == {off.config.plan_key()}
    assert off._effective_config((12, 11), torch.float32) is off.config
    assert off._tuned_grid((32, 32), torch.float32) is None


def test_engine_lookup_builds_and_measures_nothing(tmp_path, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("the engine must never build or measure")
    for name in ("model_score", "measure", "_build", "measure_grid",
                 "_build_tiled", "grid_model_score", "autotune",
                 "autotune_grid"):
        monkeypatch.setattr(at, name, boom)
    _, teng = _engines(tmp_path / "absent.json")
    assert teng._effective_config((12, 11), torch.float32) is teng.config
    assert teng._tuned_grid((32, 32), torch.float32) is None
    assert not (tmp_path / "absent.json").exists()


# ---------------------------------------------------------------------------
# the cost sources
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tile_shape", [(16, 16), (32, 24)])
def test_per_tile_cost_has_the_reference_keys(tile_shape):
    want = _reference_tile_cost(tile_shape)
    got = tiling.per_tile_cost(tile_shape, "float32", 4, device="cpu")
    assert set(got) == set(want)
    for phase in ("phase_a", "phase_b"):
        assert set(got[phase]) == set(want[phase])
        c = got[phase]
        assert c["peak_bytes_est"] == (c["argument_bytes"]
                                       + c["output_bytes"] + c["temp_bytes"])
        assert min(c.values()) >= 0 and c["temp_bytes"] > 0
    for k in ("tile_shape", "ring_pixels", "table_entries"):
        assert got[k] == want[k], k
    # Phase A's arguments are the halo-padded value and index tiles.
    tr, tc = tile_shape
    assert got["phase_a"]["argument_bytes"] == 2 * 4 * (tr + 2) * (tc + 2)
    # Everything scales with the tile, only the table with n_tiles.
    more = tiling.per_tile_cost(tile_shape, "float32", 64, device="cpu")
    assert more["phase_a"] == got["phase_a"]
    assert more["phase_b"] == got["phase_b"]
    assert more["table_entries"] == 16 * got["table_entries"]


def test_footprint_counts_the_peak_of_live_bytes():
    # Ten 4 KiB temporaries, each freed by the next: the peak holds two,
    # not ten, and a second run counts the same.
    def fn(x):
        for _ in range(10):
            y = x * 2
        return y.sum().reshape(1)

    x = torch.ones(1024)
    _, first = tiling._footprint(fn, (x,))
    _, again = tiling._footprint(fn, (x,))
    assert first == again == {"argument_bytes": 4096, "output_bytes": 4,
                              "temp_bytes": 2 * 4096 - 4,
                              "peak_bytes_est": 4096 + 2 * 4096}


def _reference_tile_cost(tile_shape):
    from repro.core import tiling as jtiling
    return jtiling.per_tile_cost(tile_shape, jnp.float32, 4)


def test_ph_program_cost_follows_capacity_and_strip_height():
    p8 = at.TunedParams(8, 1024, 2)
    small = analysis.ph_program_cost((256, 256), "float32", p8, 1024, 4096)
    large = analysis.ph_program_cost((256, 256), "float32", p8, 8192, 32768)
    assert set(small) >= {"bytes", "flops", "by_stage"}
    assert large["bytes"] > small["bytes"]
    assert large["by_stage"]["phase_c"] > small["by_stage"]["phase_c"]
    assert small["bytes"] == sum(small["by_stage"].values())
    b = [analysis.ph_program_cost((256, 256), "float32",
                                  at.TunedParams(s, 1024, 2), 8192,
                                  32768)["by_stage"]["phase_b"]
         for s in (1, 4, 8, 16, 32)]
    assert b == sorted(b, reverse=True) and len(set(b)) == len(b)
    # The kernel's bytes and its width regime.
    item = analysis.ph_program_cost((4, 8), "bfloat16", p8, 8, 8)
    assert item["by_stage"]["phase_a"] == 32 * (2 + 8)
    wide = analysis.ph_program_cost((64, 70000), "float32", p8, 8, 8)
    assert wide["phase_a_layout"] == "global"
    assert wide["by_stage"]["phase_a"] == 64 * 70000 * (4 + 8 + 8)
    # Tournament width has no term in the compaction-selected program.
    w4 = analysis.ph_program_cost((256, 256), "float32",
                                  at.TunedParams(8, 1024, 4), 8192, 32768)
    assert w4 == large
    # model_score is the program's dominant roofline term (memory here).
    assert at.model_score((256, 256), "float32", p8) == pytest.approx(
        large["bytes"] / analysis.HBM_BW)


def test_roofline_terms_keep_the_reference_form():
    got = analysis.roofline_terms(1e9, 1e9, 1e8)
    want = janalysis.roofline_terms(1e9, 1e9, 1e8)
    assert set(got) == set(want)
    assert got["compute_s"] == 1e9 / 989e12
    assert got["memory_s"] == 1e9 / 3.35e12
    assert got["collective_s"] == 1e8 / 450e9
    assert got["bottleneck"] == "memory_s"


@pytest.mark.parametrize("arch", tbase.ARCH_IDS)
def test_lm_counts_match_the_reference(arch):
    tcfg, jcfg = tbase.get_config(arch), jbase.get_config(arch)
    assert analysis.count_params(tcfg, active=True) == \
        janalysis.count_params(jcfg, active=True)
    assert analysis.total_params(tcfg) == janalysis.total_params(jcfg)
    assert analysis.active_params(tcfg) == janalysis.active_params(jcfg)
    for name, shape in tbase.SHAPES.items():
        assert analysis.model_flops(tcfg, shape) == janalysis.model_flops(
            jcfg, jbase.SHAPES[name]), name
