"""Roofline-ranked, measured autotuner for the PH knobs the port acts on.

The port's copy of ``repro.roofline.autotune``, with the same names,
contracts, JSON schema and ``"HxW|dtype|backend"`` keys, so that one
cache file serves both packages.  Per ``(shape, dtype, backend)`` it
searches in two stages:

1. **Model ranking**: every candidate is scored by the dominant term of
   :func:`repro_torch.roofline.analysis.roofline_terms` over
   :func:`~repro_torch.roofline.analysis.ph_program_cost` (the H100's
   constants; ordering, not magnitude, is what is used).
2. **Measured trials**: the model's top ``measure_top`` candidates run
   the whole-image program on the stride-2 peak grid, in ``trials``
   rounds that time every measured candidate once in turn.  The fastest
   wins, except over the incumbent (the knobs an untuned engine runs:
   :data:`DEFAULTS`, or ``choose_grid``'s grid), which stays unless the
   challenger's slowest trial beats the incumbent's fastest.

The winner persists in a JSON disk cache keyed by :func:`cache_key`.
``PHEngine`` reads it through :func:`lookup` when ``PHConfig.autotune``
is on: ``lookup`` never builds or measures, a miss returns
:data:`DEFAULTS` (``source="default"``) and the config's own fields
stand.  :func:`autotune` and :func:`autotune_grid` are the offline entry
points.

Where the port differs from the reference:

* **Keys**: :func:`cache_key` spells a dtype as the reference does
  (``"float32"``, never ``"torch.float32"``), so entries hit across the
  packages.
* **Backend**: the device type, ``"cuda"`` on the card or ``"cpu"``;
  ``backend=None`` resolves through
  :func:`repro_torch.ph.engine.resolve_device`, which raises without a
  card (pass ``backend="cpu"`` to tune on the host).  The engine passes
  its device's type.
* **Default cache file**: ``artifacts/autotune_cache_torch.json``
  (uncommitted).  The reference's committed ``autotune_cache.json`` is
  read or written only when a caller passes its path.
* **Candidate space**: ``strip_rows`` alone, the one knob the measured
  program acts on.  ``tournament_width`` has no effect on it (the
  Boruvka-fused program selects by compaction and runs no tournament)
  and ``phase_c_block`` none on the card; both stay at :data:`DEFAULTS`
  — 4 candidates, not 24.  Entries keep all three fields.
* **model_score**: counts bytes from the program's tensors, no compile.
* **measure**: best-of-``trials`` host wall around one call, ending in
  ``torch.cuda.synchronize()`` on the card; the first call is excluded.
  A call is ~40 launches and a dozen readbacks, so the host clock's
  noise exceeds most knobs' effect: hence the rounds and the incumbent
  rule above, where the reference takes the fastest best-of-``trials``.
* **Failures**: the model stage skips a candidate it cannot score (the
  reference skips one that fails to compile) and an all-fail search
  returns :data:`DEFAULTS` with nothing persisted; a measured trial that
  raises propagates (on the card it would hide a kernel that fails at
  some strip height, and CUDA errors are sticky).
* **Provenance**: an entry also records every scored candidate's model
  score, its fastest measured seconds and the spread of its trials
  (``"trials"``, ``"tile_grid_trials"``), and a ``"cuda"`` entry the
  card's name (``"device"``).
"""
from __future__ import annotations

import dataclasses
import functools
import json
import time
from pathlib import Path

import torch

# Repo-root artifacts/, beside the reference's committed cache file.
DEFAULT_CACHE_PATH = (Path(__file__).resolve().parents[3]
                      / "artifacts" / "autotune_cache_torch.json")


@dataclasses.dataclass(frozen=True)
class TunedParams:
    """One tuned knob assignment.  ``source`` records provenance:
    ``"default"`` (no cache entry — the config's own fields stand),
    ``"cache"`` (disk hit), ``"model"`` (roofline rank, no measurement
    budget), ``"measured"`` (trial winner).

    ``tile_grid`` is the tuned tile decomposition for the *tiled* path
    (``None`` = not tuned — the engine falls back to
    ``repro_torch.core.tiling.choose_grid``); searched separately by
    :func:`autotune_grid`."""

    strip_rows: int = 8
    phase_c_block: int = 1024
    tournament_width: int = 2
    source: str = "default"
    tile_grid: tuple[int, int] | None = None


DEFAULTS = TunedParams()


def dtype_name(dtype) -> str:
    """A dtype as the reference spells it in cache keys (``"float32"``)."""
    return str(dtype).removeprefix("torch.")


def resolve_backend(backend: str | None) -> str:
    """``backend``, or the type of the device an engine would use."""
    if backend is not None:
        return str(backend)
    from repro_torch.ph.engine import resolve_device
    return resolve_device(None).type


def cache_key(shape, dtype, backend: str | None = None) -> str:
    """``"HxW|dtype|backend"`` — the disk-cache key for one shape family
    (``backend=None`` resolves to the CUDA device's type, or raises)."""
    h, w = (int(shape[0]), int(shape[1]))
    return f"{h}x{w}|{dtype_name(dtype)}|{resolve_backend(backend)}"


def load_cache(path=None) -> dict:
    p = Path(path) if path is not None else DEFAULT_CACHE_PATH
    try:
        with open(p) as f:
            cache = json.load(f)
        return cache if isinstance(cache, dict) else {}
    except (OSError, ValueError):
        return {}


def save_cache(cache: dict, path=None) -> Path:
    p = Path(path) if path is not None else DEFAULT_CACHE_PATH
    p.parent.mkdir(parents=True, exist_ok=True)
    tmp = p.with_name(p.name + ".tmp")
    tmp.write_text(json.dumps(cache, indent=2, sort_keys=True) + "\n")
    tmp.replace(p)
    return p


def lookup(shape, dtype, *, path=None, backend: str | None = None
           ) -> TunedParams:
    """Tuned params for ``(shape, dtype, backend)`` — pure cache lookup.

    This is the engine-facing call: it never builds, measures, or
    writes; a missing/corrupt entry returns :data:`DEFAULTS` so the
    caller's own config fields apply.
    """
    entry = load_cache(path).get(cache_key(shape, dtype, backend))
    if not isinstance(entry, dict):
        return DEFAULTS
    tg = entry.get("tile_grid")
    try:
        grid = None if tg is None else (int(tg[0]), int(tg[1]))
    except (TypeError, ValueError, IndexError):
        grid = None
    try:
        return TunedParams(int(entry["strip_rows"]),
                           int(entry["phase_c_block"]),
                           int(entry["tournament_width"]), "cache", grid)
    except (KeyError, TypeError, ValueError):
        # Grid-only entry (autotune_grid ran, the scalar search did not):
        # keep source="default" so the caller's own scalar fields stand,
        # but still surface the tuned grid.
        return dataclasses.replace(DEFAULTS, tile_grid=grid)


def candidate_space(shape) -> list[TunedParams]:
    """The search grid: strip heights bounded by the image, the other
    knobs held at :data:`DEFAULTS`.  Every candidate computes
    bit-identical diagrams (the knob only re-blocks the computation), so
    the search needs no correctness filter."""
    h = int(shape[0])
    rows = [r for r in (4, 8, 16, 32) if r <= h] or [h]
    return [dataclasses.replace(DEFAULTS, strip_rows=r, source="candidate")
            for r in rows]


def peak_grid(shape, dtype, device) -> torch.Tensor:
    """The worst-case input of the engine's warmup: distinct peaks on the
    stride-2 grid of a zero image — the most features and candidates an
    image of this shape can produce.  Made on ``device``, with the
    reference's casts (the peak numbers are int64; floats go through
    float32, integers wrap)."""
    h, w = (int(shape[0]), int(shape[1]))
    dt = getattr(torch, dtype_name(dtype))
    ph, pw = (h + 1) // 2, (w + 1) // 2
    peaks = 1 + torch.arange(ph * pw, device=device).view(ph, pw)
    if dt.is_floating_point:
        peaks = peaks.to(torch.float32)
    img = torch.zeros((h, w), dtype=dt, device=device)
    img[::2, ::2] = peaks.to(dt)
    return img


def _synchronize(x: torch.Tensor) -> None:
    if x.is_cuda:
        torch.cuda.synchronize(x.device)


def _best_seconds(fn, x, trials: int) -> float:
    """Best-of-``trials`` host wall of ``fn(x)`` after one excluded call."""
    fn(x)
    _synchronize(x)
    best = float("inf")
    for _ in range(max(1, trials)):
        t0 = time.perf_counter()
        fn(x)
        _synchronize(x)
        best = min(best, time.perf_counter() - t0)
    return best


def _rounds(cands, time_one, trials: int) -> dict:
    """Each candidate's seconds over ``trials`` rounds; a round times
    every candidate once, in turn, so drift of the clock or the card
    reaches them all alike."""
    samples = {c: [] for c in cands}
    for _ in range(trials):
        for c in cands:
            samples[c].append(time_one(c))
    return samples


def _pick(samples: dict, incumbent):
    """The fastest candidate — but the incumbent, when it was measured,
    stays unless the challenger's slowest trial beats its fastest (a win
    larger than the challenger's own spread)."""
    best = min(samples, key=lambda c: min(samples[c]))
    if incumbent in samples and max(samples[best]) >= min(samples[incumbent]):
        return incumbent
    return best


def _timing(samples: list | None) -> dict:
    if not samples:
        return {"seconds": None, "spread_s": None}
    return {"seconds": min(samples), "spread_s": max(samples) - min(samples)}


def _build(shape, dtype, params: TunedParams, device=None):
    """The whole-image program pinned to ``params`` (fused stages,
    Boruvka-fused merge, packed keys, the kernels where the device has
    them: ``use_pallas=None``) and its worst-case input on ``device``."""
    from repro_torch.core.pixhomology import pixhomology

    h, w = (int(shape[0]), int(shape[1]))
    n = h * w
    fn = functools.partial(
        pixhomology, max_features=min(8192, n),
        max_candidates=min(32768, n), merge_impl="boruvka",
        merge_keys="packed", phase_a_impl="fused",
        strip_rows=params.strip_rows, phase_c_impl="fused",
        tournament_width=params.tournament_width)
    return fn, peak_grid((h, w), dtype, resolve_backend(device))


def model_score(shape, dtype, params: TunedParams) -> float:
    """Roofline seconds of the program under ``params`` — the dominant
    term of :func:`~repro_torch.roofline.analysis.roofline_terms` over
    :func:`~repro_torch.roofline.analysis.ph_program_cost` at the
    capacities :func:`_build` uses.  Used for *relative* ranking only."""
    from repro_torch.roofline.analysis import ph_program_cost, roofline_terms

    n = int(shape[0]) * int(shape[1])
    c = ph_program_cost(shape, dtype, params, min(8192, n), min(32768, n))
    terms = roofline_terms(c["flops"], c["bytes"], 0.0)
    return max(terms["compute_s"], terms["memory_s"], terms["collective_s"])


def measure(shape, dtype, params: TunedParams, *, trials: int = 3,
            device=None) -> float:
    """Best-of-``trials`` steady-state seconds of the program under
    ``params`` on ``device`` (a device type; default the CUDA device)."""
    fn, x = _build(shape, dtype, params, device)
    return _best_seconds(fn, x, trials)


def _card_name(backend: str) -> dict:
    return {"device": torch.cuda.get_device_name()} if backend == "cuda" \
        else {}


def autotune(shape, dtype, *, path=None, backend: str | None = None,
             measure_top: int = 3, trials: int = 3,
             space: list[TunedParams] | None = None) -> TunedParams:
    """Search, persist, and return tuned params for one shape family.

    A pre-existing cache entry short-circuits to :func:`lookup` (re-tune
    by deleting the entry/file).  ``measure_top=0`` or ``trials=0`` is a
    zero measurement budget: the roofline model alone ranks (or, if no
    candidate can be scored, :data:`DEFAULTS` comes back and nothing is
    persisted).  Trials run on ``backend``'s device, in rounds; a
    measured candidate with :data:`DEFAULTS`' knobs is the incumbent
    (:func:`_pick`).
    """
    shape = (int(shape[0]), int(shape[1]))
    dtype = dtype_name(dtype)
    backend = resolve_backend(backend)
    key = cache_key(shape, dtype, backend)
    cache = load_cache(path)
    prior = cache.get(key)
    if isinstance(prior, dict) and "strip_rows" in prior:
        # Scalar knobs already tuned (a grid-only entry from
        # autotune_grid does not short-circuit the scalar search).
        return lookup(shape, dtype, path=path, backend=backend)

    cands = list(space) if space is not None else candidate_space(shape)
    scored = []
    for p in cands:
        try:
            scored.append((model_score(shape, dtype, p), p))
        except Exception:   # a candidate the model cannot score: skip it
            continue
    if not scored:
        return DEFAULTS
    scored.sort(key=lambda sp: sp[0])

    budget = [p for _, p in scored[:max(0, measure_top)]] if trials > 0 \
        else []
    samples = _rounds(budget, lambda p: measure(
        shape, dtype, p, trials=1, device=backend), trials)
    if samples:
        incumbent = dataclasses.replace(DEFAULTS, source="candidate")
        best = dataclasses.replace(_pick(samples, incumbent),
                                   source="measured")
    else:
        best = dataclasses.replace(scored[0][1], source="model")

    entry = cache.get(key)
    if not isinstance(entry, dict):
        entry = {}
    entry.update({"strip_rows": best.strip_rows,
                  "phase_c_block": best.phase_c_block,
                  "tournament_width": best.tournament_width,
                  "source": best.source,
                  "trials": [{"strip_rows": p.strip_rows,
                              "phase_c_block": p.phase_c_block,
                              "tournament_width": p.tournament_width,
                              "model_s": score,
                              **_timing(samples.get(p))}
                             for score, p in scored],
                  **_card_name(backend)})
    cache[key] = entry
    save_cache(cache, path)
    if "tile_grid" in entry:
        try:
            tg = entry["tile_grid"]
            best = dataclasses.replace(
                best, tile_grid=(int(tg[0]), int(tg[1])))
        except (TypeError, ValueError, IndexError):
            pass
    return best


# ---------------------------------------------------------------------------
# Tile-grid search (the tiled/delta path's decomposition knob)
# ---------------------------------------------------------------------------

def grid_candidates(shape, *, max_tile_pixels: int | None = None,
                    limit: int = 6) -> list[tuple[int, int]]:
    """Candidate tile grids for one image shape: dividing ``(gr, gc)``
    pairs with at least 2 and at most 1024 tiles, tiles no thinner than
    8 pixels, optionally bounded by ``max_tile_pixels``.  Pre-ranked by
    (square-ish tiles, fewer tiles) and truncated to ``limit`` — the
    per-tile cost model then ranks the survivors, so the heuristic only
    bounds the search, never picks the winner."""
    h, w = (int(shape[0]), int(shape[1]))
    cands = []
    for gr in (d for d in range(1, h + 1) if h % d == 0):
        tr = h // gr
        if tr < 8:
            break
        for gc in (d for d in range(1, w + 1) if w % d == 0):
            tc = w // gc
            if tc < 8:
                break
            n_tiles = gr * gc
            if not 2 <= n_tiles <= 1024:
                continue
            if max_tile_pixels is not None and tr * tc > max_tile_pixels:
                continue
            cands.append((abs(tr - tc), n_tiles, (gr, gc)))
    cands.sort()
    return [g for _, _, g in cands[:max(1, limit)]]


def grid_model_score(shape, dtype, grid, *, device=None) -> float:
    """Byte model for one tile grid: the per-tile phases' peak bytes
    (:func:`repro_torch.core.tiling.per_tile_cost` on ``device``) over
    all tiles plus the O(boundary) seam table.  Relative ordering is all
    that is used, as for :func:`model_score`."""
    from repro_torch.core.tiling import _ring_coords, per_tile_cost

    h, w = (int(shape[0]), int(shape[1]))
    gr, gc = grid
    tr, tc = h // gr, w // gc
    n_tiles = gr * gc
    c = per_tile_cost((tr, tc), dtype, n_tiles,
                      device=resolve_backend(device))
    per_tile = (c["phase_a"]["peak_bytes_est"]
                + c["phase_b"]["peak_bytes_est"])
    table = n_tiles * len(_ring_coords(tr, tc)[0]) * 8
    return float(n_tiles * per_tile + table)


def _build_tiled(shape, dtype, grid, device=None):
    """The tiled program pinned to ``grid`` and the stride-2 peak input
    :func:`_build` uses, on ``device``."""
    from repro_torch.core.tiling import tiled_pixhomology

    h, w = (int(shape[0]), int(shape[1]))
    n = h * w
    gr, gc = grid
    tile_n = (h // gr) * (w // gc)
    fn = functools.partial(
        tiled_pixhomology, grid=(gr, gc), max_features=min(8192, n),
        tile_max_features=min(2048, tile_n),
        tile_max_candidates=min(8192, tile_n), merge_keys="packed")
    return fn, peak_grid((h, w), dtype, resolve_backend(device))


def measure_grid(shape, dtype, grid, *, trials: int = 3,
                 device=None) -> float:
    """Best-of-``trials`` steady-state seconds of the tiled program under
    ``grid`` (the first call is excluded)."""
    fn, x = _build_tiled(shape, dtype, grid, device)
    return _best_seconds(fn, x, trials)


def autotune_grid(shape, dtype, *, path=None, backend: str | None = None,
                  max_tile_pixels: int | None = None, measure_top: int = 2,
                  trials: int = 2,
                  space: list[tuple[int, int]] | None = None
                  ) -> tuple[int, int] | None:
    """Search, persist, and return the tile grid for one shape family.

    Rides the same disk cache entry as :func:`autotune` (the
    ``tile_grid`` field of :func:`cache_key`'s entry), so the engine
    recovers both through one :func:`lookup`.  A pre-existing
    ``tile_grid`` short-circuits; if no candidate can be scored, ``None``
    comes back and nothing is persisted (the engine then falls through to
    ``choose_grid``).  Trials run in rounds; under a ``max_tile_pixels``
    budget, ``choose_grid``'s grid, when measured, is the incumbent
    (:func:`_pick`).
    """
    from repro_torch.core.tiling import choose_grid

    shape = (int(shape[0]), int(shape[1]))
    dtype = dtype_name(dtype)
    backend = resolve_backend(backend)
    key = cache_key(shape, dtype, backend)
    cache = load_cache(path)
    entry = cache.get(key)
    if isinstance(entry, dict) and entry.get("tile_grid") is not None:
        return lookup(shape, dtype, path=path, backend=backend).tile_grid

    cands = list(space) if space is not None else \
        grid_candidates(shape, max_tile_pixels=max_tile_pixels)
    scored = []
    for g in cands:
        try:
            scored.append((grid_model_score(shape, dtype, g,
                                            device=backend), tuple(g)))
        except Exception:   # a candidate the model cannot score: skip it
            continue
    if not scored:
        return None
    scored.sort()

    budget = [g for _, g in scored[:max(0, measure_top)]] if trials > 0 \
        else []
    samples = _rounds(budget, lambda g: measure_grid(
        shape, dtype, g, trials=1, device=backend), trials)
    if samples:
        incumbent = None if max_tile_pixels is None else \
            choose_grid(shape, max_tile_pixels)
        best, src = _pick(samples, incumbent), "measured"
    else:
        best, src = scored[0][1], "model"

    if not isinstance(entry, dict):
        entry = {}
    entry.update({"tile_grid": [int(best[0]), int(best[1])],
                  "tile_grid_source": src,
                  "tile_grid_trials": [
                      {"grid": [int(g[0]), int(g[1])], "model_bytes": score,
                       **_timing(samples.get(g))} for score, g in scored],
                  **_card_name(backend)})
    cache[key] = entry
    save_cache(cache, path)
    return (int(best[0]), int(best[1]))
