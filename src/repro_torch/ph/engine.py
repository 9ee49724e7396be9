"""PHEngine: the entry point for PixHomology computation in the port.

Counterpart of ``repro.ph.engine`` for the whole-image path:

* a **plan cache** keyed like the reference's
  ``(kind, shape, dtype, capacities, truncated, config.plan_key())``.
  PyTorch runs eagerly, so a plan is the core function bound to its
  static arguments; ``traces`` counts plan builds and ``calls`` counts
  calls, so ``traces`` stays far below ``calls`` under reuse;
* **overflow auto-regrow** — the ``Diagram.overflow`` flag triggers
  re-dispatch at doubled ``max_features``/``max_candidates`` up to a
  ceiling (default: the pixel count), with a sticky per-shape memo and
  per-call :class:`RegrowStats`;
* **batches** — uniform ``(B, H, W)`` batches dispatch as they are, mixed
  shapes are padded into one shape bucket and repaired row by row
  (:mod:`repro_torch.pipeline.padding`), and exact content duplicates
  compute once;
* **diagram distances** — :meth:`PHEngine.distance_matrix`, its own
  cached plan kind (:mod:`repro_torch.kernels.ph_distance`);
* **halo-tiled PH** — :meth:`PHEngine.run_tiled` of a host image, a tile
  provider or staged tile stacks (:mod:`repro_torch.core.tiling`), with
  per-level regrow (tile capacities, then the seam merge's
  ``max_features``);
* **delta-PH** — :meth:`PHEngine.run_delta` / :meth:`run_sequence`
  against a frame store (:mod:`repro_torch.core.delta`,
  :class:`repro_torch.cache.DiagramCache`): only dirty tiles recompute;
* **the overlap engine** — ``config.overlap``
  (:mod:`repro_torch.ph.overlap`): :meth:`PHEngine.run_batch_async`
  stages engine-built batches through pinned buffers of a
  :class:`~repro_torch.ph.overlap.StagingPool` and defers the
  computation, the overflow check and the regrow into ``resolve()``;
  results stream to pinned host memory;
* **the distributed pipeline** — :meth:`PHEngine.run_distributed` over a
  :class:`repro_torch.distributed.context.DistContext` (one executor per
  device; :mod:`repro_torch.pipeline`);
* **the warm plan pool** — :meth:`PHEngine.warmup` walks each serving
  bucket's regrow chain with a worst-case dummy, so the serving daemon
  (:mod:`repro_torch.serving`) builds no plan and regrows nothing in
  steady state;
* **autotuned knobs** — with ``config.autotune`` each image shape
  family's cached tuned knobs (:mod:`repro_torch.roofline.autotune`)
  fold into an effective config that keys its plans, and its tuned tile
  grid into the tiled paths; the lookup never measures;
* **telemetry** — each public entry opens a :mod:`repro_torch.telemetry`
  call, and its parts are spans: ``prep`` (``check_finite``, ``cast``,
  ``stage``, ``upload``), ``threshold``, ``grid`` (``choose_grid``),
  ``dedupe``, ``dispatch`` (one per plan call), ``regrow`` (around each
  replay), ``overflow_check``, ``d2h`` and ``repair``, and on
  ``run_delta`` ``delta.hash``, ``delta.lookup`` (the frame store's
  lookup and put), ``delta.stage`` and ``delta.scatter`` with the
  counters ``delta_full``/``delta_partial``/``delta_miss`` (one a call)
  and ``delta_dirty_tiles`` (real dirty tiles whose A+B re-ran, bucket
  padding left out); the recorder is off unless enabled.

The engine runs on the CUDA device unless the caller passes another
``device`` (the tests pass ``"cpu"``); without CUDA, ``PHEngine()`` raises
instead of falling back.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import math
import threading
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.core import Diagram, batched_pixhomology, \
    num_candidates as core_num_candidates, pixhomology, stack_diagrams
from repro_torch.core.packed_keys import check_finite, resolve_merge_keys
from repro_torch.core.reference import diagram_to_array
from repro_torch.distributed.context import canonical_device
from repro_torch.ph.config import FilterLevel, OverlapSpec, PHConfig, \
    TileSpec
from repro_torch.ph.overlap import OverlapCounters, PendingResult, \
    StagingPool, start_d2h

# The dtypes the kernels take; wider inputs are canonicalized the way the
# reference package canonicalizes them without 64-bit mode.
SUPPORTED_DTYPES = (torch.uint8, torch.int16, torch.int32, torch.float32,
                    torch.bfloat16)
_CANONICAL = {torch.float64: torch.float32, torch.int64: torch.int32}
_CONFIG_DTYPES = {"float32": torch.float32, "float64": torch.float32,
                  "int32": torch.int32, "bfloat16": torch.bfloat16}
# The engine's behaviour when the config carries no overlap spec:
# synchronous results, fresh staging buffers per batch.
_OVERLAP_OFF = OverlapSpec(enabled=False)


def threshold_dtype(image_dtype: torch.dtype) -> torch.dtype:
    """Dtype for Variant-2 thresholds: the image dtype for floats, float32
    for integer images (so fractional thresholds survive)."""
    return image_dtype if image_dtype.is_floating_point else torch.float32


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA device; raises when there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "PHEngine runs on the CUDA device by default and no CUDA "
                "device is available; pass device='cpu' to run the plain "
                "PyTorch versions on the host")
        return torch.device("cuda")
    return torch.device(device)


def as_host_tensor(image) -> torch.Tensor:
    """A numpy array (bfloat16 included) or tensor as a tensor, without
    copying host data where it can be shared."""
    if isinstance(image, torch.Tensor):
        return image
    arr = np.ascontiguousarray(np.asarray(image))
    if not arr.flags.writeable:          # torch wants memory it may write
        arr = arr.copy()
    if arr.dtype.name == "bfloat16":    # numpy extension dtype
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _is_array(images) -> bool:
    return isinstance(images, (np.ndarray, torch.Tensor))


def _shape(im) -> tuple:
    return tuple(im.shape) if hasattr(im, "shape") else np.shape(im)


class Plan:
    """One cached callable plus its build/call counters (calls are
    counted under the plan lock, so concurrent submitters can share it)."""

    __slots__ = ("fn", "key", "traces", "calls", "_lock")

    def __init__(self, fn: Callable, key: tuple):
        self.fn = fn
        self.key = key
        self.traces = 0
        self.calls = 0
        self._lock = threading.Lock()

    def __call__(self, *args):
        with self._lock:
            self.calls += 1
        with telemetry.span("dispatch"):
            return self.fn(*args)


@dataclasses.dataclass(frozen=True)
class RegrowStats:
    """What the overflow auto-regrow loop did for one run."""

    attempts: int                  # re-dispatches performed (0 = first try fit)
    final_max_features: int
    final_max_candidates: int
    overflow: bool                 # residual overflow after the final attempt

    @property
    def regrown(self) -> bool:
        return self.attempts > 0


@dataclasses.dataclass(frozen=True)
class PHResult:
    """Diagram plus the effective configuration that produced it."""

    diagram: Diagram
    config: PHConfig               # capacities reflect any regrow
    regrow: RegrowStats
    # Variant-2 threshold(s) applied: a scalar for run(), a (B,) array for
    # run_batch(), None when no filtering was in effect.
    threshold: Any = None
    # run_delta's repro_torch.core.delta.DeltaStats; None elsewhere.
    delta: Any = None

    def to_array(self) -> np.ndarray:
        return diagram_to_array(self.diagram)


class PHEngine:
    """Config-driven PH computation with plan caching and auto-regrow.

    Share one engine across calls of one workload: the plan cache and the
    regrow memo only pay off when reused.
    """

    def __init__(self, config: PHConfig | None = None, device=None):
        self.config = config if config is not None else PHConfig()
        if not isinstance(self.config, PHConfig):
            raise TypeError(f"config must be a PHConfig, "
                            f"got {type(self.config).__name__}")
        self.device = resolve_device(device)
        self._plans: dict[tuple, Plan] = {}
        # Largest regrown capacities per (kind, shape, dtype): later calls
        # start there instead of re-walking the doubling chain.
        self._grown: dict[tuple, tuple[int, int]] = {}
        self._hits = 0
        self._misses = 0
        self.regrow_log: list[dict] = []
        # The delta frame store, made at the first run_delta call.
        self._delta_cache = None
        # Autotune memos per (shape, dtype name): the effective config and
        # the tuned tile grid, so the disk cache is read once a family.
        self._tuned: dict[tuple, PHConfig] = {}
        self._tuned_grids: dict[tuple, tuple[int, int] | None] = {}
        # Overlap-engine accounting (transfers, blocking syncs by thread
        # role), bumped by the engine, the executor and the driver.
        self.overlap_counters = OverlapCounters()
        # Staging buffers of engine-built batches, reused under donation.
        self.staging = StagingPool(reuse=self.donate_batched())
        # Guards the plan cache, the regrow memo and every counter; never
        # held while a plan computes.
        self._lock = threading.RLock()

    # -- plan cache --------------------------------------------------------

    def get_plan(self, key: tuple,
                 make_fn: Callable[[Plan], Callable]) -> Plan:
        """Fetch or build the plan for ``key`` (one plan object per key,
        however many threads race the miss).  ``make_fn(plan)`` returns the
        callable."""
        with self._lock:
            plan = self._plans.get(key)
            if plan is None:
                plan = Plan(None, key)
                plan.fn = make_fn(plan)
                self._plans[key] = plan
                self._misses += 1
            else:
                self._hits += 1
            return plan

    def plan_stats(self) -> dict:
        with self._lock:
            plans = list(self._plans.values())
            return {
                "plans": len(plans),
                "traces": sum(p.traces for p in plans),
                "calls": sum(p.calls for p in plans),
                "hits": self._hits,
                "misses": self._misses,
                "regrows": len(self.regrow_log),
            }

    # -- overlap policy ----------------------------------------------------

    def overlap_spec(self) -> OverlapSpec:
        """Effective overlap policy — a disabled spec when the config
        carries none."""
        o = self.config.overlap
        return o if o is not None else _OVERLAP_OFF

    def donate_batched(self) -> bool:
        """Whether engine-built batches are staged in reused pool buffers
        (the port's form of buffer donation; never a caller's tensor)."""
        o = self.overlap_spec()
        return o.enabled and o.donate

    def _stream_results(self) -> bool:
        """Whether dispatches defer their computation into ``resolve()``
        and stream their results to pinned host memory."""
        o = self.overlap_spec()
        return o.enabled and o.async_overflow

    # -- autotune lookup ---------------------------------------------------

    def _tuned_params(self, shape2d, dtype):
        """The disk-cache entry of this shape family for the engine's
        device type (:func:`repro_torch.roofline.autotune.lookup`: a pure
        read that never builds or measures)."""
        from repro_torch.roofline import autotune
        return autotune.lookup(tuple(shape2d), dtype,
                               path=self.config.autotune_cache,
                               backend=self.device.type)

    def _effective_config(self, shape2d, dtype) -> PHConfig:
        """The config with autotuned ``(strip_rows, phase_c_block,
        tournament_width)`` folded in for this image shape family,
        memoized per (shape, dtype).

        With ``config.autotune`` on this is a pure disk-cache lookup — the
        engine never measures; a missing cache entry keeps the config's
        own fields.  The effective config's :meth:`PHConfig.plan_key`
        keys the plan cache, so tuned knobs deterministically select
        plans.
        """
        from repro_torch.roofline.autotune import dtype_name
        cfg = self.config
        if not cfg.autotune:
            return cfg
        key = (tuple(shape2d), dtype_name(dtype))
        with self._lock:
            got = self._tuned.get(key)
        if got is not None:
            return got
        tp = self._tuned_params(shape2d, dtype)
        eff = cfg if tp.source == "default" else cfg.replace(
            strip_rows=tp.strip_rows, phase_c_block=tp.phase_c_block,
            tournament_width=tp.tournament_width)
        with self._lock:
            self._tuned[key] = eff
        return eff

    def _tuned_grid(self, shape2d, dtype) -> tuple[int, int] | None:
        """Autotuned tile grid for this shape family — a pure disk-cache
        lookup, memoized per (shape, dtype); ``None`` when autotune is off
        or the cache has no ``tile_grid`` for the family."""
        from repro_torch.roofline.autotune import dtype_name
        if not self.config.autotune:
            return None
        key = (tuple(shape2d), dtype_name(dtype))
        with self._lock:
            if key in self._tuned_grids:
                return self._tuned_grids[key]
        tg = self._tuned_params(shape2d, dtype).tile_grid
        with self._lock:
            self._tuned_grids[key] = tg
        return tg

    def _ph_kwargs(self, mf: int, mc: int, merge_keys: str,
                   cfg: PHConfig) -> dict:
        """Static arguments of one plan: capacities plus the stage
        signature's knobs of ``cfg`` (the effective config)."""
        return dict(max_features=mf, max_candidates=mc,
                    candidate_mode=cfg.candidate_mode,
                    merge_impl=cfg.merge_impl, merge_keys=merge_keys,
                    phase_a_impl=cfg.phase_a_impl,
                    strip_rows=cfg.strip_rows,
                    phase_c_impl=cfg.phase_c_impl,
                    tournament_width=cfg.tournament_width,
                    use_pallas=cfg.use_pallas, filtration=cfg.filtration)

    def _local_plan(self, kind: str, shape, dtype, mf: int, mc: int,
                    truncated: bool) -> Plan:
        """Plan for ``kind`` "single" (pixhomology) or "batched"."""
        callee = pixhomology if kind == "single" else batched_pixhomology
        mk = resolve_merge_keys(self.config.merge_keys, dtype)
        eff = self._effective_config(tuple(shape)[-2:], dtype)
        key = (kind, tuple(shape), str(dtype), mf, mc, truncated,
               eff.plan_key())

        def build(plan: Plan):
            plan.traces += 1
            return functools.partial(callee,
                                     **self._ph_kwargs(mf, mc, mk, eff))

        return self.get_plan(key, build)

    def sharded_plan(self, ctx, shape, dtype, mf: int, mc: int) -> Plan:
        """Batched PH of an ``(M, Hb, Wb)`` batch over ``ctx``'s devices
        (always thresholded: vanilla rounds pass the inert extreme).

        The plan takes each device's rows and thresholds as two lists, one
        tensor per device, and returns one ``Diagram`` per device.  A
        device's batch of one runs the single-image program, as the
        reference's ``images.shape[0] == 1`` branch does (the pipeline's
        ``M == dp_size`` rounds).  Devices run one after another.
        """
        mk = resolve_merge_keys(self.config.merge_keys, dtype)
        eff = self._effective_config(tuple(shape)[-2:], dtype)
        key = ("sharded", ctx, tuple(shape), str(dtype), mf, mc,
               eff.plan_key())

        def build(plan: Plan):
            plan.traces += 1
            kw = self._ph_kwargs(mf, mc, mk, eff)

            def compute(shards, tvals):
                outs = []
                for x, tv in zip(shards, tvals):
                    if x.shape[0] == 1:
                        d = pixhomology(x[0], tv[0], **kw)
                        outs.append(Diagram(*(f.unsqueeze(0) for f in d)))
                    else:
                        outs.append(batched_pixhomology(x, tv, **kw))
                return outs

            return compute

        return self.get_plan(key, build)

    def _stage_kwargs(self, dtype) -> dict:
        """Static arguments shared by the tiled and delta plans."""
        cfg = self.config
        return dict(merge_keys=resolve_merge_keys(cfg.merge_keys, dtype),
                    filtration=cfg.filtration)

    def _merge_kwargs(self) -> dict:
        cfg = self.config
        return dict(phase_c_impl=cfg.phase_c_impl,
                    phase_c_block=cfg.phase_c_block,
                    use_pallas=cfg.use_pallas)

    def tiled_plan(self, shape, dtype, grid, mf: int, tf: int, tk: int,
                   truncated: bool) -> Plan:
        """Halo-tiled PH plan (:func:`repro_torch.core.tiling.\
tiled_pixhomology`): ``mf`` is the global diagram capacity, ``tf``/``tk``
        the per-tile root/candidate capacities."""
        from repro_torch.core.tiling import tiled_pixhomology
        key = ("tiled", tuple(shape), str(dtype), grid, mf, tf, tk,
               truncated, self.config.plan_key())

        def build(plan: Plan):
            plan.traces += 1
            return functools.partial(
                tiled_pixhomology, grid=grid, max_features=mf,
                tile_max_features=tf, tile_max_candidates=tk,
                **self._stage_kwargs(dtype), **self._merge_kwargs())

        return self.get_plan(key, build)

    def tiled_stacks_plan(self, shape, dtype, grid, mf: int, tf: int,
                          tk: int, truncated: bool) -> Plan:
        """Tiled PH plan over pre-staged tile stacks
        (:func:`repro_torch.core.tiling.tiled_pixhomology_stacks`) — the
        streaming path where no host image exists."""
        from repro_torch.core.tiling import tiled_pixhomology_stacks
        key = ("tiled_stacks", tuple(shape), str(dtype), grid, mf, tf, tk,
               truncated, self.config.plan_key())

        def build(plan: Plan):
            plan.traces += 1
            return functools.partial(
                tiled_pixhomology_stacks, shape=tuple(shape), grid=grid,
                max_features=mf, tile_max_features=tf,
                tile_max_candidates=tk, **self._stage_kwargs(dtype),
                **self._merge_kwargs())

        return self.get_plan(key, build)

    def delta_ab_plan(self, tile_shape, dtype, n_stack: int, tf: int,
                      tk: int, truncated: bool) -> Plan:
        """Stacked per-tile phases A+B over a dirty-tile stack
        (:func:`repro_torch.core.delta.phase_ab_stack`); ``n_stack`` is the
        power-of-two dirty bucket."""
        from repro_torch.core.delta import phase_ab_stack
        key = ("delta_ab", tuple(tile_shape), str(dtype), n_stack, tf, tk,
               truncated, self.config.plan_key())

        def build(plan: Plan):
            plan.traces += 1
            return functools.partial(
                phase_ab_stack, tile_max_features=tf,
                tile_max_candidates=tk, **self._stage_kwargs(dtype))

        return self.get_plan(key, build)

    def delta_merge_plan(self, shape, dtype, grid, n_stack: int, mf: int,
                         tf: int, tk: int, truncated: bool) -> Plan:
        """Scatter fresh dirty rows into the cached tile state and replay
        the seam merge (:func:`repro_torch.core.delta.scatter_merge`);
        returns ``(new_state, TiledDiagram)``."""
        from repro_torch.core.delta import scatter_merge
        key = ("delta_merge", tuple(shape), str(dtype), grid, n_stack, mf,
               tf, tk, truncated, self.config.plan_key())

        def build(plan: Plan):
            plan.traces += 1
            return functools.partial(
                scatter_merge, shape=tuple(shape), grid=grid,
                max_features=mf, tile_max_features=tf,
                tile_max_candidates=tk, **self._stage_kwargs(dtype),
                **self._merge_kwargs())

        return self.get_plan(key, build)

    def _resolve_grid(self, shape2d, dtype, spec: TileSpec
                      ) -> tuple[int, int]:
        """Tile grid for one image: the spec's explicit grid, else the
        autotuned grid (validated — a stale cache entry that no longer
        divides the shape is ignored), else ``choose_grid`` from the
        tile-pixel budget.  The winner lands in every tiled/delta plan
        key."""
        from repro_torch.core import tiling
        if spec.grid is not None:
            return tuple(spec.grid)
        tg = self._tuned_grid(shape2d, dtype)
        if tg is not None:
            try:
                tiling.validate_grid(tuple(shape2d), tg)
                return tg
            except ValueError:
                pass
        with telemetry.span("grid"):
            return tiling.choose_grid(tuple(shape2d), spec.max_tile_pixels)

    # -- capacity regrow ---------------------------------------------------

    def _ceilings(self, n: int) -> tuple[int, int]:
        cfg = self.config
        ceil_f = min(cfg.regrow_features_ceiling or n, n)
        ceil_c = min(cfg.regrow_candidates_ceiling or n, n)
        return ceil_f, ceil_c

    def initial_capacities(self, n: int) -> tuple[int, int]:
        """First-attempt capacities for an n-pixel image (clamped to n)."""
        return min(self.config.max_features, n), \
            min(self.config.max_candidates, n)

    def grow_capacities(self, mf: int, mc: int, n: int) -> tuple[int, int]:
        """One regrow step: both capacities grow by ``regrow_factor`` up to
        their ceilings (unchanged at the ceiling)."""
        ceil_f, ceil_c = self._ceilings(n)
        return min(mf * self.config.regrow_factor, ceil_f), \
            min(mc * self.config.regrow_factor, ceil_c)

    def begin_regrow(self, dispatch: Callable[[int, int], Any],
                     overflowed: Callable[[Any], bool], n: int, kind: str,
                     memo_key: tuple | None = None, stream: bool = False
                     ) -> tuple[Any, Callable[[], tuple[Any, RegrowStats]]]:
        """Dispatch at the memoized capacities and return ``(out,
        finish)``; ``finish()`` performs the overflow check and the
        regrow-and-replay loop, returning ``(out, RegrowStats)`` — the
        synchronous :meth:`run_with_regrow` is this plus an immediate
        ``finish()``, so both give the same bytes.

        With ``stream=True`` nothing is dispatched here and ``out`` is
        ``None``: the port's phases B and C read back to the host inside
        the computation, so a dispatch would block the calling thread.
        ``finish()`` dispatches and checks the overflow on the device, as
        the synchronous path does, then copies the last attempt's output
        to pinned host memory (:func:`repro_torch.ph.overlap.start_d2h`);
        its ``out`` is the host tree.

        ``memo_key`` makes grown capacities sticky: a later call for the
        same (kind, shape, dtype) starts at the largest capacity already
        discovered (a deferred dispatch reads the memo when it runs, so a
        round resolved after another starts at that round's capacities)."""
        cfg = self.config

        def start_capacities():
            mf0, mc0 = self.initial_capacities(n)
            if cfg.auto_regrow and memo_key is not None:
                with self._lock:
                    got = self._grown.get(memo_key)
                if got:
                    mf0 = max(mf0, min(got[0], n))
                    mc0 = max(mc0, min(got[1], n))
            return mf0, mc0

        caps0 = None if stream else start_capacities()
        out0 = None if stream else dispatch(*caps0)

        def finish():
            attempts = 0
            mf, mc = caps0 if caps0 is not None else start_capacities()
            out = out0 if out0 is not None else dispatch(mf, mc)
            over = overflowed(out)
            while over and cfg.auto_regrow and attempts < cfg.max_regrows:
                nmf, nmc = self.grow_capacities(mf, mc, n)
                if (nmf, nmc) == (mf, mc):
                    break   # at the ceiling: residual overflow is reported
                with self._lock:
                    self.regrow_log.append({"kind": kind, "from": (mf, mc),
                                            "to": (nmf, nmc)})
                mf, mc = nmf, nmc
                attempts += 1
                with telemetry.span("regrow"):
                    out = dispatch(mf, mc)
                over = overflowed(out)
            if attempts and memo_key is not None:
                with self._lock:
                    got = self._grown.get(memo_key)
                    if got is None or got < (mf, mc):
                        self._grown[memo_key] = (mf, mc)
            if stream:
                with telemetry.span("d2h"):
                    out = start_d2h(out, self.overlap_counters).result()
            return out, RegrowStats(attempts, mf, mc, bool(over))

        return out0, finish

    @staticmethod
    def overflowed(flag: torch.Tensor) -> bool:
        """An overflow flag read back to the host (an ``overflow_check``
        span, one readback)."""
        with telemetry.span("overflow_check"):
            telemetry.readback()
            return bool(flag)

    def run_with_regrow(self, dispatch: Callable[[int, int], Any],
                        overflowed: Callable[[Any], bool], n: int, kind: str,
                        memo_key: tuple | None = None
                        ) -> tuple[Any, RegrowStats]:
        """Dispatch, then regrow while overflow persists."""
        _, finish = self.begin_regrow(dispatch, overflowed, n, kind,
                                      memo_key=memo_key)
        return finish()

    # -- data prep ---------------------------------------------------------

    def cast_input_host(self, image) -> torch.Tensor:
        """The config's dtype policy applied on the host, as a CPU tensor:
        float64/int64 canonicalize to float32/int32 (as the reference does
        without 64-bit mode), then ``config.dtype`` applies.  Rejects
        non-finite pixels and dtypes the kernels do not take."""
        x = as_host_tensor(image)
        check_finite(x)
        dt = _CANONICAL.get(x.dtype, x.dtype)
        if self.config.dtype is not None:
            dt = _CONFIG_DTYPES[self.config.dtype]
        if dt not in SUPPORTED_DTYPES:
            raise TypeError(f"image dtype {x.dtype} is not supported; "
                            f"expected one of {SUPPORTED_DTYPES}")
        with telemetry.span("cast"):
            return x.to(dtype=dt)

    def cast_input(self, image) -> torch.Tensor:
        """:meth:`cast_input_host`, then onto the engine's device (a
        ``prep`` span; the copy is its ``upload``)."""
        with telemetry.span("prep"):
            x = self.cast_input_host(image)
            with telemetry.span("upload"):
                if x.device.type != self.device.type:
                    telemetry.readback(self.device)    # a pageable upload
                return x.to(self.device).contiguous()

    def auto_threshold(self, image) -> float | None:
        """The Variant-2 threshold ``config.filter_level`` implies for
        ``image`` (``None`` under VANILLA), from the astro statistic on the
        host.  A bfloat16 image stays a tensor, so its median is taken in
        bfloat16 arithmetic as the reference's numpy median is."""
        if self.config.filter_level is FilterLevel.VANILLA:
            return None
        from repro_torch.data import astro
        with telemetry.span("threshold"):
            x = as_host_tensor(image).detach()
            telemetry.readback(x.device)
            x = x.cpu()
            host = x if x.dtype == torch.bfloat16 else x.numpy()
            if self.config.filtration == "sublevel":
                t, _ = astro.filter_threshold(-host,
                                              self.config.filter_level)
                return None if t is None else -t
            t, _ = astro.filter_threshold(host, self.config.filter_level)
            return t

    # -- warm plan pool ----------------------------------------------------

    def warmup(self, bucket_shapes=None, *, batch_sizes=None, dtype=None,
               truncated: bool = True) -> dict:
        """Build the plans a steady-state request stream will hit and walk
        their regrow chains, so no request pays for either.

        ``bucket_shapes``: square sizes or ``(H, W)`` pairs; defaults to
        the config's ``serve.buckets``.  For every bucket a **worst-case
        dummy** goes through the normal dispatch-with-regrow path of the
        **single**-image plan (``run``'s memo key ``("single", (H, W),
        dtype)``) and of one **batched** plan per entry of ``batch_sizes``
        (default: ``serve.batch_cap``, the fixed dispatch batch the daemon
        pads every tick to; memo key ``("batched", (B, H, W), dtype)``).
        The batched dummy is staged through the engine's
        :class:`~repro_torch.ph.overlap.StagingPool` as a served batch is,
        so with donation steady state reuses the warmed slots.  The sticky
        regrow memo records the capacity tier each chain ends on; on the
        card the first dispatch also builds and loads the kernels'
        libraries, and the chain's last attempt leaves blocks of the
        tier's sizes in the caching allocator.  ``truncated`` warms the
        thresholded variants (what padded serving batches always run; the
        inert ±inf threshold keeps every pixel).  ``dtype``: a torch dtype
        or its name (default float32), before the config's dtype policy.

        Returns ``{"plans", "traces", "seconds"}`` — the *new* plans and
        plan builds this warmup added (a build is the port's trace).
        """
        spec = self.config.serve
        if bucket_shapes is None:
            if spec is None or spec.buckets is None:
                raise ValueError("warmup needs bucket_shapes (or a config "
                                 "serve spec with a fixed bucket set)")
            bucket_shapes = spec.buckets
        if batch_sizes is None:
            batch_sizes = (spec.batch_cap,) if spec is not None else ()
        if dtype is None:
            dtype = torch.float32
        elif not isinstance(dtype, torch.dtype):
            dtype = getattr(torch, str(dtype))
        sublevel = self.config.filtration == "sublevel"
        inert = math.inf if sublevel else -math.inf
        before = self.plan_stats()
        t0 = time.perf_counter()
        for shape in bucket_shapes:
            shape = (int(shape), int(shape)) if isinstance(shape, int) \
                else tuple(int(s) for s in shape)
            # Stride-2 peak grid: under 8-connectivity the local maxima of
            # an image form an independent set of the king graph, whose
            # maximum size is ceil(h/2)*ceil(w/2) — exactly the peaks
            # planted here (distinct heights, so no plateau merges them).
            # No real image of this bucket produces more features, so the
            # tier found here bounds the tier any steady dispatch needs.
            dummy = torch.zeros(shape, dtype=dtype)
            peaks = dummy[::2, ::2]
            peaks.copy_(1 + torch.arange(peaks.numel()).reshape(peaks.shape))
            if sublevel:
                # The same worst case mirrored: the planted extrema must be
                # the filtration's feature points (local minima).
                dummy = -dummy
            host = self.cast_input_host(dummy)
            telemetry.readback(self.device)     # a pageable upload
            self._run_single(host.to(self.device),
                             inert if truncated else None)
            for b in batch_sizes:
                self._warm_batched(host, int(b), inert, truncated)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        after = self.plan_stats()
        return {"plans": after["plans"] - before["plans"],
                "traces": after["traces"] - before["traces"],
                "seconds": round(time.perf_counter() - t0, 4)}

    def _warm_batched(self, host: torch.Tensor, b: int, inert: float,
                      truncated: bool) -> None:
        """A served batch's dispatch: ``b`` copies of ``host`` staged in a
        pool slot, uploaded and run through :meth:`_begin_batch`."""
        shape, dtype = (b, *host.shape), host.dtype
        slot = self.staging.acquire((self.device,), shape, dtype,
                                    threshold_dtype(dtype))
        slot.host_batch.copy_(host.expand(shape))
        slot.host_tvals.fill_(inert)
        self._begin_batch(shape, dtype, truncated,
                          self.staging.upload(slot))()

    # -- public entry points ----------------------------------------------

    @telemetry.entry
    def run(self, image, truncate_value: float | None = None) -> PHResult:
        """0-dim PH of one 2D image with auto-regrow.

        ``truncate_value`` overrides the config's ``filter_level``; with the
        default ``None`` the threshold comes from ``config.filter_level``.
        """
        x = self.cast_input(image)
        if x.dim() != 2:
            raise ValueError(f"expected 2D image, got shape {tuple(x.shape)}")
        if truncate_value is None:
            truncate_value = self.auto_threshold(image)
        return self._run_single(x, truncate_value)

    def _run_single(self, x: torch.Tensor, truncate_value) -> PHResult:
        """:meth:`run` of a cast 2D image on the device at an explicit
        threshold (``None``: untruncated)."""
        truncated = truncate_value is not None
        shape, dtype = tuple(x.shape), x.dtype
        tv = self._threshold_tensor(truncate_value, dtype)

        def dispatch(mf, mc):
            plan = self._local_plan("single", shape, dtype, mf, mc,
                                    truncated)
            return plan(x, tv) if truncated else plan(x)

        diag, stats = self.run_with_regrow(
            dispatch, lambda d: self.overflowed(d.overflow), x.numel(),
            "single",
            memo_key=("single", shape, str(dtype)))
        return PHResult(diag, self.config.replace(
            max_features=stats.final_max_features,
            max_candidates=stats.final_max_candidates), stats,
            truncate_value)

    def _dedupe_batch(self, images, truncate_values):
        """Content-hash duplicate detection for :meth:`run_batch`.

        Returns ``None`` when dedupe cannot help (fewer than two images,
        rows that are not 2D, or no duplicates); otherwise ``(reps,
        inverse, rep_images, rep_tvs)``: ``reps`` indexes the first
        occurrence of each distinct ``(shape, dtype, bytes, threshold)``
        (blake2b over the host bytes) and ``inverse[i]`` maps row ``i`` to
        its representative's rank.
        """
        if _is_array(images):
            if images.ndim != 3 or images.shape[0] < 2:
                return None
            seq = [images[i] for i in range(images.shape[0])]
        else:
            seq = list(images)
            if len(seq) < 2 or any(len(_shape(im)) != 2 for im in seq):
                return None
        if truncate_values is None:
            tvs = [None] * len(seq)
        elif np.isscalar(truncate_values):
            tvs = [float(truncate_values)] * len(seq)
        else:
            tvs = list(np.asarray(truncate_values, object))
            if len(tvs) != len(seq):
                return None   # let the dispatch path raise its own error
        first: dict = {}
        reps: list[int] = []
        inverse = np.empty(len(seq), np.int64)
        for i, (im, t) in enumerate(zip(seq, tvs)):
            x = as_host_tensor(im).detach()
            telemetry.readback(x.device)
            x = x.cpu().contiguous()
            raw = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
            digest = hashlib.blake2b(raw.numpy().tobytes(),
                                     digest_size=16).digest()
            key = (tuple(x.shape), str(x.dtype), digest,
                   None if t is None else float(t))
            got = first.get(key)
            if got is None:
                first[key] = got = len(reps)
                reps.append(i)
            inverse[i] = got
        if len(reps) == len(seq):
            return None
        rep_tvs = None if truncate_values is None \
            else [tvs[i] for i in reps]
        return reps, inverse, [seq[i] for i in reps], rep_tvs

    @telemetry.entry
    def run_batch(self, images, truncate_values=None, *,
                  bucket: tuple[int, int] | None = None,
                  dedupe: bool = True) -> PHResult:
        """PH over an image batch, regrowing on *any* overflow.

        ``images``: a ``(B, H, W)`` array or tensor (one dispatch as it
        is), or a sequence of 2D images whose shapes may be **mixed**.
        Mixed shapes are padded to one shape bucket — ``bucket``, or the
        elementwise maximum of each image's
        :func:`repro_torch.pipeline.scheduler.bucket_shape` under
        ``config.bucket_rounding`` — with the inert fill, staged on the
        host and uploaded once; each row is then repaired
        (:mod:`repro_torch.pipeline.padding`), so every row equals
        :meth:`run` on that image alone at the same capacities.  ``bucket``
        also forces a uniform batch into a fixed padded shape.

        ``truncate_values``: optional per-image thresholds ((B,) array or
        sequence; ``None`` entries derive from ``config.filter_level``).
        Padded rows always run thresholded; without any threshold the
        image minimum stands in (exact: it keeps every real pixel and
        drops every pad pixel).

        ``dedupe`` (default on): exact content duplicates — same bytes,
        shape, dtype and threshold — compute once; their rows are
        gathered to every requesting position on the result's device.

        This is :meth:`run_batch_async` resolved at once.
        """
        return self.run_batch_async(images, truncate_values, bucket=bucket,
                                    dedupe=dedupe).resolve()

    @telemetry.entry
    def run_batch_async(self, images, truncate_values=None, *,
                        bucket: tuple[int, int] | None = None,
                        dedupe: bool = True) -> PendingResult:
        """Non-blocking :meth:`run_batch`: ``resolve()`` on the returned
        :class:`repro_torch.ph.overlap.PendingResult` gives exactly
        :meth:`run_batch`'s ``PHResult``.

        Host images are cast and padded on the host into a staging slot
        and uploaded with one non-blocking copy group (a tensor already on
        the engine's device is used as it is, never donated).  With
        ``overlap.async_overflow`` nothing else happens before
        ``resolve()``: the computation, the overflow check, the regrow and
        the pad repair run there, and the diagram comes back in pinned
        host memory.  Without it the computation runs here and
        ``resolve()`` finishes the overflow check and the repair.
        """
        if dedupe:
            with telemetry.span("dedupe"):
                plan = self._dedupe_batch(images, truncate_values)
            if plan is not None:
                _, inverse, rep_images, rep_tvs = plan
                pending = self.run_batch_async(rep_images, rep_tvs,
                                               bucket=bucket, dedupe=False)

                def fanout():
                    res = pending.resolve()
                    inv = torch.as_tensor(inverse,
                                          device=res.diagram.birth.device)
                    diag = Diagram(*(f[inv] for f in res.diagram))
                    thr = res.threshold
                    if thr is not None and not np.isscalar(thr):
                        thr = np.asarray(thr)[inverse]
                    return dataclasses.replace(res, diagram=diag,
                                               threshold=thr)

                return PendingResult(fanout)
        if _is_array(images) and images.ndim == 3 and (
                bucket is None or tuple(bucket) == tuple(images.shape[1:])):
            return self._run_batch_uniform(images, truncate_values)
        seq = [images[i] for i in range(images.shape[0])] \
            if _is_array(images) else list(images)
        if not seq:
            raise ValueError("run_batch needs at least one image")
        shapes = {_shape(im) for im in seq}
        if any(len(sh) != 2 for sh in shapes):
            raise ValueError(f"expected a (B, H, W) batch or a sequence of "
                             f"2D images, got shapes {sorted(shapes)}")
        if bucket is None and len(shapes) == 1:
            return self._run_batch_uniform(
                torch.stack([as_host_tensor(im) for im in seq]),
                truncate_values)
        return self._run_batch_bucketed(seq, truncate_values, bucket)

    def _begin_batch(self, shape, dtype, truncated: bool, slot, x=None,
                     tvals=None):
        """Dispatch a ``(B, H, W)`` batch through the regrow loop: from a
        staging slot (released once the last attempt is enqueued), or from
        ``x``/``tvals`` already on the device.  Returns ``finish()``."""
        stream = self._stream_results()

        def dispatch(mf, mc):
            xs, tvs = slot.ready() if slot is not None else ([x], [tvals])
            plan = self._local_plan("batched", shape, dtype, mf, mc,
                                    truncated)
            return plan(xs[0], tvs[0]) if truncated else plan(xs[0])

        _, finish = self.begin_regrow(
            dispatch, lambda d: self.overflowed(d.overflow.any()),
            shape[1] * shape[2], "batched",
            memo_key=("batched", tuple(shape), str(dtype)), stream=stream)

        def done():
            out = finish()
            if slot is not None:
                self.staging.release(slot)
            return out

        return done

    def _run_batch_uniform(self, images, truncate_values=None
                           ) -> PendingResult:
        """One ``(B, H, W)`` dispatch at the batch's own shape."""
        on_device = isinstance(images, torch.Tensor) and \
            canonical_device(images.device) == canonical_device(self.device)
        if on_device:
            x = self.cast_input(images)
        else:
            with telemetry.span("prep"):
                x = self.cast_input_host(images)
        if x.dim() != 3:
            raise ValueError(f"expected (B, H, W) batch, got shape "
                             f"{tuple(x.shape)}")
        if truncate_values is None and \
                self.config.filter_level is not FilterLevel.VANILLA:
            src = as_host_tensor(images)
            truncate_values = np.asarray(
                [self.auto_threshold(src[i]) for i in range(src.shape[0])],
                np.float32)
        truncated = truncate_values is not None
        shape, dtype = tuple(x.shape), x.dtype
        if on_device:
            tv = None
            if truncated:
                with telemetry.span("threshold"):
                    telemetry.readback(self.device)   # a pageable upload
                    tv = torch.as_tensor(np.asarray(truncate_values),
                                         device=self.device).to(
                        threshold_dtype(dtype))
            finish = self._begin_batch(shape, dtype, truncated, None, x, tv)
        else:       # an engine-owned copy in a staging slot, uploaded
            with telemetry.span("prep"):
                slot = self.staging.acquire((self.device,), shape, dtype,
                                            threshold_dtype(dtype))
                with telemetry.span("stage"):
                    slot.host_batch.copy_(x)
                    if truncated:
                        slot.host_tvals.copy_(torch.as_tensor(np.asarray(
                            truncate_values)).to(slot.host_tvals.dtype))
                slot = self.staging.upload(slot)
            finish = self._begin_batch(shape, dtype, truncated, slot)

        def materialize():
            diag, stats = finish()
            return PHResult(diag, self.config.replace(
                max_features=stats.final_max_features,
                max_candidates=stats.final_max_candidates), stats,
                truncate_values)

        return PendingResult(materialize)

    def _run_batch_bucketed(self, seq, truncate_values,
                            bucket: tuple[int, int] | None
                            ) -> PendingResult:
        """Mixed-shape batch through one shape-bucketed padded dispatch:
        host cast and padding into a staging slot, one upload, regrow,
        per-row repair at ``resolve()``."""
        from repro_torch.pipeline.padding import (pad_fixup, pad_image,
                                                  pad_threshold,
                                                  unpad_diagram)
        from repro_torch.pipeline.scheduler import bucket_shape
        with telemetry.span("prep"):
            imgs = []
            for im in seq:
                x = self.cast_input_host(im)
                telemetry.readback(x.device)
                imgs.append(x.cpu())
            if bucket is None:
                per = [bucket_shape(tuple(im.shape),
                                    self.config.bucket_rounding)
                       for im in imgs]
                bucket = (max(s[0] for s in per), max(s[1] for s in per))
            bucket = (int(bucket[0]), int(bucket[1]))
            if truncate_values is None:
                tvs: list = [None] * len(imgs)
            elif np.isscalar(truncate_values):
                tvs = [float(truncate_values)] * len(imgs)
            else:
                tvs = [None if t is None or not np.isfinite(t) else float(t)
                       for t in np.asarray(truncate_values, object).tolist()]
            if len(tvs) != len(imgs):
                raise ValueError(f"{len(tvs)} thresholds for {len(imgs)} "
                                 f"images")

            filt = self.config.filtration
            inert = math.inf if filt == "sublevel" else -math.inf
            dtype = imgs[0].dtype
            shape = (len(imgs), *bucket)
            slot = self.staging.acquire((self.device,), shape, dtype,
                                        threshold_dtype(dtype))
            tvals = np.empty((len(imgs),), np.float64)
            fixups: list = [None] * len(imgs)
            for i, im in enumerate(imgs):
                if im.dtype != dtype:
                    raise ValueError(f"mixed dtypes in one batch: {im.dtype} "
                                     f"vs {dtype}")
                t = tvs[i] if tvs[i] is not None else self.auto_threshold(im)
                if tuple(im.shape) != bucket:
                    t = pad_threshold(im, t, filt)
                    fixups[i] = pad_fixup(im, filt)
                slot.host_batch[i] = pad_image(im, bucket, filt)
                tvals[i] = inert if t is None else t
            slot.host_tvals.copy_(torch.as_tensor(tvals).to(
                slot.host_tvals.dtype))
            slot = self.staging.upload(slot)
        finish = self._begin_batch(shape, dtype, True, slot)

        def materialize():
            diag, stats = finish()
            rows = []
            with telemetry.span("repair"):
                for i in range(len(imgs)):
                    d = Diagram(*(f[i] for f in diag))
                    if fixups[i] is not None:
                        d = unpad_diagram(d, fixups[i], bucket)
                    rows.append(d)
            return PHResult(stack_diagrams(rows), self.config.replace(
                max_features=stats.final_max_features,
                max_candidates=stats.final_max_candidates), stats, tvals)

        return PendingResult(materialize)

    def num_candidates(self, image, truncate_value=None) -> int:
        """Count death-point candidates under this engine's config (for
        sizing ``max_candidates`` before a run)."""
        cfg = self.config
        x = self.cast_input(image)
        if truncate_value is None:
            truncate_value = self.auto_threshold(image)
        return core_num_candidates(
            x, cfg.candidate_mode, truncate_value, use_pallas=cfg.use_pallas,
            phase_a_impl=cfg.phase_a_impl, strip_rows=cfg.strip_rows,
            merge_keys=cfg.merge_keys, filtration=cfg.filtration)

    # -- halo-tiled path ----------------------------------------------------

    def _tile_spec(self) -> TileSpec:
        return self.config.tile if self.config.tile is not None \
            else TileSpec()

    def should_tile(self, n_pixels: int) -> bool:
        """True when the config routes an ``n_pixels`` image through the
        tiled path (``tile`` configured and the image exceeds its
        ``max_tile_pixels`` budget)."""
        t = self.config.tile
        return t is not None and n_pixels > t.max_tile_pixels

    def provider_threshold(self, provider):
        """Variant-2 threshold for a tile provider, consistent across every
        streaming entry point: the provider's estimate with its sample
        budget tied to the tile budget (O(tile) residency).  ``None``
        under VANILLA."""
        cfg = self.config
        if cfg.filter_level is FilterLevel.VANILLA:
            return None
        if cfg.filtration == "sublevel":
            raise ValueError(
                "filter_level-derived thresholds for tile providers are "
                "superlevel statistics; under filtration='sublevel' pass "
                "an explicit truncate_value (or use FilterLevel.VANILLA)")
        if not hasattr(provider, "filter_threshold"):
            raise ValueError(
                f"filter_level={cfg.filter_level} needs a threshold, but "
                f"the tile provider has no filter_threshold(); pass "
                f"truncate_value")
        sample = math.isqrt(self._tile_spec().max_tile_pixels)
        try:
            return provider.filter_threshold(cfg.filter_level,
                                             sample=sample)
        except TypeError:   # provider without a sample knob
            return provider.filter_threshold(cfg.filter_level)

    def _check_ctx(self, ctx) -> None:
        """A tiled run under a :class:`DistContext` runs on the context's
        first device, which must be the engine's: tile rows that span
        several devices are not ported (ROADMAP.md, queue 1 item 1a)."""
        if ctx is not None and ctx.devices[0] != canonical_device(
                self.device):
            raise ValueError(f"context device {ctx.devices[0]} is not the "
                             f"engine's device {self.device}")

    def stage_tiles(self, provider, *, grid=None, ctx=None):
        """Stage a tile provider's halo-padded tiles on the engine's device
        (O(tile) host residency), choosing the grid from the config's
        :class:`TileSpec` when not given.  The returned
        :class:`repro_torch.core.tiling.StagedTiles` feeds
        :meth:`run_tiled` — the half the pipeline's loader thread runs
        ahead.  ``ctx``: see :meth:`run_tiled`."""
        from repro_torch.core import tiling
        self._check_ctx(ctx)
        if grid is None:
            dtype = self.config.dtype if self.config.dtype is not None \
                else np.dtype(provider.dtype).name
            grid = self._resolve_grid(tuple(provider.shape), dtype,
                                      self._tile_spec())
        # Halo fill is the user-space inert extreme of the filtration.
        fill = math.inf if self.config.filtration == "sublevel" else None
        return tiling.load_tile_stacks(provider, tuple(grid), fill=fill,
                                       device=self.device)

    def _tiled_source(self, image, truncate_value, grid, *, upload: bool):
        """Resolve a tiled entry point's input: a :class:`StagedTiles`
        (staged from a tile provider if need be), or the cast image
        (uploaded when ``upload``, else left on the host).  Returns
        ``(source, shape, grid, dtype, truncate_value)``."""
        from repro_torch.core import tiling
        cfg = self.config
        staged = image if isinstance(image, tiling.StagedTiles) else None
        if staged is None and hasattr(image, "halo_tile"):
            if truncate_value is None:
                with telemetry.span("threshold"):
                    truncate_value = self.provider_threshold(image)
            with telemetry.span("prep"), telemetry.span("stage"):
                staged = self.stage_tiles(image, grid=grid)
        if staged is not None:
            if cfg.dtype is not None:       # apply the config dtype policy
                staged = dataclasses.replace(staged, pvals=staged.pvals.to(
                    _CONFIG_DTYPES[cfg.dtype]))
            if grid is not None and tuple(grid) != tuple(staged.grid):
                raise ValueError(f"grid={tuple(grid)} does not match the "
                                 f"staged tiles' grid {staged.grid}")
            source, shape = staged, tuple(staged.shape)
            grid, dtype = tuple(staged.grid), staged.pvals.dtype
        else:
            if upload:
                source = self.cast_input(image)
            else:
                with telemetry.span("prep"):
                    source = self.cast_input_host(image)
            if source.dim() != 2:
                raise ValueError(f"expected 2D image, got shape "
                                 f"{tuple(source.shape)}")
            if truncate_value is None:
                truncate_value = self.auto_threshold(image)
            shape, dtype = tuple(source.shape), source.dtype
            if grid is None:
                grid = self._resolve_grid(shape, dtype, self._tile_spec())
        grid = tuple(grid)
        tiling.validate_grid(shape, grid)
        return source, shape, grid, dtype, truncate_value

    def _tiled_capacities(self, shape, grid, dtype):
        """First-attempt ``(max_features, tile features, tile candidates)``
        (clamped to the pixel counts, raised to the sticky memo) and the
        memo key, which run_tiled and run_delta share."""
        cfg, spec = self.config, self._tile_spec()
        n = shape[0] * shape[1]
        tile_n = (shape[0] // grid[0]) * (shape[1] // grid[1])
        caps = (min(cfg.max_features, n),
                min(spec.max_features_per_tile, tile_n),
                min(spec.max_candidates_per_tile, tile_n))
        memo_key = ("tiled", tuple(shape), grid, str(dtype))
        if cfg.auto_regrow:
            with self._lock:
                got = self._grown.get(memo_key)
            if got:
                caps = tuple(max(c, min(g, lim)) for c, g, lim in
                             zip(caps, got, (n, tile_n, tile_n)))
        return caps, memo_key

    def _grow_tiled(self, caps, shape, grid, out, kind: str):
        """One regrow step per overflowing level — the tile capacities on
        tile overflow, ``max_features`` on merge overflow, each up to its
        own ceiling — or ``None`` when nothing may grow."""
        cfg = self.config
        tile_of = self.overflowed(out.tile_overflow)
        merge_of = self.overflowed(out.merge_overflow)
        if not (tile_of or merge_of) or not cfg.auto_regrow:
            return None
        n = shape[0] * shape[1]
        tile_n = (shape[0] // grid[0]) * (shape[1] // grid[1])
        ceil_mf, _ = self._ceilings(n)
        ceil_tf, ceil_tk = self._ceilings(tile_n)
        mf, tf, tk = caps
        fac = cfg.regrow_factor
        new = (min(mf * fac, ceil_mf) if merge_of else mf,
               min(tf * fac, ceil_tf) if tile_of else tf,
               min(tk * fac, ceil_tk) if tile_of else tk)
        if new == tuple(caps):
            return None   # at the ceilings: residual overflow is reported
        with self._lock:
            self.regrow_log.append({"kind": kind, "from": tuple(caps),
                                    "to": new})
        return new

    def _remember(self, memo_key, caps) -> None:
        with self._lock:
            got = self._grown.get(memo_key)
            if got is None or got < caps:
                self._grown[memo_key] = caps

    def _tiled_result(self, out, caps, attempts: int, grid, truncate_value,
                      delta=None) -> PHResult:
        mf, tf, tk = caps
        # final_max_candidates reports the per-tile candidate capacity
        # (the knob that regrows on the tiled path).
        stats = RegrowStats(attempts, mf, tk,
                            self.overflowed(out.tile_overflow)
                            or self.overflowed(out.merge_overflow))
        eff = self.config.replace(
            max_features=mf,
            tile=self._tile_spec().replace(
                grid=grid, max_features_per_tile=tf,
                max_candidates_per_tile=tk))
        return PHResult(out.diagram, eff, stats, truncate_value, delta)

    def _streamed(self, out):
        """A tiled run's last output copied to pinned host memory under
        ``overlap.async_overflow``, else ``out`` as it is."""
        if not self._stream_results():
            return out
        with telemetry.span("d2h"):
            return start_d2h(out, self.overlap_counters).result()

    def _threshold_tensor(self, truncate_value, dtype):
        """The threshold as a 0-d tensor on the engine's device (a
        ``threshold`` span); ``None`` without one."""
        if truncate_value is None:
            return None
        with telemetry.span("threshold"):
            telemetry.readback(self.device)     # a pageable upload
            return torch.tensor(truncate_value, dtype=threshold_dtype(dtype),
                                device=self.device)

    @telemetry.entry
    def run_tiled(self, image, truncate_value=None, *, grid=None,
                  ctx=None) -> PHResult:
        """Halo-tiled PH of one (possibly device-exceeding) 2D image.

        ``image`` is a host 2D array or tensor, a **tile provider**
        (``shape`` / ``dtype`` / ``halo_tile(t, grid, fill=...)``, e.g.
        :class:`repro_torch.data.astro.AstroImage`: tiles are generated
        and staged one at a time, and the threshold comes from
        :meth:`provider_threshold`), or a
        :class:`repro_torch.core.tiling.StagedTiles` from
        :meth:`stage_tiles` (pass the threshold: there is no image to
        derive it from).  Bit-identical to :meth:`run` with
        ``candidate_mode="exact"``.  ``grid`` overrides the config's
        :class:`TileSpec` grid (chosen from ``max_tile_pixels`` when both
        are None).  Overflow regrows per level: tile capacities toward the
        tile pixel count on tile overflow, ``max_features`` toward the
        image pixel count on seam-merge overflow; the result is memoized
        per ``("tiled", shape, grid, dtype)``.  ``ctx`` (the pipeline's
        :class:`repro_torch.distributed.context.DistContext`) runs the
        tiles on its first device, the engine's.  With
        ``overlap.async_overflow`` the last attempt's output streams to
        pinned host memory and the diagram comes back there.
        """
        from repro_torch.core.tiling import StagedTiles
        cfg = self.config
        if cfg.candidate_mode != "exact":
            raise ValueError("run_tiled supports candidate_mode='exact' "
                             "only (the paper-literal distillation has no "
                             "tiled equivalence proof)")
        self._check_ctx(ctx)
        source, shape, grid, dtype, truncate_value = self._tiled_source(
            image, truncate_value, grid, upload=True)
        truncated = truncate_value is not None
        tv = self._threshold_tensor(truncate_value, dtype)
        caps, memo_key = self._tiled_capacities(shape, grid, dtype)

        def dispatch(caps):
            if isinstance(source, StagedTiles):
                plan = self.tiled_stacks_plan(shape, dtype, grid, *caps,
                                              truncated)
                return plan(source.pvals, source.pgidx, tv)
            plan = self.tiled_plan(shape, dtype, grid, *caps, truncated)
            return plan(source, tv)

        attempts, out = 0, dispatch(caps)
        while attempts < cfg.max_regrows:
            new = self._grow_tiled(caps, shape, grid, out, "tiled")
            if new is None:
                break
            caps, attempts = new, attempts + 1
            with telemetry.span("regrow"):
                out = dispatch(caps)
        if attempts:
            self._remember(memo_key, caps)
        return self._tiled_result(self._streamed(out), caps, attempts, grid,
                                  truncate_value)

    @telemetry.entry
    def run_delta(self, image, truncate_value=None, *, grid=None
                  ) -> PHResult:
        """Delta-recompute tiled PH of one frame against the engine's frame
        store — **bit-identical** to :meth:`run_tiled` on the same frame,
        at O(changed area) compute for near-duplicate frames.

        ``image`` takes the forms :meth:`run_tiled` takes.  The frame's
        per-tile content-hash grid
        (:func:`repro_torch.core.delta.frame_digests`) is classified
        against the :class:`repro_torch.cache.DiagramCache`:

        * **full hit** — the cached :class:`PHResult` returns without
          touching the device;
        * **partial hit** — phases A+B re-run for the dirty tiles only,
          the fresh rows are scattered into a copy of the cached
          :class:`TileBoundaryState`, and the seam merge replays;
        * **miss** — every tile is dirty and the same scatter runs against
          an all-zeros base, so cold and warm paths share one program.

        With ``config.delta`` absent or disabled this is :meth:`run_tiled`
        with ``delta.hit == "cold"``.  ``PHResult.delta`` carries a
        :class:`repro_torch.core.delta.DeltaStats`.  Regrow mirrors
        :meth:`run_tiled` and shares its memo; a tile-capacity regrow
        invalidates the cached state (its arrays are capacity-shaped), a
        merge-only regrow keeps the fresh rows and replays only the merge.
        Under ``overlap.async_overflow`` the diagram streams to pinned host
        memory, as in :meth:`run_tiled`.
        """
        from repro_torch.cache import DiagramCache, FrameCacheEntry
        from repro_torch.core import delta as delta_mod
        cfg = self.config
        dspec = cfg.delta
        if dspec is None or not dspec.enabled:
            res = self.run_tiled(image, truncate_value, grid=grid)
            n_t = int(np.prod(res.config.tile.grid))
            return dataclasses.replace(
                res, delta=delta_mod.DeltaStats(n_t, n_t, "cold"))
        if cfg.candidate_mode != "exact":
            raise ValueError("run_delta supports candidate_mode='exact' "
                             "only (it rides the tiled path)")
        # A host frame stays on the host: hashing and the dirty windows
        # never bounce through device memory.
        source, shape, grid, dtype, truncate_value = self._tiled_source(
            image, truncate_value, grid, upload=False)
        n_tiles = grid[0] * grid[1]
        tile_shape = (shape[0] // grid[0] + 2, shape[1] // grid[1] + 2)
        truncated = truncate_value is not None
        tv = self._threshold_tensor(truncate_value, dtype)
        tv_key = float(truncate_value) if truncated else None

        digests, raw = delta_mod.frame_digests(
            source, grid, algo=dspec.hash_algo, with_bytes=dspec.verify,
            filtration=cfg.filtration)
        # Everything that must match for a cached state row to be
        # bit-reusable (threshold included: it filters inside phase B).
        context = (tuple(shape), grid, str(dtype), dspec.hash_algo, tv_key,
                   cfg.plan_key())
        with self._lock:
            if self._delta_cache is None:
                self._delta_cache = DiagramCache(dspec.cache_entries)
            cache = self._delta_cache

        caps, memo_key = self._tiled_capacities(shape, grid, dtype)
        with telemetry.span("delta.lookup"):
            kind, entry, dirty_mask = cache.lookup(
                context, digests, capacities=caps, tile_bytes=raw)
        if kind == "hit":
            telemetry.count("delta_full")
            return dataclasses.replace(
                entry.result,
                delta=delta_mod.DeltaStats(n_tiles, 0, "full"))
        if kind == "partial":
            dirty, base = np.flatnonzero(dirty_mask), entry.state
        else:
            dirty, base = np.arange(n_tiles), None

        fresh = slots = None

        def attempt():
            nonlocal base, fresh, slots
            mf, tf, tk = caps
            bucket = delta_mod.dirty_bucket(len(dirty), n_tiles)
            if base is None:
                base = delta_mod.empty_state(shape, grid, dtype, tf, tk,
                                             device=self.device)
            if fresh is None:
                pv, pg, slots = delta_mod.dirty_stacks(
                    source, grid, dirty, bucket, cfg.filtration,
                    device=self.device)
                telemetry.count("delta_dirty_tiles", len(dirty))
                ab = self.delta_ab_plan(tile_shape, dtype, bucket, tf, tk,
                                        truncated)
                fresh = ab(pv, pg, tv)
            mg = self.delta_merge_plan(shape, dtype, grid, bucket, mf, tf,
                                       tk, truncated)
            return mg(base, fresh, slots, tv)

        attempts = 0
        new_state, out = attempt()
        while attempts < cfg.max_regrows:
            new = self._grow_tiled(caps, shape, grid, out, "delta")
            if new is None:
                break
            if new[1:] != caps[1:]:
                # Tile capacities grew: the cached and fresh state arrays
                # are the wrong shape — recompute every tile.
                dirty, base, fresh, kind = np.arange(n_tiles), None, None, \
                    "miss"
            caps, attempts = new, attempts + 1
            with telemetry.span("regrow"):
                new_state, out = attempt()
        if attempts:
            self._remember(memo_key, caps)

        hit = "partial" if kind == "partial" else "miss"
        telemetry.count(f"delta_{hit}")
        dstats = delta_mod.DeltaStats(n_tiles, int(len(np.unique(dirty))),
                                      hit)
        result = self._tiled_result(self._streamed(out), caps, attempts,
                                    grid, truncate_value, dstats)
        # put() on an existing (context, digests) key replaces in place.
        with telemetry.span("delta.lookup"):
            cache.put(context, FrameCacheEntry(
                digests=digests, state=new_state, result=result,
                capacities=caps, tile_bytes=raw))
        return result

    def run_sequence(self, frames, truncate_values=None, *, grid=None):
        """Generator: :meth:`run_delta` over an iterable of frames (the
        survey-stream entry point).  ``truncate_values`` is a scalar for
        every frame or a per-frame sequence; yields one :class:`PHResult`
        per frame as it completes."""
        for i, frame in enumerate(frames):
            if truncate_values is None:
                tv = None
            elif np.isscalar(truncate_values):
                tv = truncate_values
            else:
                tv = truncate_values[i]
            yield self.run_delta(frame, tv, grid=grid)

    def delta_cache_stats(self) -> dict:
        """Snapshot of the delta frame store's counters (zeros before the
        first ``run_delta`` call)."""
        from repro_torch.cache import CacheStats
        with self._lock:
            cache = self._delta_cache
        return (CacheStats() if cache is None else cache.stats).snapshot()

    # -- diagram distances -------------------------------------------------

    def _stack_diagrams(self, diagrams):
        """Distance inputs as ``(birth, death, p_birth)`` stacks of one
        common capacity on the engine's device.

        Accepts a batched :class:`PHResult`/:class:`Diagram` (2D fields,
        from :meth:`run_batch`), a sequence of results/diagrams (1D or 2D
        fields, capacities may differ — shorter rows gain pad rows, which
        the distances treat as diagonal points, i.e. nothing), or a
        ``(birth, death, p_birth)`` triple of arrays or tensors.  NaN
        births/deaths are rejected (the ±inf pad sentinels are allowed).
        """
        def dev(a):
            t = as_host_tensor(a)
            if t.device.type != self.device.type:
                telemetry.readback(self.device)     # a pageable upload
            return t.to(self.device)

        if isinstance(diagrams, tuple) and len(diagrams) == 3 \
                and not isinstance(diagrams[0], (PHResult, Diagram)):
            birth, death, p_birth = (dev(a) for a in diagrams)
        else:
            if isinstance(diagrams, (PHResult, Diagram)):
                diagrams = [diagrams]
            ds = [r.diagram if isinstance(r, PHResult) else r
                  for r in diagrams]
            if not ds:
                raise ValueError("distance_matrix needs at least one "
                                 "diagram")
            rows = []
            for d in ds:
                b, de, pb = (torch.atleast_2d(dev(a))
                             for a in (d.birth, d.death, d.p_birth))
                rows.extend((b[i], de[i], pb[i]) for i in range(b.shape[0]))
            f = max(r[0].shape[0] for r in rows)

            def grow(a, fill, dt):
                out = torch.full((f,), fill, dtype=dt, device=self.device)
                out[:a.shape[0]] = a
                return out

            birth = torch.stack([grow(b, 0, b.dtype) for b, _, _ in rows])
            death = torch.stack([grow(d, 0, d.dtype) for _, d, _ in rows])
            p_birth = torch.stack([grow(p, -1, torch.int32)
                                   for _, _, p in rows])
        if birth.dim() != 2:
            raise ValueError(f"expected stacked (B, F) diagrams, got "
                             f"shape {tuple(birth.shape)}")
        check_finite(birth, where="diagram births", allow_inf=True)
        check_finite(death, where="diagram deaths", allow_inf=True)
        return birth, death, p_birth.to(torch.int32)

    def distance_plan(self, b: int, f: int, dtype, n_dirs: int) -> Plan:
        """Plan for the ``(B, F)`` diagram-distance matrix — its own cached
        kind.  The key carries the kernel toggle and the resolved key
        encoding (the profile selection primitive differs)."""
        cfg = self.config
        mk = resolve_merge_keys(cfg.merge_keys, dtype)
        key = ("distance", b, f, str(dtype), n_dirs, mk, cfg.use_pallas)

        def build(plan: Plan):
            from repro_torch.kernels.ph_distance import diagram_distances
            plan.traces += 1
            return functools.partial(
                diagram_distances, n_dirs=n_dirs, merge_keys=mk,
                width=cfg.tournament_width, use_pallas=cfg.use_pallas)

        return self.get_plan(key, build)

    @telemetry.entry
    def distance_matrix(self, diagrams, *, n_dirs: int = 16):
        """Pairwise distance matrices of a batch of diagrams.

        ``diagrams``: anything :meth:`_stack_diagrams` accepts.  Returns
        ``(sw, bottleneck)``, both (B, B) float32 tensors on the engine's
        device: the sliced-Wasserstein distance and the bottleneck lower
        bound (definitions in :mod:`repro_torch.kernels.ph_distance.ref`).

        Diagrams are taken in ``config.filtration``'s convention; both
        distances are invariant under negating every diagram, so sublevel
        diagrams are negated into the superlevel space first.  Values are
        computed in float32, the dtype the reference's cast resolves to
        for every image dtype.
        """
        birth, death, p_birth = self._stack_diagrams(diagrams)
        if self.config.filtration == "sublevel":
            birth, death = -birth, -death
        birth = birth.to(torch.float32)
        death = death.to(torch.float32)
        plan = self.distance_plan(birth.shape[0], birth.shape[1],
                                  torch.float32, int(n_dirs))
        return plan(birth, death, p_birth)

    # -- the distributed pipeline -------------------------------------------

    @telemetry.entry
    def run_distributed(self, images, *, ctx=None, image_size: int = 512,
                        strategy: str = "part_LPT", work_log=None,
                        failure_injector=None, max_retries: int = 3,
                        verbose: bool = False):
        """The paper's end-to-end distributed job, engine-owned.

        Builds a :class:`repro_torch.pipeline.executor.ShardedPHExecutor`
        over ``ctx`` (default: one executor on the engine's device; more
        devices take an explicit context, whose devices run one after
        another, see :meth:`sharded_plan`), schedules ``images`` with
        the Variant-3 ``strategy`` into shape-bucketed rounds, applies the
        config's Variant-2 filter level, records completed work in
        ``work_log`` and regrows capacities on overflow (grown capacities
        stick for later rounds).

        ``images``: a heterogeneous dataset — each element an image id
        (``int``, at ``image_size``), an ``(id, size)`` / ``(id, (H, W))``
        pair, or a :class:`repro_torch.pipeline.scheduler.ImageMeta` (the
        synthetic astro loader renders square frames only).  Images larger
        than ``TileSpec.max_tile_pixels`` run as tiled rounds through
        :meth:`run_tiled`, loaded tile by tile; the driver's loader thread
        stages round r+1 while round r computes
        (``config.prefetch_rounds``), and with ``config.overlap`` a harvest
        thread resolves rounds while the driver dispatches later ones.

        Returns :class:`repro_torch.pipeline.driver.PipelineResult`.
        """
        from repro_torch.distributed.context import single_device_ctx
        from repro_torch.pipeline.driver import run_pipeline
        from repro_torch.pipeline.executor import ShardedPHExecutor
        executor = ShardedPHExecutor(
            self, ctx if ctx is not None else single_device_ctx(self.device),
            image_size=image_size)
        return run_pipeline(executor, images, strategy=strategy,
                            work_log=work_log,
                            failure_injector=failure_injector,
                            max_retries=max_retries, verbose=verbose)
