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
  per-call :class:`RegrowStats`.

The engine runs on the CUDA device unless the caller passes another
``device`` (the tests pass ``"cpu"``); without CUDA, ``PHEngine()`` raises
instead of falling back.  Mixed-shape batches, tiling, the distributed
pipeline, delta-PH, serving and distances are still to be ported
(ROADMAP.md, queue 1).
"""
from __future__ import annotations

import dataclasses
import functools
import threading
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import Diagram, batched_pixhomology, \
    num_candidates as core_num_candidates, pixhomology
from repro_torch.core.packed_keys import check_finite, resolve_merge_keys
from repro_torch.core.reference import diagram_to_array
from repro_torch.ph.config import FilterLevel, PHConfig

# The dtypes the kernels take; wider inputs are canonicalized the way the
# reference package canonicalizes them without 64-bit mode.
SUPPORTED_DTYPES = (torch.uint8, torch.int16, torch.int32, torch.float32,
                    torch.bfloat16)
_CANONICAL = {torch.float64: torch.float32, torch.int64: torch.int32}
_CONFIG_DTYPES = {"float32": torch.float32, "float64": torch.float32,
                  "int32": torch.int32, "bfloat16": torch.bfloat16}


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

    def _ph_kwargs(self, mf: int, mc: int, merge_keys: str) -> dict:
        """Static arguments of one plan: capacities plus the stage
        signature's knobs."""
        cfg = self.config
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
        key = (kind, tuple(shape), str(dtype), mf, mc, truncated,
               self.config.plan_key())

        def build(plan: Plan):
            plan.traces += 1
            return functools.partial(callee, **self._ph_kwargs(mf, mc, mk))

        return self.get_plan(key, build)

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
                     memo_key: tuple | None = None
                     ) -> tuple[Any, Callable[[], tuple[Any, RegrowStats]]]:
        """Dispatch once at the memoized capacities and return
        ``(out, finish)``; ``finish()`` performs the overflow check and the
        regrow-and-replay loop, returning ``(out, RegrowStats)``."""
        cfg = self.config
        mf0, mc0 = self.initial_capacities(n)
        if cfg.auto_regrow and memo_key is not None:
            with self._lock:
                got = self._grown.get(memo_key)
            if got:
                mf0 = max(mf0, min(got[0], n))
                mc0 = max(mc0, min(got[1], n))
        out0 = dispatch(mf0, mc0)

        def finish(out=out0, mf=mf0, mc=mc0):
            attempts = 0
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
                out = dispatch(mf, mc)
                over = overflowed(out)
            if attempts and memo_key is not None:
                with self._lock:
                    got = self._grown.get(memo_key)
                    if got is None or got < (mf, mc):
                        self._grown[memo_key] = (mf, mc)
            return out, RegrowStats(attempts, mf, mc, bool(over))

        return out0, finish

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
        return x.to(dtype=dt)

    def cast_input(self, image) -> torch.Tensor:
        """:meth:`cast_input_host`, then onto the engine's device."""
        return self.cast_input_host(image).to(self.device).contiguous()

    def auto_threshold(self, image) -> float | None:
        """The Variant-2 threshold ``config.filter_level`` implies for
        ``image`` (``None`` under VANILLA), from the numpy astro statistic."""
        if self.config.filter_level is FilterLevel.VANILLA:
            return None
        from repro_torch.data import astro
        x = as_host_tensor(image).detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.to(torch.float32)
        host = x.numpy()
        if self.config.filtration == "sublevel":
            t, _ = astro.filter_threshold(-host, self.config.filter_level)
            return None if t is None else -t
        t, _ = astro.filter_threshold(host, self.config.filter_level)
        return t

    # -- public entry points ----------------------------------------------

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
        truncated = truncate_value is not None
        shape, dtype = tuple(x.shape), x.dtype
        if truncated:
            tv = torch.tensor(truncate_value, dtype=threshold_dtype(dtype),
                              device=self.device)

        def dispatch(mf, mc):
            plan = self._local_plan("single", shape, dtype, mf, mc,
                                    truncated)
            return plan(x, tv) if truncated else plan(x)

        diag, stats = self.run_with_regrow(
            dispatch, lambda d: bool(d.overflow), x.numel(), "single",
            memo_key=("single", shape, str(dtype)))
        return PHResult(diag, self.config.replace(
            max_features=stats.final_max_features,
            max_candidates=stats.final_max_candidates), stats,
            truncate_value)

    def run_batch(self, images, truncate_values=None) -> PHResult:
        """PH over a uniform batch — a ``(B, H, W)`` array or tensor, or a
        sequence of same-shape 2D images — regrowing on *any* overflow.

        ``truncate_values``: optional (B,) per-image thresholds; ``None``
        derives them from ``config.filter_level``.  Mixed shapes need the
        padding/bucketing path, which is still to be ported.
        """
        if isinstance(images, (list, tuple)):
            if not images:
                raise ValueError("run_batch needs at least one image")
            shapes = {tuple(np.shape(im)) for im in images}
            if len(shapes) != 1:
                raise NotImplementedError(
                    f"mixed-shape run_batch (shapes {sorted(shapes)}) needs "
                    f"the padding/bucketing path, still to be ported "
                    f"(ROADMAP.md, queue 1 item 4)")
            images = torch.stack([as_host_tensor(im) for im in images])
        x = self.cast_input(images)
        if x.dim() != 3:
            raise ValueError(f"expected (B, H, W) batch, got shape "
                             f"{tuple(x.shape)}")
        if truncate_values is None and \
                self.config.filter_level is not FilterLevel.VANILLA:
            host = as_host_tensor(images)
            truncate_values = np.asarray(
                [self.auto_threshold(host[i]) for i in range(host.shape[0])],
                np.float32)
        truncated = truncate_values is not None
        if truncated:
            tvals = torch.as_tensor(np.asarray(truncate_values),
                                    device=self.device).to(
                threshold_dtype(x.dtype))
        shape, dtype = tuple(x.shape), x.dtype

        def dispatch(mf, mc):
            plan = self._local_plan("batched", shape, dtype, mf, mc,
                                    truncated)
            return plan(x, tvals) if truncated else plan(x)

        diag, stats = self.run_with_regrow(
            dispatch, lambda d: bool(d.overflow.any()),
            shape[1] * shape[2], "batched",
            memo_key=("batched", shape, str(dtype)))
        return PHResult(diag, self.config.replace(
            max_features=stats.final_max_features,
            max_candidates=stats.final_max_candidates), stats,
            truncate_values)

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
            filtration=cfg.filtration)
