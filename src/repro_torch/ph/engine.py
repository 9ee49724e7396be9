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
  cached plan kind (:mod:`repro_torch.kernels.ph_distance`).

The engine runs on the CUDA device unless the caller passes another
``device`` (the tests pass ``"cpu"``); without CUDA, ``PHEngine()`` raises
instead of falling back.  Tiling, the distributed pipeline, delta-PH and
serving are still to be ported (ROADMAP.md, queue 1).
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import math
import threading
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import Diagram, batched_pixhomology, \
    num_candidates as core_num_candidates, pixhomology, stack_diagrams
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
        ``image`` (``None`` under VANILLA), from the astro statistic on the
        host.  A bfloat16 image stays a tensor, so its median is taken in
        bfloat16 arithmetic as the reference's numpy median is."""
        if self.config.filter_level is FilterLevel.VANILLA:
            return None
        from repro_torch.data import astro
        x = as_host_tensor(image).detach().cpu()
        host = x if x.dtype == torch.bfloat16 else x.numpy()
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
            x = as_host_tensor(im).detach().cpu().contiguous()
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
        """
        if dedupe:
            plan = self._dedupe_batch(images, truncate_values)
            if plan is not None:
                _, inverse, rep_images, rep_tvs = plan
                res = self.run_batch(rep_images, rep_tvs, bucket=bucket,
                                     dedupe=False)
                inv = torch.as_tensor(inverse,
                                      device=res.diagram.birth.device)
                diag = Diagram(*(f[inv] for f in res.diagram))
                thr = res.threshold
                if thr is not None and not np.isscalar(thr):
                    thr = np.asarray(thr)[inverse]
                return dataclasses.replace(res, diagram=diag, threshold=thr)
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

    def _run_batch_uniform(self, images, truncate_values=None) -> PHResult:
        """One ``(B, H, W)`` dispatch at the batch's own shape."""
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

    def _run_batch_bucketed(self, seq, truncate_values,
                            bucket: tuple[int, int] | None) -> PHResult:
        """Mixed-shape batch through one shape-bucketed padded dispatch:
        host cast and padding, one upload, regrow, per-row repair."""
        from repro_torch.pipeline.padding import (pad_fixup, pad_image,
                                                  pad_threshold,
                                                  unpad_diagram)
        from repro_torch.pipeline.scheduler import bucket_shape
        imgs = [self.cast_input_host(im).cpu() for im in seq]
        if bucket is None:
            per = [bucket_shape(tuple(im.shape), self.config.bucket_rounding)
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
            raise ValueError(f"{len(tvs)} thresholds for {len(imgs)} images")

        filt = self.config.filtration
        inert = math.inf if filt == "sublevel" else -math.inf
        dtype = imgs[0].dtype
        batch = torch.empty((len(imgs), *bucket), dtype=dtype)
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
            batch[i] = pad_image(im, bucket, filt)
            tvals[i] = inert if t is None else t

        shape = tuple(batch.shape)
        x = batch.to(self.device)
        tv = torch.as_tensor(tvals, device=self.device).to(
            threshold_dtype(dtype))

        def dispatch(mf, mc):
            plan = self._local_plan("batched", shape, dtype, mf, mc, True)
            return plan(x, tv)

        diag, stats = self.run_with_regrow(
            dispatch, lambda d: bool(d.overflow.any()),
            bucket[0] * bucket[1], "batched",
            memo_key=("batched", shape, str(dtype)))
        rows = []
        for i in range(len(imgs)):
            d = Diagram(*(f[i] for f in diag))
            if fixups[i] is not None:
                d = unpad_diagram(d, fixups[i], bucket)
            rows.append(d)
        return PHResult(stack_diagrams(rows), self.config.replace(
            max_features=stats.final_max_features,
            max_candidates=stats.final_max_candidates), stats, tvals)

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
            return as_host_tensor(a).to(self.device)

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
