"""Executor layer: batched PixHomology over the devices of a context.

Counterpart of ``repro.pipeline.executor``.  One round is an ``(M, Hb,
Wb)`` image batch, ``M == dp_size``: each device of the
:class:`repro_torch.distributed.context.DistContext` takes its own rows
(the engine's :meth:`~repro_torch.ph.PHEngine.sharded_plan`).  Images are
*generated per executor* (Variant 1 ``load_self``): the driver passes
image metadata and the executor renders only what it stages — for
oversized images only the halo-padded *tiles*
(:meth:`ShardedPHExecutor.load_self_tiled`, windowed loading through
:class:`repro_torch.data.astro.AstroImage`).

Heterogeneous rounds: a round's images share one padded bucket shape; a
smaller image is padded with the inert fill.  Under the finite Variant-2
threshold the pipeline always supplies for padded rounds, pad pixels
produce no births, candidates or merges, leaving two artifacts repaired
on the host (:mod:`repro_torch.pipeline.padding`): the index stride and
the essential class's death.

Staging is split as the overlap engine needs it
(:mod:`repro_torch.ph.overlap`): :meth:`ShardedPHExecutor.load_round`
builds the round in a pinned staging slot on the host
(:meth:`~ShardedPHExecutor._build_host_round`, no device allocation) and
enqueues its one upload group (:meth:`~ShardedPHExecutor._stage_round`);
:meth:`~ShardedPHExecutor.begin_staged` returns a
:class:`~repro_torch.ph.overlap.PendingResult` whose ``resolve()`` runs
the computation, the overflow check and regrow, the pad repair and the
copy of the diagrams to the host.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Any

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.core import Diagram, stack_diagrams
from repro_torch.core.grid import neg_inf
from repro_torch.data import astro
from repro_torch.ph.config import FilterLevel
from repro_torch.ph.engine import PHEngine, threshold_dtype
from repro_torch.ph.overlap import PendingResult, map_tensors
from repro_torch.pipeline.padding import pad_fill_value, pad_fixup, \
    unpad_diagram
from repro_torch.pipeline.scheduler import BucketRound, ImageMeta


def _to_host(tree):
    def host(t):
        telemetry.readback(t.device)
        return t.cpu()
    return map_tensors(host, tree)


@dataclasses.dataclass
class StagedRound:
    """Staged inputs of one scheduled round (built by
    :meth:`ShardedPHExecutor.load_round`, possibly on the driver's loader
    thread while the previous round computes)."""

    rnd: BucketRound | None
    slot: Any = None            # whole rounds: the staging slot (host batch,
    #                             thresholds, each device's rows)
    fixups: list | None = None  # per entry: None | (H, W, ext_val, ext_idx)
    tiles: Any = None           # tiled rounds: core.tiling.StagedTiles
    threshold: float | None = None  # tiled rounds: Variant-2 threshold


class ShardedPHExecutor:
    """Engine-backed executor pool over a device context.

    Capacities start at the engine config's values and, with
    ``auto_regrow`` on, stick at any regrown size for later rounds and
    runs (the engine's regrow memo).
    """

    def __init__(self, engine: PHEngine, ctx, *, image_size: int = 512):
        if not isinstance(engine, PHEngine):
            raise TypeError(f"engine must be a PHEngine, "
                            f"got {type(engine).__name__}")
        self.engine = engine
        self.ctx = ctx
        self.image_size = image_size
        # Variant-3 costs measured from loaded images, keyed by (id,
        # shape); they override the schedule-time estimate on retries.
        self._measured_costs: dict[tuple, float] = {}

    @property
    def num_executors(self) -> int:
        return self.ctx.dp_size

    # -- scheduling knobs (read by the driver) -----------------------------

    @property
    def bucket_rounding(self) -> str:
        return self.engine.config.bucket_rounding

    @property
    def pad_ok(self) -> bool:
        """Padded rounds need a finite Variant-2 threshold to keep pad
        pixels out of the analysis; VANILLA runs use exact buckets."""
        return self.engine.config.filter_level is not FilterLevel.VANILLA

    @property
    def prefetch_rounds(self) -> int:
        return self.engine.config.prefetch_rounds

    @property
    def max_tile_pixels(self) -> int | None:
        t = self.engine.config.tile
        return t.max_tile_pixels if t is not None else None

    @property
    def overlap(self):
        """The engine's effective overlap policy (the driver reads
        ``enabled`` / ``staging_depth`` / ``async_harvest``)."""
        return self.engine.overlap_spec()

    # -- Variant-3 costs ---------------------------------------------------

    def estimate_costs(self, metas) -> dict[int, float]:
        """Schedule-time costs: the measured cost where a load already
        happened, else the render-free star-stream estimate.  Rejects
        shapes the loader cannot render before anything is scheduled."""
        out = {}
        for meta in metas:
            _require_square(meta.shape)
            got = self._measured_costs.get((meta.image_id, meta.shape))
            out[meta.image_id] = got if got is not None else \
                astro.estimate_cost_from_id(meta.image_id, meta.shape[0])
        return out

    # -- Variant-1 loading -------------------------------------------------

    def _load_one(self, meta: ImageMeta):
        """Render one whole image; returns it with its threshold (and
        records its measured cost)."""
        h, _ = _require_square(meta.shape)
        img = astro.generate_image(meta.image_id, h)
        t = self.engine.auto_threshold(img)
        self._measured_costs[(meta.image_id, meta.shape)] = \
            astro.estimate_cost(img, self.engine.config.filter_level)
        return img, t

    def load_round(self, rnd: BucketRound) -> StagedRound:
        """Stage one scheduled round (thread-safe: the driver calls this
        on its loader thread for round r+1 while round r computes).
        Enqueues only non-blocking device work."""
        if rnd.kind == "tiled":
            assert len(rnd.entries) == 1
            return self.load_self_tiled(rnd, rnd.entries[0][1])
        return self._stage_round(self._build_host_round(rnd))

    def _acquire(self, shape, dtype):
        return self.engine.staging.acquire(self.ctx.devices, shape, dtype,
                                           threshold_dtype(dtype))

    def _build_host_round(self, rnd: BucketRound) -> StagedRound:
        """Host half of staging: render, cast and pad one round into the
        host buffers of a staging slot (pinned when the devices are
        cards).  Allocates device buffers only from the staging pool and
        writes none; the upload is :meth:`_stage_round`."""
        eng = self.engine
        m = self.num_executors
        hb, wb = rnd.shape
        filt = eng.config.filtration
        inert = math.inf if filt == "sublevel" else -math.inf
        bdt = eng.cast_input_host(np.zeros((), np.float32)).dtype
        slot = self._acquire((m, hb, wb), bdt)
        batch, tvals = slot.host_batch, slot.host_tvals
        batch.fill_(pad_fill_value(bdt, filt))
        tvals.fill_(inert)
        fixups: list = [None] * len(rnd.entries)
        for k, (s, meta) in enumerate(rnd.entries):
            img, t = self._load_one(meta)
            # The config dtype cast happens per image, so the pad fixup
            # sees the values the computation sees.
            img = eng.cast_input_host(img)
            h, w = img.shape
            if (h, w) != (hb, wb):
                if t is None:
                    raise ValueError(
                        "padded round without a finite threshold (the "
                        "scheduler must use exact buckets when pad_ok is "
                        "False)")
                batch[s, :h, :w] = img
                tvals[s] = t
                fixups[k] = pad_fixup(img, filt)
            else:
                batch[s] = img
                tvals[s] = inert if t is None else t
        filled = {s for s, _ in rnd.entries}
        src = rnd.entries[0][0]
        for s in range(m):          # pad free slots: repeat a staged image
            if s not in filled:
                batch[s] = batch[src]
                tvals[s] = tvals[src]
        return StagedRound(rnd, slot=slot, fixups=fixups)

    def _stage_round(self, staged: StagedRound) -> StagedRound:
        """Device half of staging: the round's batch **and** thresholds,
        every device's rows, go up as one non-blocking copy group (one
        ``h2d_transfers``)."""
        self.engine.staging.upload(staged.slot)
        self.engine.overlap_counters.bump("h2d_transfers")
        return staged

    def load_self_tiled(self, rnd: BucketRound,
                        meta: ImageMeta) -> StagedRound:
        """Variant-1 ``load_self`` for tiles: stage an oversized image as
        device-resident halo tiles through the windowed
        :class:`repro_torch.data.astro.AstroImage` provider; no host ever
        holds the full frame."""
        h, _ = _require_square(meta.shape)
        provider = astro.AstroImage(meta.image_id, h)
        t = self.engine.provider_threshold(provider)
        tiles = self.engine.stage_tiles(provider, ctx=self.ctx)
        return StagedRound(rnd, tiles=tiles, threshold=t)

    # -- round execution ---------------------------------------------------

    def run_staged(self, staged: StagedRound) -> dict[int, Diagram]:
        """Run one staged round; returns per-image host diagrams with the
        pad artifacts repaired.  Synchronous: everything happens on the
        calling thread (one dispatch-path sync, counted)."""
        self.engine.overlap_counters.bump("dispatch_syncs")
        return self.begin_staged(staged).resolve()

    def begin_staged(self, staged: StagedRound) -> PendingResult:
        """Begin one staged round without blocking.

        With ``overlap.async_overflow`` (and for every tiled round) this
        enqueues nothing: ``resolve()`` runs the computation, the overflow
        check and regrow, the pad repair and the copy to the host.
        Without it the computation runs here.  ``resolve()`` returns
        exactly :meth:`run_staged`'s per-image dict."""
        rnd = staged.rnd
        if rnd.kind == "tiled":
            meta = rnd.entries[0][1]
            tiles, threshold = staged.tiles, staged.threshold

            def tiled_finish():
                res = self._tiled(tiles, threshold)
                return {meta.image_id: _to_host(res.diagram)}

            return PendingResult(tiled_finish)

        finish = self._begin_sharded(staged)

        def whole_finish():
            diags = finish()
            out: dict[int, Diagram] = {}
            for k, (s, meta) in enumerate(rnd.entries):
                d = Diagram(*(x[s] for x in diags))
                if staged.fixups[k] is not None:
                    d = unpad_diagram(d, staged.fixups[k], rnd.shape)
                out[meta.image_id] = d
            return out

        return PendingResult(whole_finish)

    def _tiled(self, image, threshold):
        """One tiled-image dispatch: through the engine's delta path when
        ``config.delta`` is enabled (retried or resumed rounds of the same
        frame become cache hits), else ``run_tiled``."""
        eng = self.engine
        dspec = eng.config.delta
        if dspec is not None and dspec.enabled:
            return eng.run_delta(image, threshold)
        return eng.run_tiled(image, threshold, ctx=self.ctx)

    def _begin_sharded(self, staged: StagedRound):
        """Dispatch one whole round through the engine's regrow loop;
        returns ``finish() -> host Diagram`` of all ``M`` rows.  A regrow
        replay reads the same staged buffers; the slot goes back to the
        pool once the last attempt is enqueued."""
        eng = self.engine
        slot = staged.slot
        shape = tuple(slot.host_batch.shape)
        dtype = slot.host_batch.dtype
        stream = eng._stream_results()

        def dispatch(mf, mc):
            plan = eng.sharded_plan(self.ctx, shape, dtype, mf, mc)
            return plan(*slot.ready())

        _, finish = eng.begin_regrow(
            dispatch,
            lambda outs: any(eng.overflowed(d.overflow.any()) for d in outs),
            shape[1] * shape[2], "sharded",
            memo_key=("sharded", shape, str(dtype)), stream=stream)

        def finish_host():
            outs, _ = finish()
            eng.staging.release(slot)
            if not stream:
                outs = _to_host(outs)
            return Diagram(*(torch.cat(f) for f in zip(*outs)))

        return finish_host

    def run_round(self, images: np.ndarray, thresholds: np.ndarray):
        """``images``: (M, H, W) with M == num_executors (padded by the
        caller).  Returns the round's host ``Diagram`` (M rows).

        Images above the engine's ``TileSpec.max_tile_pixels`` run through
        the halo-tiled path, one image at a time.  The bucketed pipeline
        schedules such images as their own tiled rounds; this
        batch-shaped entry point remains for direct use."""
        eng = self.engine
        if eng.should_tile(images.shape[1] * images.shape[2]):
            return self._run_round_tiled(images, thresholds)
        host = eng.cast_input_host(images)
        slot = self._acquire(tuple(host.shape), host.dtype)
        slot.host_batch.copy_(host)
        slot.host_tvals.copy_(torch.as_tensor(np.asarray(thresholds)).to(
            slot.host_tvals.dtype))
        staged = self._stage_round(StagedRound(None, slot=slot))
        eng.overlap_counters.bump("dispatch_syncs")
        return self._begin_sharded(staged)()

    def _run_round_tiled(self, images: np.ndarray, thresholds: np.ndarray):
        """Oversized-image round: one image at a time through the tiled
        path (regrow and plans live in ``run_tiled``)."""
        # Rounds may repeat identical rows (short-round padding, duplicate
        # datasets): every (threshold, image) computes once per round.
        images = np.asarray(images)
        seen: dict[tuple, int] = {}
        diags: list[Diagram] = []
        for i in range(images.shape[0]):
            key = (float(thresholds[i]),
                   hashlib.sha1(np.ascontiguousarray(
                       images[i]).tobytes()).hexdigest())
            dup = seen.get(key)
            if dup is not None and np.array_equal(images[i], images[dup]):
                diags.append(diags[dup])
                continue
            seen[key] = i
            diags.append(_to_host(
                self._tiled(images[i], float(thresholds[i])).diagram))
        # Per-image regrow can leave different capacities: pad the rows to
        # the round maximum with the core's own pad rows (-inf under
        # superlevel, +inf in sublevel user space).
        f = max(d.birth.shape[0] for d in diags)
        sublevel = self.engine.config.filtration == "sublevel"

        def padded(d: Diagram) -> Diagram:
            extra = f - d.birth.shape[0]
            if extra == 0:
                return d
            fill = neg_inf(d.birth.dtype)
            if sublevel:
                fill = -fill

            def grow(a, v):
                return torch.cat([a, torch.full((extra,), v, dtype=a.dtype)])

            return Diagram(grow(d.birth, fill), grow(d.death, fill),
                           grow(d.p_birth, -1), grow(d.p_death, -1),
                           d.count, d.n_unmerged, d.overflow)

        return stack_diagrams([padded(d) for d in diags])


def _require_square(shape) -> tuple[int, int]:
    """The synthetic astro loader renders square frames only; reject
    rectangles before they are scheduled."""
    h, w = shape
    if h != w:
        raise ValueError(f"astro frames are square, got {tuple(shape)}")
    return h, w
