"""Workload partitioning strategies (paper §5.2.1 Variant 3), shape-aware.

The port's own copy of ``repro.pipeline.scheduler`` (numpy only, so it is
copied whole rather than imported).

Spark semantics (``repro/ph/DESIGN.md`` §5): executors are the devices of
a :class:`repro_torch.distributed.context.DistContext` and work proceeds in synchronized *rounds* (one image per executor
per round).  A strategy turns (image ids, cost estimates, m executors) into
per-executor queues; the driver zips queues into rounds.  Makespan under
this model is sum over rounds of the max per-round cost, which the
schedulers below minimize the same way they do in the paper:

* part_executors — shuffle, one contiguous chunk per executor (static).
* part_images   — one partition per image, round-robin over executors as
  they free up (Spark's default dynamic assignment; simulated greedily).
* part_LPT      — Longest-Processing-Time over estimated costs (Graham):
  sort descending, repeatedly assign to the least-loaded executor.

Heterogeneous datasets (:func:`make_bucketed_schedule`): image ids carry
``(H, W)`` metadata (:class:`ImageMeta`), and rounds are built from *shape
buckets* — every image in a round shares one padded bucket shape, so one
cached sharded plan serves the whole round.  Cost balancing is LPT within
each bucket and across buckets: buckets are processed largest-shape first,
and free executor slots in a bucket's rounds are back-filled with images
from smaller buckets whenever their pad-inflated cost does not raise the
round maximum (so padding is only ever "free").  Images above the tiled
routing bound schedule as per-image tile-grid rounds instead of competing
for whole-image slots.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np


@dataclasses.dataclass
class Schedule:
    strategy: str
    queues: list[list[int]]          # per-executor ordered image ids

    @property
    def num_rounds(self) -> int:
        return max((len(q) for q in self.queues), default=0)

    def rounds(self):
        """Yield per-round lists of (executor, image_id)."""
        for r in range(self.num_rounds):
            yield [(e, q[r]) for e, q in enumerate(self.queues)
                   if r < len(q)]

    def makespan(self, costs: dict[int, float]) -> float:
        """Lockstep-round makespan: sum of per-round maxima."""
        total = 0.0
        for rnd in self.rounds():
            total += max(costs[i] for _, i in rnd)
        return total

    def queue_makespan(self, costs: dict[int, float]) -> float:
        """Classic (asynchronous-executor) makespan: max queue sum."""
        return max((sum(costs[i] for i in q) for q in self.queues),
                   default=0.0)

    def padded_makespan(self, costs: dict[int, float],
                        metas_by_id: dict[int, "ImageMeta"],
                        pad_shape: tuple[int, int]) -> float:
        """Lockstep makespan of this shape-agnostic schedule on a
        heterogeneous dataset: every round runs one program at
        ``pad_shape`` (the global maximum bucket), so each image pays the
        :func:`effective_cost` pad inflation — the baseline
        :func:`make_bucketed_schedule` is measured against."""
        total = 0.0
        for rnd in self.rounds():
            total += max(effective_cost(costs[i], metas_by_id[i], pad_shape)
                         for _, i in rnd)
        return total


def part_executors(ids, m: int, *, seed: int = 0) -> Schedule:
    ids = list(ids)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(ids))
    chunks = np.array_split(perm, m)
    return Schedule("part_executors",
                    [[ids[i] for i in c] for c in chunks])


def part_images(ids, m: int, costs=None) -> Schedule:
    """Greedy dynamic assignment: next image goes to the executor whose
    queue finishes first (equal costs -> round robin, like Spark default)."""
    ids = list(ids)
    loads = [0.0] * m
    queues: list[list[int]] = [[] for _ in range(m)]
    for i in ids:
        e = int(np.argmin(loads))
        queues[e].append(i)
        loads[e] += 1.0 if costs is None else costs[i]
    return Schedule("part_images", queues)


def part_lpt(ids, m: int, costs) -> Schedule:
    """Graham's LPT rule on estimated processing times."""
    order = sorted(ids, key=lambda i: -costs[i])
    loads = [0.0] * m
    queues: list[list[int]] = [[] for _ in range(m)]
    for i in order:
        e = int(np.argmin(loads))
        queues[e].append(i)
        loads[e] += costs[i]
    return Schedule("part_LPT", queues)


STRATEGIES = {"part_executors": part_executors, "part_images": part_images,
              "part_LPT": part_lpt}


def make_schedule(strategy: str, ids, m: int, costs=None, seed: int = 0):
    if strategy == "part_executors":
        return part_executors(ids, m, seed=seed)
    if strategy == "part_images":
        return part_images(ids, m, costs)
    if strategy == "part_LPT":
        if costs is None:
            raise ValueError("part_LPT needs cost estimates (Variant 3)")
        return part_lpt(ids, m, costs)
    raise ValueError(strategy)


# ---------------------------------------------------------------------------
# Shape-aware scheduling: buckets, tile-grid rounds, pad-aware makespan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ImageMeta:
    """An image id plus the ``(H, W)`` shape the scheduler plans with."""

    image_id: int
    shape: tuple[int, int]

    def __post_init__(self):
        object.__setattr__(self, "shape", tuple(self.shape))
        h, w = self.shape
        if h < 1 or w < 1:
            raise ValueError(f"bad image shape {self.shape}")

    @property
    def pixels(self) -> int:
        return self.shape[0] * self.shape[1]


def normalize_images(images: Iterable, default_size: int = 512
                     ) -> list[ImageMeta]:
    """Coerce a heterogeneous dataset spec into :class:`ImageMeta` rows.

    Accepted elements: ``ImageMeta``; a bare ``int`` id (shape
    ``(default_size, default_size)``); an ``(id, size)`` pair; an
    ``(id, (H, W))`` pair.
    """
    metas = []
    for item in images:
        if isinstance(item, ImageMeta):
            metas.append(item)
        elif isinstance(item, (int, np.integer)):
            metas.append(ImageMeta(int(item), (default_size, default_size)))
        else:
            img_id, shape = item
            if isinstance(shape, (int, np.integer)):
                shape = (int(shape), int(shape))
            metas.append(ImageMeta(int(img_id), tuple(shape)))
    ids = [m.image_id for m in metas]
    if len(set(ids)) != len(ids):
        raise ValueError("duplicate image ids in dataset")
    return metas


def _next_pow2(x: int) -> int:
    return 1 << (int(x) - 1).bit_length()


def bucket_shape(shape: tuple[int, int], rounding: str = "pow2"
                 ) -> tuple[int, int]:
    """The padded bucket an image shape schedules under."""
    if rounding == "exact":
        return tuple(shape)
    if rounding == "pow2":
        return (_next_pow2(shape[0]), _next_pow2(shape[1]))
    raise ValueError(f"unknown bucket rounding {rounding!r}")


def assign_bucket(shape: tuple[int, int],
                  buckets: tuple[tuple[int, int], ...] | None = None,
                  rounding: str = "pow2") -> tuple[int, int] | None:
    """The serving bucket a request ``shape`` dispatches under.

    With a fixed ``buckets`` set (``ServeSpec.buckets``, sorted
    smallest-first) the tightest bucket containing the shape wins —
    ``None`` when it fits none (the caller rejects the request; a
    too-large image must go through the tiled path, not a padded batch).
    Without one, the shape derives its own bucket via
    :func:`bucket_shape`, exactly like the batch pipeline's rounds.
    """
    if buckets is None:
        return bucket_shape(tuple(shape), rounding)
    h, w = shape
    for hb, wb in buckets:
        if h <= hb and w <= wb:
            return (hb, wb)
    return None


def effective_cost(cost: float, meta: ImageMeta,
                   shape: tuple[int, int]) -> float:
    """Pad-aware cost: running ``meta`` inside a ``shape``-padded program
    scales the estimate by the padded/own pixel ratio (phases 1-2 of the
    algorithm sweep every padded pixel)."""
    return cost * (shape[0] * shape[1]) / meta.pixels


@dataclasses.dataclass(frozen=True)
class BucketRound:
    """One lockstep dispatch: a shape bucket's round, or one tiled image.

    ``kind="whole"``: ``entries`` are ``(executor_slot, meta)`` pairs, every
    image padded to ``shape``.  ``kind="tiled"``: a single oversized image
    whose tile grid spans the mesh; ``entries`` holds its one meta.
    """

    kind: str
    shape: tuple[int, int]
    entries: tuple[tuple[int, ImageMeta], ...]

    @property
    def image_ids(self) -> list[int]:
        return [meta.image_id for _, meta in self.entries]

    def cost(self, costs: dict[int, float]) -> float:
        if self.kind == "tiled":
            return sum(costs[meta.image_id] for _, meta in self.entries)
        return max(effective_cost(costs[meta.image_id], meta, self.shape)
                   for _, meta in self.entries)


@dataclasses.dataclass
class BucketedSchedule:
    strategy: str
    round_list: list[BucketRound]

    @property
    def num_rounds(self) -> int:
        return len(self.round_list)

    def rounds(self):
        yield from self.round_list

    def makespan(self, costs: dict[int, float]) -> float:
        """Lockstep pad-aware makespan: sum of per-round maxima of
        :func:`effective_cost` (tiled rounds cost their whole image)."""
        return sum(r.cost(costs) for r in self.round_list)


def _bucket_rounds(strategy: str, buckets: dict, m: int, costs, *,
                   pad: bool, rounding: str,
                   seed: int = 0) -> list[BucketRound]:
    """Rounds for a bucket partition, largest bucket shape first.

    ``part_LPT`` builds each bucket's rounds by *sorted banding* —
    descending (pad-aware) cost, groups of m — which is optimal for the
    lockstep sum-of-round-maxima makespan (the j-th round's max is the
    (jm+1)-th largest cost, the universal lower bound); other strategies
    keep their queue-zip semantics.  When padding is allowed and costs are
    known, free executor slots are back-filled with the most expensive
    smaller-bucket images whose pad-inflated cost does not raise the round
    maximum (padding only ever "free").
    """
    buckets = {shape: list(pool) for shape, pool in buckets.items()}
    rounds: list[BucketRound] = []
    order = sorted(buckets, key=lambda s: (-s[0] * s[1], s))
    for bi, shape in enumerate(order):
        pool = buckets[shape]
        if not pool:
            continue
        if strategy == "part_LPT":
            ordered = sorted(
                pool, key=lambda meta: (-effective_cost(
                    costs[meta.image_id], meta, shape), meta.image_id))
            raw = [[(k % m, meta.image_id) for k, meta in
                    enumerate(ordered[r:r + m])]
                   for r in range(0, len(ordered), m)]
        else:
            sched = make_schedule(strategy, [meta.image_id for meta in pool],
                                  m, costs, seed=seed)
            raw = list(sched.rounds())
        by_id = {meta.image_id: meta for meta in pool}
        smaller = [meta for s in order[bi + 1:] for meta in buckets[s]]
        for rnd in raw:
            entries = [(slot, by_id[i]) for slot, i in rnd]
            if pad and costs is not None and smaller and len(entries) < m:
                used = {slot for slot, _ in entries}
                free = [s for s in range(m) if s not in used]
                rmax = max(effective_cost(costs[meta.image_id], meta, shape)
                           for _, meta in entries)
                smaller.sort(key=lambda meta: -costs[meta.image_id])
                for slot in free:
                    pick = next(
                        (meta for meta in smaller
                         if effective_cost(costs[meta.image_id], meta,
                                           shape) <= rmax), None)
                    if pick is None:
                        break
                    smaller.remove(pick)
                    buckets[bucket_shape(pick.shape, rounding)].remove(pick)
                    entries.append((slot, pick))
            rounds.append(BucketRound("whole", shape, tuple(entries)))
    return rounds


def make_bucketed_schedule(strategy: str, metas, m: int, costs=None, *,
                           rounding: str = "pow2", pad: bool = True,
                           max_tile_pixels: int | None = None,
                           seed: int = 0) -> BucketedSchedule:
    """Schedule a heterogeneous dataset into shape-bucketed rounds.

    ``pad=False`` forces exact-shape buckets and disables cross-bucket
    back-fill (required when no finite Variant-2 threshold exists: padded
    pixels are only provably inert below a threshold).  Back-fill also
    needs ``costs``; without them buckets stay self-contained.

    For ``part_LPT`` with costs and padding allowed, two candidates are
    evaluated under the pad-aware lockstep makespan and the cheaper wins:
    per-shape buckets (no pad waste, but buckets serialize), and one
    global bucket at the maximum shape (everything padded, but maximal
    slot utilization — this candidate's banding alone already lower-bounds
    any shape-agnostic schedule at that pad shape, so bucketed-LPT never
    loses to ``part_images``-on-padded-images).
    """
    if strategy == "part_LPT" and costs is None:
        raise ValueError("part_LPT needs cost estimates (Variant 3)")
    metas = list(metas)
    tiled = [meta for meta in metas
             if max_tile_pixels is not None and meta.pixels > max_tile_pixels]
    tiled_ids = {meta.image_id for meta in tiled}
    regular = [meta for meta in metas if meta.image_id not in tiled_ids]
    if not pad:
        rounding = "exact"

    buckets: dict[tuple[int, int], list[ImageMeta]] = {}
    for meta in regular:
        buckets.setdefault(bucket_shape(meta.shape, rounding),
                           []).append(meta)

    rounds = _bucket_rounds(strategy, buckets, m, costs, pad=pad,
                            rounding=rounding, seed=seed)
    if (strategy == "part_LPT" and pad and costs is not None
            and len(buckets) > 1):
        top = max(buckets, key=lambda s: s[0] * s[1])
        merged = _bucket_rounds(strategy, {top: regular}, m, costs,
                                pad=pad, rounding=rounding, seed=seed)
        def span(rs):
            return sum(r.cost(costs) for r in rs)
        if span(merged) < span(rounds):
            rounds = merged

    if costs is not None:
        tiled.sort(key=lambda meta: -costs[meta.image_id])
    for meta in tiled:
        rounds.append(BucketRound("tiled", meta.shape, ((0, meta),)))
    return BucketedSchedule(strategy, rounds)
