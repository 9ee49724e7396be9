"""Pipeline driver: bucketed rounds, prefetch overlap, work-log tolerance.

Counterpart of ``repro.pipeline.driver``.  Spark equivalents (paper §4.2,
§5.2): the driver moves only image *ids and shapes* (Variant 1);
completed work is recorded in an append-only JSONL work log, so a crashed
or restarted run (or an injected executor failure) re-schedules only the
incomplete images.  Changing the executor count between attempts
re-schedules the remaining work.

Rounds are shape-bucketed (:func:`repro_torch.pipeline.scheduler.\
make_bucketed_schedule`), and a loader thread stages round r+1 while
round r computes (``PHConfig.prefetch_rounds``).  A staged but unconsumed
round is discarded on failure and its images re-schedule from the work
log.

Overlap engine (``PHConfig.overlap`` with ``async_harvest``): the driver
begins each round through the pool's ``begin_staged`` and hands its
``resolve()`` to a harvest thread, keeping up to
``OverlapSpec.staging_depth`` rounds in flight.  In the port the
computation itself runs in ``resolve()`` (its phases read back to the
host), so the dispatch loop only renders, enqueues uploads and waits for
the window: it performs no blocking device read
(``OverlapCounters.dispatch_syncs`` unchanged).  The failure injector
observes dispatch sequence numbers; on a failure, rounds whose harvest
completed are recorded and unresolved in-flight rounds are discarded.

``run_pipeline`` is the engine's distributed workhorse: call it through
:meth:`repro_torch.ph.PHEngine.run_distributed`.  ``pool`` is any executor
with ``num_executors`` / ``estimate_costs`` / ``load_round`` /
``run_staged`` plus the scheduling knobs ``bucket_rounding`` / ``pad_ok``
/ ``prefetch_rounds`` / ``max_tile_pixels`` (normally
:class:`repro_torch.pipeline.executor.ShardedPHExecutor`).
"""
from __future__ import annotations

import contextvars
import dataclasses
import json
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from repro_torch.pipeline.scheduler import make_bucketed_schedule, \
    normalize_images


@dataclasses.dataclass
class PipelineResult:
    diagrams: dict          # image_id -> dict summary
    rounds: int
    failures: int
    elapsed_s: float


class FailureInjector:
    """Deterministically fail chosen rounds once each (for tests/benchmarks)."""

    def __init__(self, fail_rounds=()):
        self.fail_rounds = set(fail_rounds)
        self.seen = set()

    def __call__(self, round_idx: int):
        if round_idx in self.fail_rounds and round_idx not in self.seen:
            self.seen.add(round_idx)
            raise RuntimeError(f"injected executor failure in round "
                               f"{round_idx}")


def _host64(x) -> np.ndarray:
    """A diagram field as a float64 numpy array (bfloat16 included)."""
    return torch.as_tensor(x).detach().cpu().to(torch.float64).numpy()


def _summarize(diag) -> dict:
    """The work log's per-image record, computed as the reference's is
    (float64 numpy arithmetic on the host copy)."""
    count = int(diag.count)
    birth, death = _host64(diag.birth), _host64(diag.death)
    return {
        "count": count,
        "overflow": bool(diag.overflow),
        "top_births": birth[:5].tolist(),
        "top_deaths": death[:5].tolist(),
        "persistence_sum": float(np.sum(
            np.clip(birth[:count] - death[:count], 0, None))),
    }


def run_pipeline(pool, images, *, strategy: str = "part_LPT",
                 work_log: str | Path | None = None,
                 failure_injector=None, max_retries: int = 3,
                 verbose: bool = False) -> PipelineResult:
    t0 = time.time()
    metas = normalize_images(images,
                             default_size=getattr(pool, "image_size", 512))
    log_path = Path(work_log) if work_log else None
    done: dict[int, dict] = {}

    # Resume from the work log (fault tolerance across driver restarts).
    if log_path and log_path.exists():
        for line in log_path.read_text().splitlines():
            rec = json.loads(line)
            done[rec["image_id"]] = rec["summary"]

    pending = [m for m in metas if m.image_id not in done]
    failures = 0
    rounds = 0
    attempt = 0
    prefetch = max(0, int(getattr(pool, "prefetch_rounds", 0)))
    ospec = getattr(pool, "overlap", None)
    overlapped = (ospec is not None and ospec.enabled
                  and ospec.async_harvest
                  and hasattr(pool, "begin_staged"))
    depth = ospec.staging_depth if overlapped else 0
    counters = getattr(getattr(pool, "engine", None),
                       "overlap_counters", None)

    def record(rnd, per_image):
        nonlocal rounds
        for img_id, diag in per_image.items():
            summary = _summarize(diag)
            done[img_id] = summary
            if log_path:
                with log_path.open("a") as f:
                    f.write(json.dumps(
                        {"image_id": img_id,
                         "summary": summary}) + "\n")
        rounds += 1
        if verbose:
            print(f"round {rounds}: {rnd.kind} {rnd.shape} "
                  f"{len(per_image)} images "
                  f"({len(done)}/{len(metas)})", flush=True)

    def resolve_on_harvest(pending_round):
        # Runs on the harvest thread: blocking readbacks are free here.
        if counters is not None:
            counters.bump("harvest_syncs")
        return pending_round.resolve()

    while pending and attempt <= max_retries:
        attempt += 1
        m = pool.num_executors
        # Variant-3 costs come from the executor (measured where a load
        # already ran, the render-free estimate otherwise).
        costs = pool.estimate_costs(pending)
        sched = make_bucketed_schedule(
            strategy, pending, m, costs,
            rounding=getattr(pool, "bucket_rounding", "exact"),
            pad=getattr(pool, "pad_ok", False),
            max_tile_pixels=getattr(pool, "max_tile_pixels", None))
        round_list = list(sched.rounds())
        loader = ThreadPoolExecutor(max_workers=1, thread_name_prefix="ph-load") \
            if prefetch and len(round_list) > 1 else None
        harvest = ThreadPoolExecutor(max_workers=1,
                                     thread_name_prefix="ph-harvest") \
            if overlapped else None
        staged_q: list = []     # FIFO of in-flight load futures
        harvest_q: list = []    # FIFO of (harvest future, round)
        next_load = 0
        # Dispatch sequence for the failure injector: in synchronous mode
        # it equals the completed-round counter at injection time, so
        # injector semantics are unchanged; under overlap it indexes
        # dispatch order (rounds ahead of the harvested count).
        seq = rounds

        def top_up():
            # The front future is the round about to be consumed; while a
            # round computes, at most `prefetch` later rounds stay staged.
            nonlocal next_load
            while (loader is not None and len(staged_q) < prefetch
                   and next_load < len(round_list)):
                # In this thread's context: the loader's spans belong to
                # the job's call.
                staged_q.append(loader.submit(
                    contextvars.copy_context().run, pool.load_round,
                    round_list[next_load]))
                next_load += 1

        try:
            for rnd in round_list:
                # Double buffering: the loader thread stages ahead while
                # this thread computes; with prefetch off, load inline.
                top_up()
                if staged_q:
                    staged = staged_q.pop(0).result()
                else:
                    staged = pool.load_round(rnd)
                    next_load += 1
                top_up()
                if failure_injector:
                    failure_injector(seq)
                seq += 1
                if harvest is not None:
                    # Overlapped: dispatch now, resolve on the harvest
                    # thread; block only when the in-flight window would
                    # exceed the staging-ring depth.
                    harvest_q.append((harvest.submit(
                        resolve_on_harvest, pool.begin_staged(staged)),
                        rnd))
                    while len(harvest_q) > depth:
                        fut, rnd_done = harvest_q.pop(0)
                        record(rnd_done, fut.result())
                else:
                    record(rnd, pool.run_staged(staged))
            while harvest_q:
                fut, rnd_done = harvest_q.pop(0)
                record(rnd_done, fut.result())
        except RuntimeError as e:
            failures += 1
            if verbose:
                print(f"FAILURE (attempt {attempt}): {e}; "
                      f"re-scheduling incomplete images", flush=True)
        finally:
            # Discard staged-but-unconsumed rounds (their images simply
            # re-schedule); surface nothing from the loader here.
            for fut in staged_q:
                try:
                    fut.result()
                except Exception:
                    pass
            # Harvest rounds already in flight: a completed round is a
            # real result (record it — its images must not re-schedule);
            # a failed or poisoned one is discarded like a prefetch slot
            # and its images re-schedule from the work log.
            while harvest_q:
                fut, rnd_done = harvest_q.pop(0)
                try:
                    record(rnd_done, fut.result())
                except Exception:
                    pass
            if harvest is not None:
                harvest.shutdown(wait=True)
            if loader is not None:
                loader.shutdown(wait=True)
        pending = [mm for mm in metas if mm.image_id not in done]

    if pending:
        raise RuntimeError(f"pipeline could not finish {len(pending)} images "
                           f"after {max_retries} retries")
    return PipelineResult(done, rounds, failures, time.time() - t0)
