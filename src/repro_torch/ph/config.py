"""Typed, frozen configuration for the PH engine (the single public knob set).

The port's own copy of ``repro.ph.config``: the field names, defaults and
validation are unchanged, so a JSON written by one package loads in the
other with equal fields and an equal ``stage_signature()``, and
:meth:`PHConfig.from_flags` reads the same command-line flags.

``use_pallas`` keeps its name for that round trip.  In the port it selects
the hand-written CUDA kernels: ``None`` (or ``True``) runs them on CUDA
tensors, ``False`` explicitly selects their plain PyTorch versions.  CPU
tensors always take the plain versions.  ``interpret`` and
``phase_c_block`` are TPU-kernel knobs with no effect here;
``phase_c_block`` is carried for the autotune cache's schema.
``autotune`` folds a disk-cache entry of
:mod:`repro_torch.roofline.autotune` into the engine's plans per image
shape family, as in the reference.
"""
from __future__ import annotations

import dataclasses
import enum
import json
from typing import Any

from repro_torch.core.packed_keys import (  # noqa: F401  (single source)
    FILTRATIONS,
    MERGE_KEYS,
)

CANDIDATE_MODES = ("exact", "paper")
HASH_ALGOS = ("blake2b", "sha1", "md5")
MERGE_IMPLS = ("scan", "boruvka")
PHASE_A_IMPLS = ("fused", "pooled")
PHASE_C_IMPLS = ("fused", "xla")
DTYPES = (None, "float32", "float64", "int32", "bfloat16")
BUCKET_ROUNDINGS = ("exact", "pow2")
ADMISSION_POLICIES = ("reject", "block")


def parse_grid(value) -> tuple[int, int]:
    """Parse a tile grid from its CLI form (``"2x4"``) or a pair."""
    if isinstance(value, str):
        parts = value.lower().split("x")
        if len(parts) != 2:
            raise ValueError(f"grid must look like 'RxC', got {value!r}")
        return tuple(int(x) for x in parts)
    return tuple(value)


@dataclasses.dataclass(frozen=True)
class TileSpec:
    """Tile-decomposition policy for oversized images (halo-tiled PH).

    Read by :meth:`repro_torch.ph.PHEngine.run_tiled` / ``run_delta``:
    ``grid`` (else ``choose_grid`` under ``max_tile_pixels``) and the
    initial per-tile root/candidate capacities, which regrow on tile
    overflow.  ``max_tile_pixels`` also decides ``should_tile``.
    """

    grid: tuple[int, int] | None = None    # (gr, gc); None = auto
    halo: int = 1                          # only 1 is supported (3x3 stencil)
    max_features_per_tile: int = 2048
    max_candidates_per_tile: int = 8192
    max_tile_pixels: int = 1 << 20         # auto-grid budget + routing bound

    def __post_init__(self):
        if isinstance(self.grid, list):
            object.__setattr__(self, "grid", tuple(self.grid))
        if self.grid is not None:
            g = self.grid
            if (len(g) != 2 or not all(isinstance(x, int) and x >= 1
                                       for x in g)):
                raise ValueError(f"grid must be (gr, gc) of ints >= 1, "
                                 f"got {self.grid!r}")
        if self.halo != 1:
            raise ValueError(f"only halo=1 is supported (3x3 stencil), "
                             f"got {self.halo}")
        for field in ("max_features_per_tile", "max_candidates_per_tile",
                      "max_tile_pixels"):
            v = getattr(self, field)
            if not isinstance(v, int) or v < 1:
                raise ValueError(f"{field} must be a positive int, got {v!r}")

    def replace(self, **changes) -> "TileSpec":
        return dataclasses.replace(self, **changes)

    def plan_fields(self) -> tuple:
        """The fields that affect compiled tiled executables (capacities
        are keyed separately by the engine, like max_features)."""
        return (self.grid, self.halo)


@dataclasses.dataclass(frozen=True)
class ServeSpec:
    """Serving-daemon policy of :class:`repro_torch.serving.PHServer`:
    the bucket set a request is padded into, the fixed dispatch batch
    (``batch_cap`` rows, padded by repeating a real request), the
    per-bucket queue bound, the coalescing tick interval, and the
    admission policy at a full queue (``"reject"`` or ``"block"``).
    :meth:`repro_torch.ph.PHEngine.warmup` builds one single and one
    ``batch_cap`` plan per bucket and walks their regrow chains."""

    buckets: tuple[tuple[int, int], ...] | None = None
    batch_cap: int = 4
    max_queue: int = 64
    tick_interval_s: float = 0.002
    admission: str = "reject"

    def __post_init__(self):
        if self.buckets is not None:
            norm = []
            for b in self.buckets:
                if isinstance(b, (int,)):
                    b = (b, b)
                b = tuple(int(x) for x in b)
                if len(b) != 2 or not all(x >= 1 for x in b):
                    raise ValueError(f"bucket must be a size or (H, W) of "
                                     f"ints >= 1, got {b!r}")
                norm.append(b)
            if len(set(norm)) != len(norm):
                raise ValueError(f"duplicate serve buckets in {norm}")
            # Smallest-first, so bucket assignment picks the tightest fit.
            object.__setattr__(self, "buckets",
                               tuple(sorted(norm,
                                            key=lambda s: (s[0] * s[1], s))))
        for field in ("batch_cap", "max_queue"):
            v = getattr(self, field)
            if not isinstance(v, int) or v < 1:
                raise ValueError(f"{field} must be a positive int, got {v!r}")
        if not (isinstance(self.tick_interval_s, (int, float))
                and self.tick_interval_s >= 0):
            raise ValueError(f"tick_interval_s must be >= 0, "
                             f"got {self.tick_interval_s!r}")
        if self.admission not in ADMISSION_POLICIES:
            raise ValueError(f"admission must be one of "
                             f"{ADMISSION_POLICIES}, got {self.admission!r}")

    def replace(self, **changes) -> "ServeSpec":
        return dataclasses.replace(self, **changes)

    def plan_fields(self) -> tuple:
        """The fields that decide compiled batch shapes: the bucket set
        and the fixed dispatch batch size.  Queue depth, tick interval,
        and admission policy are host-side scheduling and excluded (like
        ``prefetch_rounds``)."""
        return (self.buckets, self.batch_cap)


@dataclasses.dataclass(frozen=True)
class OverlapSpec:
    """Host<->device overlap policy (:mod:`repro_torch.ph.overlap`):
    ``staging_depth`` rounds in flight ahead of the harvest, ``donate``
    (engine-built batches staged in reused pool buffers), ``async_overflow``
    (pinned uploads on a copy stream, the computation and overflow check
    deferred to ``resolve()``, results streamed to pinned host memory) and
    ``async_harvest`` (the pipeline resolves rounds on a harvest thread).
    Every overlapped path is bit-identical to the synchronous one."""

    enabled: bool = True
    staging_depth: int = 2
    donate: bool = True
    async_overflow: bool = True
    async_harvest: bool = True

    def __post_init__(self):
        if not isinstance(self.staging_depth, int) or self.staging_depth < 1:
            raise ValueError(f"staging_depth must be a positive int, "
                             f"got {self.staging_depth!r}")
        for field in ("enabled", "donate", "async_overflow", "async_harvest"):
            v = getattr(self, field)
            if not isinstance(v, bool):
                raise ValueError(f"{field} must be a bool, got {v!r}")

    def replace(self, **changes) -> "OverlapSpec":
        return dataclasses.replace(self, **changes)

    def plan_fields(self) -> tuple:
        """``donate`` selects compiled executables (input/output buffer
        aliasing); ring depth and the async toggles are host-side
        scheduling, like ``prefetch_rounds``."""
        return (self.enabled, self.donate)


@dataclasses.dataclass(frozen=True)
class DeltaSpec:
    """Delta-recompute / frame-cache policy of
    :meth:`repro_torch.ph.PHEngine.run_delta`: ``enabled`` (else every
    frame runs cold through ``run_tiled``), the frame store's LRU depth,
    the tile hash, and ``verify`` (byte-compare hash-clean tiles, so a
    digest collision recomputes instead of reusing state)."""

    enabled: bool = True
    cache_entries: int = 4
    hash_algo: str = "blake2b"
    verify: bool = False

    def __post_init__(self):
        if not isinstance(self.cache_entries, int) or self.cache_entries < 1:
            raise ValueError(f"cache_entries must be a positive int, "
                             f"got {self.cache_entries!r}")
        if self.hash_algo not in HASH_ALGOS:
            raise ValueError(f"hash_algo must be one of {HASH_ALGOS}, "
                             f"got {self.hash_algo!r}")

    def replace(self, **changes) -> "DeltaSpec":
        return dataclasses.replace(self, **changes)

    def plan_fields(self) -> tuple:
        """Only ``enabled`` selects compiled programs (the split
        phase-AB / scatter-merge pair vs the fused cold plan); cache
        depth, hash algorithm, and verify are host-side policy."""
        return (self.enabled,)


class FilterLevel(str, enum.Enum):
    """Variant-2 background filtering level (paper Table 1)."""

    VANILLA = "vanilla"            # no filtering
    LIGHT = "filter_light"         # 0.3 x (median + 2 MAD-sigma)
    STD = "filter_std"             # 1.0 x
    HEAVY = "filter_heavy"         # 1.3 x

    def __str__(self) -> str:  # argparse/json friendliness
        return self.value


@dataclasses.dataclass(frozen=True)
class PHConfig:
    """Frozen configuration of one PH computation family.

    Capacity fields (``max_features``, ``max_candidates``) are *initial*
    capacities: with ``auto_regrow`` on, the engine doubles them on overflow
    up to ``regrow_*_ceiling`` (``None`` = the image pixel count, at which
    overflow is impossible) at most ``max_regrows`` times.
    """

    # Diagram / merge-sweep capacities (static shapes; padded).
    max_features: int = 8192
    max_candidates: int = 32768
    # Filtration direction: "superlevel" (births at maxima — the paper's
    # astronomical-source workload) or "sublevel" (births at minima;
    # floating dtypes only).  Implemented as an exact boundary negation,
    # so sublevel(x) is bit-identical to superlevel(-x) with flipped
    # signs; part of stage_signature()/plan_key — plans and delta-cache
    # entries never cross filtrations.
    filtration: str = "superlevel"         # "superlevel" | "sublevel"
    # Algorithm variants / stage implementations (the stage graph: phase A
    # pointers+flags, phase B label resolution, phase C merge — every
    # combination is bit-identical, only the compiled program changes).
    candidate_mode: str = "exact"          # "exact" | "paper"
    merge_impl: str = "scan"               # "scan" | "boruvka"
    # Phase-C total-order keys: "packed" bit-casts (value, index) into
    # monotone int64 keys (no full-image argsort; any <= 32-bit dtype),
    # "rank" materializes dense argsort ranks.  Bit-identical either way.
    merge_keys: str = "packed"             # "packed" | "rank"
    # phase_a_impl "fused": the repro_torch.kernels.ph_phase_a kernel (CUDA
    # per use_pallas, its plain version on CPU tensors) + compacted-frontier
    # phase B.  "pooled": the unfused baseline — arg-maxpool pointers
    # through the repro_torch.kernels.maxpool kernel + dense phase B.
    phase_a_impl: str = "fused"            # "fused" | "pooled"
    # Strip height of the fused phase-A kernel (= its snap block rows and
    # the frontier compaction factor: the frontier is ~2/strip_rows of n).
    strip_rows: int = 8
    # phase_c_impl "fused": the repro_torch.kernels.ph_phase_c compact merge
    # — Boruvka over the top-max_features root instance with the best-edge
    # reduction (CUDA per use_pallas, its plain version on CPU tensors).
    # "xla": the plain full-image Boruvka merge.  Only
    # consulted when merge_impl="boruvka" (the scan merge has no phase-C
    # kernel); bit-identical either way.
    phase_c_impl: str = "fused"            # "fused" | "xla"
    # Edge-block size of the TPU phase-C kernel (no effect in the port;
    # carried for the autotune cache's schema).
    phase_c_block: int = 1024
    # Blockwise tournament width of the phase-C top-k selections (each
    # round keeps top-k of width*k candidates; any width >= 2 is
    # bit-identical — the autotuner picks it per shape).
    tournament_width: int = 2
    # Autotuning: fold the cached tuned (strip_rows, phase_c_block,
    # tournament_width) and tile grid of each image shape family into the
    # engine's plans (a pure disk-cache read; a miss keeps these fields).
    # autotune_cache: the cache file (None = the port's default file).
    autotune: bool = False
    autotune_cache: str | None = None
    filter_level: FilterLevel = FilterLevel.VANILLA
    # Dtype policy: cast inputs before compute (None = keep input dtype).
    dtype: str | None = None
    # Kernel toggles: use_pallas=False selects the plain versions on the
    # card; interpret is the TPU kernels' interpret mode (no effect here).
    use_pallas: bool | None = None
    interpret: bool = False
    # Overflow auto-regrow policy.
    auto_regrow: bool = True
    regrow_factor: int = 2
    max_regrows: int = 8
    regrow_features_ceiling: int | None = None
    regrow_candidates_ceiling: int | None = None
    # Tile decomposition for oversized images (None = whole-image only).
    tile: TileSpec | None = None
    # Streaming heterogeneous-batch pipeline knobs.
    # bucket_rounding: how per-round shape buckets are formed from a mixed
    # dataset — "pow2" pads each dim up to the next power of two (few
    # compiled plans, images padded with -inf below the Variant-2
    # threshold), "exact" gives every distinct shape its own bucket (no
    # padding; what VANILLA rounds always use, since padding is only exact
    # under a finite threshold).
    bucket_rounding: str = "pow2"
    # prefetch_rounds: rounds the pipeline's background loader may stage
    # ahead of the computing round (0 = fully serial load->compute).
    prefetch_rounds: int = 1
    # Serving-daemon policy (None = engine not used for serving).  The
    # bucket set and batch cap decide which padded batch shapes compile
    # (and which plans PHEngine.warmup pre-traces); queue depth / tick /
    # admission are host-side.
    serve: ServeSpec | None = None
    # Delta-recompute policy for frame sequences (None = every run cold).
    # With a spec, run_delta/run_sequence hash tiles against a bounded LRU
    # frame cache and recompute only dirty tiles; the serving daemon adds
    # its exact-hash / near-duplicate cache tier on top.
    delta: DeltaSpec | None = None
    # Host<->device overlap policy (None = fully synchronous transfers).
    # With a spec, staging/compute/fetch pipeline: fused H2D staging with
    # buffer donation, deferred (async) overflow checks with speculative
    # dispatch, and a harvest thread draining async D2H result copies.
    overlap: OverlapSpec | None = None

    def __post_init__(self):
        if isinstance(self.filter_level, str) and \
                not isinstance(self.filter_level, FilterLevel):
            object.__setattr__(self, "filter_level",
                               FilterLevel(self.filter_level))
        if isinstance(self.tile, dict):
            object.__setattr__(self, "tile", TileSpec(**self.tile))
        if self.tile is not None and not isinstance(self.tile, TileSpec):
            raise ValueError(f"tile must be a TileSpec or None, "
                             f"got {type(self.tile).__name__}")
        if isinstance(self.serve, dict):
            object.__setattr__(self, "serve", ServeSpec(**self.serve))
        if self.serve is not None and not isinstance(self.serve, ServeSpec):
            raise ValueError(f"serve must be a ServeSpec or None, "
                             f"got {type(self.serve).__name__}")
        if isinstance(self.delta, dict):
            object.__setattr__(self, "delta", DeltaSpec(**self.delta))
        if self.delta is not None and not isinstance(self.delta, DeltaSpec):
            raise ValueError(f"delta must be a DeltaSpec or None, "
                             f"got {type(self.delta).__name__}")
        if isinstance(self.overlap, dict):
            object.__setattr__(self, "overlap", OverlapSpec(**self.overlap))
        if self.overlap is not None and \
                not isinstance(self.overlap, OverlapSpec):
            raise ValueError(f"overlap must be an OverlapSpec or None, "
                             f"got {type(self.overlap).__name__}")
        if self.filtration not in FILTRATIONS:
            raise ValueError(f"filtration must be one of {FILTRATIONS}, "
                             f"got {self.filtration!r}")
        if self.filtration == "sublevel" and self.dtype in ("int32",):
            raise ValueError(
                "filtration='sublevel' requires a floating dtype "
                "(integer negation overflows at the minimum); pick a "
                "float dtype or leave dtype=None with float inputs")
        if self.candidate_mode not in CANDIDATE_MODES:
            raise ValueError(f"candidate_mode must be one of "
                             f"{CANDIDATE_MODES}, got {self.candidate_mode!r}")
        if self.merge_impl not in MERGE_IMPLS:
            raise ValueError(f"merge_impl must be one of {MERGE_IMPLS}, "
                             f"got {self.merge_impl!r}")
        if self.merge_keys not in MERGE_KEYS:
            raise ValueError(f"merge_keys must be one of {MERGE_KEYS}, "
                             f"got {self.merge_keys!r}")
        if self.phase_a_impl not in PHASE_A_IMPLS:
            raise ValueError(f"phase_a_impl must be one of {PHASE_A_IMPLS}, "
                             f"got {self.phase_a_impl!r}")
        if not isinstance(self.strip_rows, int) or self.strip_rows < 1:
            raise ValueError(f"strip_rows must be a positive int, "
                             f"got {self.strip_rows!r}")
        if self.phase_c_impl not in PHASE_C_IMPLS:
            raise ValueError(f"phase_c_impl must be one of {PHASE_C_IMPLS}, "
                             f"got {self.phase_c_impl!r}")
        if not isinstance(self.phase_c_block, int) or self.phase_c_block < 1:
            raise ValueError(f"phase_c_block must be a positive int, "
                             f"got {self.phase_c_block!r}")
        if not isinstance(self.tournament_width, int) or \
                self.tournament_width < 2:
            raise ValueError(f"tournament_width must be an int >= 2, "
                             f"got {self.tournament_width!r}")
        if self.dtype not in DTYPES:
            raise ValueError(f"dtype must be one of {DTYPES}, "
                             f"got {self.dtype!r}")
        if self.bucket_rounding not in BUCKET_ROUNDINGS:
            raise ValueError(f"bucket_rounding must be one of "
                             f"{BUCKET_ROUNDINGS}, "
                             f"got {self.bucket_rounding!r}")
        if not isinstance(self.prefetch_rounds, int) or \
                self.prefetch_rounds < 0:
            raise ValueError(f"prefetch_rounds must be an int >= 0, "
                             f"got {self.prefetch_rounds!r}")
        for field in ("max_features", "max_candidates", "regrow_factor"):
            v = getattr(self, field)
            if not isinstance(v, int) or v < 1:
                raise ValueError(f"{field} must be a positive int, got {v!r}")
        if self.regrow_factor < 2:
            raise ValueError("regrow_factor must be >= 2")
        if self.max_regrows < 0:
            raise ValueError("max_regrows must be >= 0")
        if self.regrow_features_ceiling is not None and \
                self.regrow_features_ceiling < self.max_features:
            raise ValueError("regrow_features_ceiling < max_features")
        if self.regrow_candidates_ceiling is not None and \
                self.regrow_candidates_ceiling < self.max_candidates:
            raise ValueError("regrow_candidates_ceiling < max_candidates")

    # -- derived ----------------------------------------------------------

    def replace(self, **changes) -> "PHConfig":
        return dataclasses.replace(self, **changes)

    def stage_signature(self) -> tuple:
        """The stage-graph implementation choice, one tuple per stage.

        Phase A (pointer/flag generation + its strip height and backend),
        phase B (label resolution follows phase A: compacted frontier for
        "fused", dense doubling for "pooled"), phase C (merge reduction).
        Every signature computes bit-identical diagrams; the signature
        keys *compiled programs*, so it is embedded in :meth:`plan_key`.
        """
        return (("a", self.phase_a_impl, self.strip_rows, self.use_pallas,
                 self.interpret, self.filtration),
                ("b", "frontier" if self.phase_a_impl == "fused"
                 else "dense", self.candidate_mode),
                ("c", self.merge_impl, self.merge_keys, self.phase_c_impl,
                 self.phase_c_block, self.tournament_width))

    def plan_key(self) -> tuple:
        """The config fields that affect *compiled executables*.

        Regrow policy, filter level, and ``prefetch_rounds`` are host-side
        decisions and are deliberately excluded (plan caches are
        per-:class:`PHEngine`, so share one engine to reuse plans across
        those knobs).  The :meth:`stage_signature` is included — it selects
        the compiled stage programs; ``bucket_rounding`` is included — it
        decides which padded batch shapes get compiled.  Capacities are
        passed separately by the engine (regrow re-dispatches at larger
        capacities under the same config).
        """
        return (self.stage_signature(), self.dtype, self.bucket_rounding,
                self.tile.plan_fields() if self.tile is not None else None,
                self.serve.plan_fields() if self.serve is not None else None,
                self.delta.plan_fields() if self.delta is not None else None,
                self.overlap.plan_fields() if self.overlap is not None
                else None)

    # -- construction / serialization -------------------------------------

    @classmethod
    def from_flags(cls, args: Any, **overrides) -> "PHConfig":
        """Build from an argparse ``Namespace`` (or any attribute bag), as
        ``repro.ph.PHConfig.from_flags`` does.

        Recognized attributes (all optional): ``max_features``,
        ``max_candidates``, ``candidate_mode``, ``filtration``,
        ``merge_impl``, ``merge_keys``, ``phase_a_impl``, ``strip_rows``,
        ``phase_c_impl``, ``phase_c_block``, ``tournament_width``,
        ``autotune``, ``autotune_cache``, ``filter`` or ``filter_level``,
        ``dtype``, ``use_pallas``, ``interpret``,
        ``no_regrow``/``auto_regrow``, ``max_regrows``, ``regrow_factor``,
        the regrow ceilings, ``bucket_rounding``,
        ``prefetch_rounds``/``no_prefetch``; tiling: ``tile``,
        ``tile_grid``, ``tile_max_features``, ``tile_max_candidates``,
        ``max_tile_pixels``; serving (carried as data): ``serve``,
        ``serve_buckets`` (sizes or ``"HxW"`` strings), ``serve_batch_cap``,
        ``serve_max_queue``, ``serve_tick_ms``, ``serve_admission``; delta:
        ``delta``, ``delta_cache_entries``, ``delta_hash``,
        ``delta_verify``; overlap: ``overlap``, ``overlap_depth``,
        ``no_donate``, ``no_async_overflow``, ``no_async_harvest`` (each
        sub-flag implies the spec).
        """
        kw: dict[str, Any] = {}
        for name in ("max_features", "max_candidates", "candidate_mode",
                     "filtration", "merge_impl", "merge_keys", "phase_a_impl",
                     "strip_rows", "phase_c_impl", "phase_c_block",
                     "tournament_width", "autotune", "autotune_cache",
                     "dtype", "use_pallas", "interpret",
                     "max_regrows", "auto_regrow", "regrow_factor",
                     "regrow_features_ceiling", "regrow_candidates_ceiling",
                     "bucket_rounding", "prefetch_rounds"):
            v = getattr(args, name, None)
            if v is not None:
                kw[name] = v
        level = getattr(args, "filter_level", None) or getattr(
            args, "filter", None)
        if level is not None:
            kw["filter_level"] = FilterLevel(level)
        if getattr(args, "no_regrow", False):
            kw["auto_regrow"] = False
        if getattr(args, "no_prefetch", False):
            kw["prefetch_rounds"] = 0
        tile_kw: dict[str, Any] = {}
        for attr, field in (("tile_grid", "grid"),
                            ("tile_max_features", "max_features_per_tile"),
                            ("tile_max_candidates",
                             "max_candidates_per_tile"),
                            ("max_tile_pixels", "max_tile_pixels")):
            v = getattr(args, attr, None)
            if v is not None:
                tile_kw[field] = v
        if tile_kw.get("grid") is not None:
            tile_kw["grid"] = parse_grid(tile_kw["grid"])
        if tile_kw or getattr(args, "tile", False):
            kw["tile"] = TileSpec(**tile_kw)
        serve_kw: dict[str, Any] = {}
        for attr, field in (("serve_buckets", "buckets"),
                            ("serve_batch_cap", "batch_cap"),
                            ("serve_max_queue", "max_queue"),
                            ("serve_admission", "admission")):
            v = getattr(args, attr, None)
            if v is not None:
                serve_kw[field] = v
        tick_ms = getattr(args, "serve_tick_ms", None)
        if tick_ms is not None:
            serve_kw["tick_interval_s"] = float(tick_ms) / 1e3
        if serve_kw.get("buckets") is not None:
            serve_kw["buckets"] = tuple(
                parse_grid(b) if isinstance(b, str) and "x" in b.lower()
                else int(b) for b in serve_kw["buckets"])
        if serve_kw or getattr(args, "serve", False):
            kw["serve"] = ServeSpec(**serve_kw)
        delta_kw: dict[str, Any] = {}
        for attr, field in (("delta_cache_entries", "cache_entries"),
                            ("delta_hash", "hash_algo"),
                            ("delta_verify", "verify")):
            v = getattr(args, attr, None)
            if v is not None:
                delta_kw[field] = v
        if delta_kw or getattr(args, "delta", False):
            kw["delta"] = DeltaSpec(**delta_kw)
        overlap_kw: dict[str, Any] = {}
        v = getattr(args, "overlap_depth", None)
        if v is not None:
            overlap_kw["staging_depth"] = int(v)
        if getattr(args, "no_donate", False):
            overlap_kw["donate"] = False
        if getattr(args, "no_async_overflow", False):
            overlap_kw["async_overflow"] = False
        if getattr(args, "no_async_harvest", False):
            overlap_kw["async_harvest"] = False
        if overlap_kw or getattr(args, "overlap", False):
            kw["overlap"] = OverlapSpec(**overlap_kw)
        kw.update(overrides)
        return cls(**kw)

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["filter_level"] = self.filter_level.value
        return json.dumps(d, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "PHConfig":
        d = json.loads(s)
        d["filter_level"] = FilterLevel(d.get("filter_level", "vanilla"))
        return cls(**d)
