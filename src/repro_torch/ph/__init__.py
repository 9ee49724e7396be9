"""Public facade of the port (the supported entry point).

    from repro_torch.ph import PHConfig, PHEngine, FilterLevel

    engine = PHEngine(PHConfig(merge_impl="boruvka",
                               filter_level=FilterLevel.STD))
    result = engine.run(image)          # on the CUDA device, auto-regrow
    batch = engine.run_batch(images)    # (B, H, W) or 2D images of any shapes
    sw, bottleneck = engine.distance_matrix(batch)
    tiled = engine.run_tiled(image)     # halo tiles (config.tile), same bits
    delta = engine.run_delta(frame)     # config.delta: dirty tiles only

``PHEngine(config, device="cpu")`` runs the plain PyTorch versions on the
host instead.
"""
from repro_torch.ph.config import (  # noqa: F401
    ADMISSION_POLICIES,
    CANDIDATE_MODES,
    DTYPES,
    HASH_ALGOS,
    MERGE_IMPLS,
    DeltaSpec,
    FilterLevel,
    OverlapSpec,
    PHConfig,
    ServeSpec,
    TileSpec,
    parse_grid,
)
from repro_torch.ph.engine import (  # noqa: F401
    PHEngine,
    PHResult,
    Plan,
    RegrowStats,
    threshold_dtype,
)
