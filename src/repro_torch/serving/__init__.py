"""PH-as-a-service: async daemon, bucketed continuous batching, SLO metrics.

    from repro_torch.ph import PHConfig, PHEngine, ServeSpec
    from repro_torch.serving import PHServer

    engine = PHEngine(PHConfig(serve=ServeSpec(buckets=(64, 128))))
    with PHServer(engine) as srv:
        srv.warmup()                        # build the warm plan pool
        fut = srv.submit(image)             # Future[PHResult]
        diagram = fut.result().diagram      # a row of host tensors
    print(srv.stats())                      # p50/p95/p99, occupancy, ...

The engine, and so the daemon, runs on the CUDA device unless it was
made with ``device="cpu"``.  See :mod:`repro_torch.serving.server` for
the daemon and :mod:`repro_torch.serving.metrics` for the SLO
instrumentation; ``launch/ph_serve.py`` wires both into a CLI demo.
"""
from repro_torch.serving.metrics import (  # noqa: F401
    BucketMetrics,
    Reservoir,
    ServeMetrics,
    bucket_label,
)
from repro_torch.serving.server import (  # noqa: F401
    AdmissionError,
    PHServer,
)
