"""PH-as-a-service on the PyTorch port: submit, await futures, read SLOs.

    python examples/serve_ph_torch.py                        # on the card
    PYTHONPATH=src python examples/serve_ph_torch.py --device cpu

The counterpart of ``examples/serve_ph.py`` through ``repro_torch``:
boots an in-process :class:`repro_torch.serving.PHServer` over one warmed
engine, submits a burst of mixed-shape star fields from a few client
threads (request-at-a-time traffic, not a prepared batch), and prints
per-bucket latency percentiles.  Each future resolves to exactly what
``engine.run(image)`` would return.  It takes the Boruvka merge, whose
best-edge rounds run the kernel on the card (the default scan merge is
sequential).  ``main`` returns what it prints,
with each served request's image id, size and result.

For the CLI twin see ``python -m repro_torch.launch.ph_serve``.
"""
import argparse
import sys
import threading
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.data import astro  # noqa: E402
from repro_torch.ph import PHConfig, PHEngine, ServeSpec  # noqa: E402
from repro_torch.serving import AdmissionError, PHServer  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    config = PHConfig(merge_impl="boruvka",
                      serve=ServeSpec(buckets=(64, 128), batch_cap=4,
                                      max_queue=32, admission="reject"))
    engine = PHEngine(config, device=args.device)
    out = {}

    with PHServer(engine) as server:
        info = server.warmup()     # build the warm plan pool
        out["warmup"] = {"plans": info["plans"], "seconds": info["seconds"]}
        print(f"warmup: {info['plans']} plans in {info['seconds']:.1f}s")

        rng = np.random.default_rng(0)
        served, rejected = [], []
        lock = threading.Lock()

        def client(cid, n=8):
            for i in range(n):
                with lock:
                    size = int(rng.integers(40, 129))
                image_id = cid * 100 + i
                img = astro.generate_image(image_id=image_id, size=size)
                try:
                    fut = server.submit(img)
                except AdmissionError as e:     # backpressure engaged
                    print(f"client {cid}: rejected, retry in "
                          f"{e.retry_after_s:.3f}s")
                    with lock:
                        rejected.append((image_id, size))
                    continue
                res = fut.result(timeout=120)   # a full PHResult
                with lock:
                    served.append((image_id, size, res))

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

        stats = server.stats()
    total = sum(int(res.diagram.count) for _, _, res in served)
    out.update(resolved=len(served), rejected=rejected, total_objects=total,
               steady_state_traces=stats["steady_state_traces"],
               served=served, buckets={})
    print(f"\nresolved {len(served)} requests "
          f"(total objects: {total}); "
          f"steady-state traces: {stats['steady_state_traces']}")
    for label, b in stats["buckets"].items():
        e2e = b["e2e_s"]
        if not e2e.get("count"):
            continue
        out["buckets"][label] = {"occupancy": b["occupancy"],
                                 **{q: e2e[q] for q in ("p50", "p95",
                                                        "p99")}}
        print(f"  bucket {label}: occupancy {b['occupancy']:.2f}, "
              f"e2e p50 {e2e['p50'] * 1e3:.1f}ms "
              f"p95 {e2e['p95'] * 1e3:.1f}ms "
              f"p99 {e2e['p99'] * 1e3:.1f}ms")
    return out


if __name__ == "__main__":
    main()
