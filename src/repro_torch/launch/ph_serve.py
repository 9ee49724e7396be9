"""PH-as-a-service demo CLI: warmed daemon + synthetic client load.

`python -m repro_torch.launch.ph_serve --buckets 64 128 --clients 4 --requests 64`

The port's counterpart of ``repro.launch.ph_serve``: boots a
:class:`repro_torch.serving.PHServer` over one shared
:class:`~repro_torch.ph.engine.PHEngine` on the CUDA device
(``--device cuda:k`` picks the card, ``--device cpu`` runs it on the
host), builds the warm plan pool (``--no-warmup`` to skip and watch
cold-start builds instead), then drives it from ``--clients`` submitter
threads with random images whose shapes cycle below the configured
buckets.  The reference's flags, plus ``ph_run``'s ``--merge-impl``,
read by the same ``PHConfig.from_flags``.  Prints the serving stats JSON:
admission counters, per-bucket p50/p95/p99 queue-wait and end-to-end
latency, batch occupancy, plan-cache stats, and ``steady_state_traces``
(zero on a warmed server).
"""
from __future__ import annotations

import argparse
import json
import threading

import numpy as np

from repro_torch.ph import PHConfig, PHEngine
from repro_torch.serving import AdmissionError, PHServer


def client_shapes(buckets, rng, count):
    """Random 2D shapes fitting the bucket set (each at most its bucket,
    at least ~60% of it, so padding repair is always exercised)."""
    out = []
    for i in range(count):
        hb, wb = buckets[i % len(buckets)]
        out.append((int(rng.integers(max(2, int(hb * 0.6)), hb + 1)),
                    int(rng.integers(max(2, int(wb * 0.6)), wb + 1))))
    return out


def drive(server, shapes, *, seed=0, rejected_ok=True):
    """Submit every shape, resolve every future; returns (ok, rejected)."""
    rng = np.random.default_rng(seed)
    futs, rejected = [], 0
    for shape in shapes:
        img = rng.normal(size=shape).astype(np.float32)
        try:
            futs.append(server.submit(img))
        except AdmissionError:
            if not rejected_ok:
                raise
            rejected += 1
    for f in futs:
        f.result(timeout=300)
    return len(futs), rejected


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device of the engine (default: the CUDA "
                         "device; 'cpu' runs on the host)")
    ap.add_argument("--buckets", dest="serve_buckets", type=int, nargs="+",
                    default=[64, 128], help="serve bucket sizes (square)")
    ap.add_argument("--batch-cap", dest="serve_batch_cap", type=int,
                    default=4, help="fixed dispatch batch per bucket")
    ap.add_argument("--max-queue", dest="serve_max_queue", type=int,
                    default=64, help="per-bucket admission bound")
    ap.add_argument("--tick-ms", dest="serve_tick_ms", type=float,
                    default=2.0, help="coalescing tick interval")
    ap.add_argument("--admission", dest="serve_admission",
                    choices=["reject", "block"], default="reject")
    ap.add_argument("--clients", type=int, default=4,
                    help="concurrent submitter threads")
    ap.add_argument("--requests", type=int, default=64,
                    help="requests per client thread")
    ap.add_argument("--filter", default=None,
                    choices=["vanilla", "filter_std", "filter_database"])
    ap.add_argument("--merge-impl", choices=["scan", "boruvka"])
    ap.add_argument("--max-features", type=int, default=None)
    ap.add_argument("--max-candidates", type=int, default=None)
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip the warm plan pool (show cold-start builds)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    args.serve = True

    config = PHConfig.from_flags(args)
    engine = PHEngine(config, device=args.device)
    server = PHServer(engine)
    if not args.no_warmup:
        info = server.warmup()
        print(f"warmup: {json.dumps(info)}")

    buckets = config.serve.buckets
    totals = {"ok": 0, "rejected": 0}
    lock = threading.Lock()

    def run_client(cid):
        shapes = client_shapes(buckets, np.random.default_rng(
            args.seed + 1000 + cid), args.requests)
        ok, rej = drive(server, shapes, seed=args.seed + cid)
        with lock:
            totals["ok"] += ok
            totals["rejected"] += rej

    threads = [threading.Thread(target=run_client, args=(i,), daemon=True)
               for i in range(args.clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    server.drain(60)
    stats = server.stats()
    server.shutdown()
    print(json.dumps({"clients": args.clients,
                      "resolved": totals["ok"],
                      "client_rejected": totals["rejected"],
                      "device": str(engine.device),
                      "serve": stats}, indent=1))


if __name__ == "__main__":
    main()
