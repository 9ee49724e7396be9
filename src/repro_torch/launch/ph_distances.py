"""CLI: pairwise diagram-distance matrices over a batch of frames.

The port's counterpart of ``repro.launch.ph_distances``: persistence
diagrams for a batch of synthetic astro frames (or any ``.npy`` stack)
through :class:`repro_torch.ph.PHEngine` (``run_batch``), then the
(B, B) sliced-Wasserstein and bottleneck-bound matrices through
``distance_matrix`` (the distance CUDA kernel on the card), printed as
the reference's JSON report::

  python -m repro_torch.launch.ph_distances \\
      --images 8 --size 256 --filtration sublevel --n-dirs 32

The engine runs on the CUDA device (``--device cuda:k`` picks the card,
``--device cpu`` runs it on the host).  ``--npy`` replaces the synthetic
frames with a (B, H, W) array from disk; ``--out`` writes the matrices
beside the report.  Engine knobs ride
:meth:`repro_torch.ph.PHConfig.from_flags`, so the CLI takes ``ph_run``'s
``--filtration``, ``--merge-impl`` and kernel toggles.  On the card pass
``--merge-impl boruvka``: the config's default scan merge is a sequential
sweep of small launches there.
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch.ph import PHConfig, PHEngine


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device of the engine (default: the CUDA "
                         "device; 'cpu' runs on the host)")
    ap.add_argument("--images", type=int, default=8)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--npy", help="load a (B, H, W) .npy stack instead of "
                                  "synthetic frames")
    ap.add_argument("--n-dirs", dest="n_dirs", type=int, default=16,
                    help="sliced-Wasserstein projection directions")
    ap.add_argument("--filter", default="vanilla",
                    choices=["vanilla", "filter_light", "filter_std",
                             "filter_heavy"])
    ap.add_argument("--filtration", default="superlevel",
                    choices=["superlevel", "sublevel"],
                    help="filtration direction the diagrams are computed "
                         "under (distances canonicalize internally, so "
                         "matrices of dual runs on negated frames match "
                         "bit-for-bit)")
    ap.add_argument("--max-features", type=int, default=8192)
    ap.add_argument("--max-candidates", type=int, default=32768)
    ap.add_argument("--merge-impl", choices=["scan", "boruvka"])
    ap.add_argument("--use-pallas", dest="use_pallas", action="store_true",
                    default=None,
                    help="run the hand-written CUDA kernels on CUDA tensors "
                         "(the default there; CPU tensors take the plain "
                         "versions)")
    ap.add_argument("--interpret", action="store_true")
    ap.add_argument("--out", help="write {sw, bottleneck} matrices as .npz")
    args = ap.parse_args(argv)

    config = PHConfig.from_flags(args)
    engine = PHEngine(config, device=args.device)

    if args.npy:
        frames = np.load(args.npy)
        if frames.ndim != 3:
            raise SystemExit(f"--npy needs a (B, H, W) stack, got shape "
                             f"{frames.shape}")
    else:
        from repro_torch.data.astro import generate_image
        frames = np.stack([generate_image(i, args.size)
                           for i in range(args.images)])

    res = engine.run_batch(frames)
    sw, bn = engine.distance_matrix(res, n_dirs=args.n_dirs)
    sw, bn = sw.cpu().numpy(), bn.cpu().numpy()

    iu = np.triu_indices(sw.shape[0], k=1)
    report = {
        "config": json.loads(config.to_json()),
        "images": int(sw.shape[0]),
        "n_dirs": args.n_dirs,
        "sw": {"mean": float(sw[iu].mean()) if iu[0].size else 0.0,
               "max": float(sw.max())},
        "bottleneck": {"mean": float(bn[iu].mean()) if iu[0].size else 0.0,
                       "max": float(bn.max())},
        "plan_cache": engine.plan_stats(),
    }
    if args.out:
        np.savez(args.out, sw=sw, bottleneck=bn)
        report["out"] = args.out
    print(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
