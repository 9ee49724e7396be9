"""Quickstart on the PyTorch port: 0-dim persistent homology of one
astronomical image.

    python examples/quickstart_torch.py                      # on the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

The counterpart of ``examples/quickstart.py`` through ``repro_torch``:
generates a synthetic star field (paper §6.2 recipe), computes its
persistence diagram through the ``repro_torch.ph`` facade, deliberately
starting from undersized capacities so the engine's overflow auto-regrow
kicks in, validates the result against the classical union-find oracle
and prints the most persistent objects.  It takes the Boruvka merge, so
that on the card phase A and the merge's best-edge rounds run the
hand-written kernels (the default scan merge is sequential; the diagram
is the same either way).  ``main`` returns what it prints, with the
diagram's rows.
"""
import argparse
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import persistence_oracle  # noqa: E402
from repro_torch.data import astro  # noqa: E402
from repro_torch.ph import PHConfig, PHEngine  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    img = astro.generate_image(image_id=42, size=256)
    out = {"image_shape": img.shape, "sky": float(np.median(img)),
           "max": float(img.max())}
    print(f"image: {img.shape}, sky≈{out['sky']:.1f}, max={out['max']:.1f}")

    # Undersized on purpose: the engine re-dispatches at doubled capacities
    # until the diagram fits.
    engine = PHEngine(PHConfig(max_features=512, max_candidates=1024,
                               merge_impl="boruvka"),
                      device=args.device)
    result = engine.run(img)
    out.update(components=int(result.diagram.count),
               regrow_attempts=result.regrow.attempts,
               capacities=(result.config.max_features,
                           result.config.max_candidates))
    print(f"\nPixHomology found {out['components']} components "
          f"(regrow attempts={out['regrow_attempts']}, final capacities="
          f"{out['capacities'][0]}/{out['capacities'][1]})")

    rows = result.to_array()
    out["rows"] = rows
    print("\ntop-10 by birth (birth, death, persistence, y, x):")
    w = img.shape[1]
    out["top10"] = []
    for b, d, pb, _ in rows[:10]:
        out["top10"].append((float(b), float(d), int(pb) // w, int(pb) % w))
        print(f"  birth={b:9.2f} death={d:9.2f} pers={b - d:9.2f} "
              f"at ({int(pb) // w:4d},{int(pb) % w:4d})")

    # Repeated same-shape calls reuse the built plan.
    engine.run(astro.generate_image(image_id=43, size=256))
    out["plan_cache"] = engine.plan_stats()
    print(f"\nplan cache: {out['plan_cache']}")

    # Validate against the classical algorithm: exact equality, stronger
    # than the paper's bottleneck-distance-0 check (fig 7).
    want = persistence_oracle(img)
    if not (rows.shape == want.shape and np.array_equal(rows, want)):
        raise AssertionError("the diagram differs from the union-find "
                             "oracle")
    out["validated_rows"] = rows.shape[0]
    print(f"\nvalidated: {rows.shape[0]} diagram rows match the classical "
          "union-find oracle exactly (bottleneck distance 0).")
    return out


if __name__ == "__main__":
    main()
