#!/usr/bin/env python3
"""Time this tree's best-edge and distance CUDA kernels against an earlier
tree's designs of the same kernels, on one card, in one process.

    git archive <commit> src/repro_torch/kernels | tar -x -C build/parent
    python3 tools/compare_designs.py build/parent

``build/parent`` is any directory that holds an earlier tree's
``src/repro_torch/kernels`` (``build/`` is git-ignored).  Both designs of
each kernel are built from their sources together, held to the plain
version on the same inputs as ``chip_smoke.py`` (the main path's first
Boruvka round at 4096², and the mixed survey batch's distance tables),
and timed in turns (earlier, this, this, earlier) twice: one call's time
(``chip_smoke.cuda_ms``) and device time (``chip_smoke.device_ms``).  It
prints one JSON line per kernel, the nvidia-smi line, and last
``{"ok": true, ...}``; any disagreement raises.
"""
from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

KERNELS = {"ph_phase_c_best_edge": "ph_phase_c", "ph_distance": "ph_distance"}


def load_wrapper(parent: Path, package: str):
    """The earlier tree's ``kernels/<package>/kernel.py`` as a module of its
    own, building from the earlier tree's ``csrc``."""
    path = parent / "src" / "repro_torch" / "kernels" / package / "kernel.py"
    if not path.exists():
        raise FileNotFoundError(f"no earlier wrapper at {path}")
    spec = importlib.util.spec_from_file_location(f"earlier_{package}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def in_turns(earlier_fn, this_fn) -> dict:
    """Both designs timed in turns (earlier, this, this, earlier), first
    by one call's time, then by device time."""
    out = {}
    for timer, key in ((cs.cuda_ms, "ms"), (cs.device_ms, "device_ms")):
        e1, t1, t2, e2 = (timer(fn) for fn in (earlier_fn, this_fn, this_fn,
                                               earlier_fn))
        out[key] = {"earlier": (e1 + e2) / 2, "this": (t1 + t2) / 2,
                    "turns": {"earlier": [e1, e2], "this": [t1, t2]}}
    return out


def main(argv: list[str]) -> int:
    import torch
    if not torch.cuda.is_available():
        print("compare_designs: no CUDA device is available", file=sys.stderr)
        return 1
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    parent = Path(argv[0]).resolve()

    from repro_torch.data import astro
    from repro_torch.kernels import _build
    from repro_torch.kernels.ph_distance import kernel as kd
    from repro_torch.kernels.ph_distance import ref as rd
    from repro_torch.kernels.ph_phase_c import kernel as kc
    from repro_torch.kernels.ph_phase_c import ops as oc
    from repro_torch.kernels.ph_phase_c import ref as rc
    from repro_torch.ph import PHConfig, PHEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    this = {"ph_phase_c_best_edge": kc, "ph_distance": kd}
    earlier = {name: load_wrapper(parent, pkg)
               for name, pkg in KERNELS.items()}
    build_s = _build.build_all([m.LIBRARY for m in (*this.values(),
                                                    *earlier.values())])
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"phase": "build", "seconds": round(build_s, 3),
                      "earlier": str(parent)}), flush=True)

    # The main path's first Boruvka round, captured as chip_smoke.py does.
    cfg = PHConfig(**cs.MAIN_CONFIG)
    engine = PHEngine(cfg)
    frame = astro.generate_image(0, cs.MAIN_SIZE)
    engine.run(frame)                        # settles the capacities
    captured, kernel_fn = [], kc.best_edge_reduce

    def capture(key, ra_, rb_, nv):
        if not captured:
            captured.append((key.clone(), ra_.clone(), rb_.clone(), nv))
        return kernel_fn(key, ra_, rb_, nv)

    oc.kernel.best_edge_reduce = capture
    try:
        engine.run(frame)
    finally:
        oc.kernel.best_edge_reduce = kernel_fn
    args = captured[0]
    want = rc.best_edge_reduce(*args)
    for label, mod in (("this", kc), ("earlier",
                                      earlier["ph_phase_c_best_edge"])):
        got = mod.best_edge_reduce(*args)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"{label} best-edge != plain version")
    key = args[0]
    timed = in_turns(
        lambda: earlier["ph_phase_c_best_edge"].best_edge_reduce(*args),
        lambda: kc.best_edge_reduce(*args))
    print(json.dumps({"phase": "best_edge", "edges": key.numel(),
                      "live_edges": int((key > torch.iinfo(
                          key.dtype).min).sum()), "nv": args[3],
                      "key_dtype": str(key.dtype), "bitwise_equal": True,
                      **timed}), flush=True)

    # The mixed survey batch's distance tables, as chip_smoke.py makes them.
    mixed = PHEngine(cfg)
    mres = mixed.run_batch(cs.survey_frames())
    birth, death, p_birth = mixed._stack_diagrams(mres)
    birth, death = birth.float(), death.float()
    pts, dirs = rd.diagram_projections(birth, death, p_birth,
                                       n_dirs=cs.N_DIRS)
    pts, dirs = pts.contiguous(), dirs.contiguous()
    prof = rd.persistence_profiles(birth, death, p_birth,
                                   merge_keys="packed").contiguous()
    want_sw, want_bn = rd.distance_matrix(pts, dirs, prof)
    for label, mod in (("this", kd), ("earlier", earlier["ph_distance"])):
        sw, bn = mod.distance_matrix(pts, dirs, prof)
        if not (torch.equal(bn, want_bn)
                and torch.allclose(sw, want_sw, rtol=1e-5, atol=0.0)):
            raise AssertionError(f"{label} distance != plain version")
    timed = in_turns(
        lambda: earlier["ph_distance"].distance_matrix(pts, dirs, prof),
        lambda: kd.distance_matrix(pts, dirs, prof))
    print(json.dumps({"phase": "distance", "shape": list(pts.shape),
                      "bn_bitwise_equal": True, **timed}), flush=True)

    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
