#!/usr/bin/env python3
"""Time this tree's phase-A, best-edge and distance CUDA kernels against
an earlier tree's designs of the same kernels, on one card, in one process.

    git archive <commit> src/repro_torch/kernels | tar -x -C build/parent
    python3 tools/compare_designs.py build/parent

``build/parent`` is any directory that holds an earlier tree's
``src/repro_torch/kernels`` (``build/`` is git-ignored).  Both designs of
each kernel are built from their sources together, held to the plain
version on the same inputs as ``chip_smoke.py`` (phase A on the 4096²
frame, the mixed survey batch's 5 x 2048² bucket and a 10240² frame, all
at S = 8; the main path's first Boruvka round at 4096²; the mixed survey
batch's distance tables), and timed in turns (earlier, this, this,
earlier) twice: one call's time (``chip_smoke.cuda_ms``) and device time
(``chip_smoke.device_ms``).  Where the earlier phase-A source is the
two-launch design (``pointer_mask_kernel`` + ``snap_kernel``), a copy of
it under ``build/`` gains one C entry per kernel, and the two are timed
apart at 4096² by device time.  It prints one JSON line per kernel and
shape, the nvidia-smi line, and last ``{"ok": true, ...}``; any
disagreement raises.
"""
from __future__ import annotations

import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

KERNELS = {"ph_phase_a": "ph_phase_a", "ph_phase_c_best_edge": "ph_phase_c",
           "ph_distance": "ph_distance"}
# C entries that launch the two-launch design's kernels one at a time, at
# its own launch shapes (float32, one image); appended to a copy of its
# source, where the anonymous-namespace kernels are in scope.
SPLIT_ENTRIES = r"""
extern "C" int split_pointer_mask_launch(const void* image, int H, int W,
                                         void* hop, void* mask,
                                         void* stream) {
  const long long total = (long long)H * W;
  const long long want = (total + 255) / 256;
  const int blocks = (int)(want < 132LL * 64 ? want : 132LL * 64);
  pointer_mask_kernel<float><<<blocks, 256, 0, (cudaStream_t)stream>>>(
      (const float*)image, total, H, W, (int*)hop, (int*)mask);
  return (int)cudaGetLastError();
}
extern "C" int split_snap_launch(const void* hop, int H, int W, int S,
                                 void* ptr, void* stream) {
  const size_t bytes = (size_t)S * W * sizeof(int);
  const int use_shared = bytes <= kMaxSharedBytes;
  const size_t smem = use_shared ? bytes : 0;
  cudaError_t err = cudaFuncSetAttribute(
      snap_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  snap_kernel<<<dim3((H + S - 1) / S, 1), 1024, smem,
                (cudaStream_t)stream>>>((const int*)hop, H, W, S,
                                        use_shared, (int*)ptr);
  return (int)cudaGetLastError();
}
"""


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


def split_library(parent: Path):
    """A copy of the earlier two-launch phase-A source under ``build/``
    with ``SPLIT_ENTRIES`` appended, as a library of its own; None when
    the earlier source is not that design."""
    from repro_torch.kernels import _build
    src = (parent / "src" / "repro_torch" / "kernels" / "ph_phase_a"
           / "csrc" / "phase_a.cu").read_text()
    if "snap_kernel" not in src or "pointer_mask_kernel" not in src:
        return None
    copy = _build.BUILD_DIR.parent / "compare" / "phase_a_split.cu"
    copy.parent.mkdir(parents=True, exist_ok=True)
    copy.write_text(src + SPLIT_ENTRIES)
    _p, _i = ctypes.c_void_p, ctypes.c_int
    return _build.CudaLibrary(
        copy, {"split_pointer_mask_launch": [_p, _i, _i, _p, _p, _p],
               "split_snap_launch": [_p, _i, _i, _i, _p, _p]},
        error_fn="phase_a_error_string")


def two_launch_split(lib, x, s: int) -> dict:
    """Device time of each of the two-launch design's kernels on a float32
    image ``x``, and of both back to back, against the plain version."""
    import torch
    from repro_torch.kernels.ph_phase_a import ref as ra
    h, w = x.shape
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    hop, ptr, mask = (torch.empty(h * w, dtype=torch.int32,
                                  device=x.device) for _ in range(3))

    def pointer_mask():
        lib.call("split_pointer_mask_launch", x.data_ptr(), h, w,
                 hop.data_ptr(), mask.data_ptr(), stream())

    def snap():
        lib.call("split_snap_launch", hop.data_ptr(), h, w, s,
                 ptr.data_ptr(), stream())

    pointer_mask()
    snap()
    want_ptr, want_mask = ra.phase_a(x, strip_rows=s)
    if not (torch.equal(ptr, want_ptr) and torch.equal(mask, want_mask)):
        raise AssertionError("two-launch split != plain version")
    pm_ms, snap_ms = cs.device_ms(pointer_mask), cs.device_ms(snap)
    return {"pointer_mask_device_ms": pm_ms, "snap_device_ms": snap_ms,
            "both_device_ms": cs.device_ms(lambda: (pointer_mask(), snap()))}


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
    from repro_torch.kernels.ph_phase_a import kernel as ka
    from repro_torch.kernels.ph_phase_a import ref as ra
    from repro_torch.kernels.ph_distance import kernel as kd
    from repro_torch.kernels.ph_distance import ref as rd
    from repro_torch.kernels.ph_phase_c import kernel as kc
    from repro_torch.kernels.ph_phase_c import ops as oc
    from repro_torch.kernels.ph_phase_c import ref as rc
    from repro_torch.ph import PHConfig, PHEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    this = {"ph_phase_a": ka, "ph_phase_c_best_edge": kc, "ph_distance": kd}
    earlier = {name: load_wrapper(parent, pkg)
               for name, pkg in KERNELS.items()}
    split = split_library(parent)
    build_s = _build.build_all([m.LIBRARY for m in (*this.values(),
                                                    *earlier.values())]
                               + ([split] if split else []))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"phase": "build", "seconds": round(build_s, 3),
                      "earlier": str(parent)}), flush=True)

    # Phase A at S = 8: the 4096² frame, the survey batch's bucket, and a
    # 10240² frame (its strips take this design's cluster regime).
    frame = astro.generate_image(0, cs.MAIN_SIZE)
    inputs = {"4096²": torch.from_numpy(frame).cuda(),
              "5x2048² bucket": cs.survey_bucket(torch.device("cuda")),
              f"{cs.PHASE_A_WIDE}²": torch.from_numpy(astro.generate_image(
                  0, cs.PHASE_A_WIDE)).cuda()}
    for label, x in inputs.items():
        want = ra.phase_a(x, strip_rows=8)
        for name, mod in (("this", ka), ("earlier", earlier["ph_phase_a"])):
            got = mod.phase_a(x, strip_rows=8)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"{name} phase A != plain on {label}")
        del want
        timed = in_turns(
            lambda: earlier["ph_phase_a"].phase_a(x, strip_rows=8),
            lambda: ka.phase_a(x, strip_rows=8))
        line = {"phase": "phase_a", "input": label, "shape": list(x.shape),
                "dtype": str(x.dtype), "strip_rows": 8,
                "layout": ka.strip_layout(8, x.shape[-1]),
                "bitwise_equal": True, "bound_ms": cs.phase_a_bound_ms(x),
                **timed}
        if split is not None and label == "4096²":
            line["earlier_split"] = two_launch_split(split, x, 8)
        print(json.dumps(line), flush=True)
    del inputs

    # The main path's first Boruvka round, captured as chip_smoke.py does.
    cfg = PHConfig(**cs.MAIN_CONFIG)
    engine = PHEngine(cfg)
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
