#!/usr/bin/env python3
"""Time this tree's flash attention kernel against an earlier tree's on
one card, in one process, at query offset 0 (the earlier design's only
case).

    git archive <commit> src/repro_torch/kernels | tar -x -C build/parent
    python3 tools/compare_flash.py build/parent

Both libraries are built from their sources together and held to the
plain version on the same inputs: ``chip_smoke.py``'s timed shape
(``FLASH_SHAPE``: 4 x 32 heads over 8 KV heads, 1024 tokens, hd 128,
causal bfloat16, on (B, S, H, hd) views) and its other main-path shapes.
Each shape is timed in turns (earlier, this, this, earlier), one call's
time (``chip_smoke.cuda_ms``) and device time (``chip_smoke.device_ms``).
It prints one JSON line per shape, the nvidia-smi line and last
``{"ok": true, ...}``; a disagreement raises.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke as cs  # noqa: E402
from compare_designs import in_turns, load_wrapper  # noqa: E402


def main(argv: list[str]) -> int:
    import torch
    if not torch.cuda.is_available():
        print("compare_flash: no CUDA device is available", file=sys.stderr)
        return 1
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as kfa
    from repro_torch.kernels.flash_attention import ref as rfa

    earlier = load_wrapper(Path(argv[0]).resolve(), "flash_attention")
    build_s = _build.build_all([kfa.LIBRARY, earlier.LIBRARY])
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"phase": "build", "seconds": round(build_s, 3),
                      "earlier": argv[0]}), flush=True)
    tol = cs.FLASH_TOL["bfloat16"]
    for shape in cs.FLASH_MAIN_SHAPES:
        b, h, kv, s, hd = shape
        q, k, v = (torch.randn(b, s, n, hd, device="cuda",
                               dtype=torch.bfloat16).transpose(1, 2)
                   for n in (h, kv, kv))
        want = rfa.attention(q, k, v, causal=True)
        for name, mod in (("this", kfa), ("earlier", earlier)):
            got = mod.flash_attention_fwd(q, k, v, causal=True)
            if not torch.allclose(got.float(), want.float(), atol=tol,
                                  rtol=tol):
                raise AssertionError(f"{name} flash != plain at {shape}")
        timed = in_turns(
            lambda: earlier.flash_attention_fwd(q, k, v, causal=True),
            lambda: kfa.flash_attention_fwd(q, k, v, causal=True))
        print(json.dumps({"kernel": "flash_attention", "shape": list(shape),
                          "q_offset": 0, **timed}), flush=True)
        del q, k, v, want
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
