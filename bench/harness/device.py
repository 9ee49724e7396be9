"""The chip check and the device record of the result line."""
from __future__ import annotations

import sys


class NoChip(SystemExit):
    """Raised when the cell's cards are not there: exit code 3, no
    result line."""


def require_cuda(chips: int):
    """The first CUDA device, or exit with code 3 when
    ``torch.cuda.is_available()`` is false or fewer than ``chips`` cards
    are visible."""
    import torch
    if not torch.cuda.is_available():
        print("bench: no CUDA device", file=sys.stderr)
        raise NoChip(3)
    if torch.cuda.device_count() < chips:
        print(f"bench: cell needs {chips} CUDA devices, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        raise NoChip(3)
    return torch.device("cuda", 0)


def record(device, chips: int, peak_bytes: int) -> dict:
    import torch
    if device.type == "cuda":
        return {"platform": "gpu",
                "kind": torch.cuda.get_device_name(device),
                "count": chips, "memory_peak_bytes": int(peak_bytes)}
    return {"platform": device.type, "kind": device.type, "count": chips,
            "memory_peak_bytes": int(peak_bytes)}


def synchronize(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device) -> int:
    """The peak so far, then a fresh peak count."""
    import torch
    if device.type != "cuda":
        return 0
    peak = torch.cuda.max_memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    return peak


def peak(device) -> int:
    import torch
    return torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
