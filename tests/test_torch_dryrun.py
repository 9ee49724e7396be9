"""``repro_torch.launch.dryrun``: the reference's dry-run cell (gemma_7b,
train_4k on 8 ranks, ``tests/test_distribution.py``) on a fake process
group of 8 ranks, and a PH cell.

The LM cells run the whole step on fake tensors on the (2, 4) mesh:
gemma_7b's train step, whose roofline must have compute time, and one
cell of each of rwkv6_3b, recurrentgemma_2b and whisper_small; in each
the parameter bytes the memory tracker sees on the rank must be the sum
of the rank's blocks of every leaf as the sharding rules split them.  The tiled PH cell runs
``per_tile_cost`` at one tile under two image sizes.  Each runs in a
subprocess (the fake group is the process's default group), on the host
(``--device cpu``): without it the CLI takes the card, and raises where
there is none.
"""
import collections
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.distributed import sharding
from repro_torch.launch import steps

ROOT = Path(__file__).resolve().parents[1]


def _run(tmp_path, *args) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_DRYRUN_DEVICES="8")
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                           *args, "--out", str(tmp_path / "cell.json")],
                          capture_output=True, text=True, timeout=600,
                          env=env, cwd=ROOT)


def _dryrun(tmp_path, *args) -> dict:
    res = _run(tmp_path, *args, "--device", "cpu")
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-3000:]
    return json.loads((tmp_path / "cell.json").read_text())


def _rank_param_bytes(arch: str) -> int:
    """The bytes of the rank's block of every parameter on the (2, 4)
    mesh, as the sharding rules split them."""
    cfg = get_config(arch)
    mesh = collections.namedtuple("Mesh", ["shape"])(
        {"data": 2, "model": 4})
    shapes = steps.param_specs(cfg)
    specs = sharding.param_specs(shapes, mesh, cfg)
    want = 0
    for name, leaf in shapes.items():
        blocks = 1
        for part in specs[name]:
            if part is not None:
                blocks *= sharding.axes_size(mesh, part)
        want += leaf.numel() // blocks * leaf.dtype.itemsize
    return want


def test_dryrun_lm_cell_on_8_ranks(tmp_path):
    rec = _dryrun(tmp_path, "--arch", "gemma_7b", "--shape", "train_4k")
    assert rec["trace_ok"] and rec["roofline"]["compute_s"] > 0
    assert rec["devices"] == 8 and rec["mesh"] == "2x4"
    assert rec["memory"]["parameters"] == _rank_param_bytes("gemma_7b")
    assert rec["memory"]["peak_bytes"] >= sum(
        rec["memory"][k] for k in ("parameters", "optimizer_state"))
    # the mesh's collectives: FSDP gathers, TP reductions, gradient
    # reduce-scatters
    assert {"all-gather", "all-reduce", "reduce-scatter"} <= \
        set(rec["collectives"])
    assert rec["model_flops"] > 0 and rec["flops"] > 0
    assert rec["params_total"] == rec["params_active"] > 8e9


# One cell of each family that runs on a mesh since the recurrent blocks
# and the encoder-decoder do: rwkv6's decode against the key-split WKV
# states, recurrentgemma's prefill through its RG-LRU channels and its
# windowed query-sequence route, whisper's decode against its cross
# caches.
FAMILY_CELLS = (("rwkv6_3b", "decode_32k"),
                ("recurrentgemma_2b", "prefill_32k"),
                ("whisper_small", "decode_32k"))


@pytest.mark.parametrize("arch,shape", FAMILY_CELLS)
def test_dryrun_family_cell_on_8_ranks(tmp_path, arch, shape):
    rec = _dryrun(tmp_path, "--arch", arch, "--shape", shape)
    assert rec["trace_ok"] and "error" not in rec
    assert rec["devices"] == 8 and rec["mesh"] == "2x4"
    assert rec["memory"]["peak_bytes"] > rec["memory"]["parameters"] > 0
    assert rec["memory"]["parameters"] == _rank_param_bytes(arch)
    assert "all-reduce" in rec["collectives"] and rec["flops"] > 0


def test_dryrun_tiled_ph_cell(tmp_path):
    rec = _dryrun(tmp_path, "--arch", "pixhomology", "--shape",
                  "ph_tiled_1k")
    assert rec["trace_ok"] and rec["phase_a_peak_invariant"]
    assert rec["tile_shape"] == [256, 256]


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the refusal where there is no CUDA device")
def test_dryrun_takes_the_card_unless_the_host_is_asked_for(tmp_path):
    res = _run(tmp_path, "--arch", "pixhomology", "--shape", "ph_tiled_1k")
    assert res.returncode != 0
    assert "pass --device cpu" in res.stderr
    assert not (tmp_path / "cell.json").exists()
