"""The source-injection stream (``recipes/star_field_stream.py``,
``generators/stream_loop.py``) on the CPU: a realisation differs from the
base only inside its dirty tiles, away from every other tile's halo
window; one seed gives the same frames to the bit; and a tiny run of the
stream cell through ``bench/run.py`` is correct and reads the recipe's
dirty count as its tiles re-run a frame."""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import _bench_tiny as tiny
import harness.spec as spec

CELL = "stream_10k.delta5"
FRAME = json.loads((tiny.BENCH / "configs" / "stream_10k.json").read_text()
                   )["frame"]


def _draw(seed, size=128, grid=(4, 4), n=4):
    recipe = spec.load_module("recipes", "star_field_stream")
    return recipe, recipe.draw(dict(FRAME, size=size), n, seed,
                               torch.device("cpu"), grid)


@pytest.mark.parametrize("seed", [7, 2 ** 31 + 99, -3])
def test_realisations_change_only_their_dirty_tiles(seed):
    recipe, (frames, dirty) = _draw(seed)
    again = recipe.draw(dict(FRAME, size=128), 4, seed,
                        torch.device("cpu"), (4, 4))
    assert torch.equal(frames, again[0])
    assert all(np.array_equal(a, b) for a, b in zip(dirty, again[1]))
    tile = 128 // 4
    base = frames[0].numpy()
    k = recipe.n_dirty(FRAME["inject"], 16)
    for i, tiles in enumerate(dirty, 1):
        assert len(tiles) == len(set(tiles.tolist())) == k
        diff = np.pad(frames[i].numpy() != base, 1)
        assert diff.any()
        changed = []
        for t in range(16):
            r0, c0 = (t // 4) * tile, (t % 4) * tile
            # the halo-padded window of tile t in the padded frame
            if diff[r0:r0 + tile + 2, c0:c0 + tile + 2].any():
                changed.append(t)
        assert changed == tiles.tolist()


def test_tiny_stream_cell_reads_its_dirty_count(tmp_path, capsys):
    root = tiny.tiny_root(tmp_path)
    cfg = json.loads((root / "bench/configs/stream_10k.json").read_text())
    grid = cfg["engine"]["tile"]["grid"]
    recipe = spec.load_module("recipes", "star_field_stream")
    want = recipe.n_dirty(cfg["frame"]["inject"], grid[0] * grid[1])
    rc, line = tiny.run_cell(root, CELL, seed=2 ** 31 + 5, trace=1,
                             capsys=capsys)
    assert rc == 0 and line["correct"] is True and line["failed"] == 0
    metrics = line["metrics"]
    assert metrics["delta_dirty_tiles_per_frame"]["value"] == want
    assert metrics["delta_hash_ms_per_frame"]["value"] > 0
    assert metrics["delta_stage_ms_per_frame"]["value"] > 0
