"""The per-layer metrics read from the program's own recorder
(``repro_torch.telemetry``) on the CPU at a tiny frame size: a traced
line carries the host-side ones, the device-event ones stay out, and the
recorder is off again once a traced run ends."""
from __future__ import annotations

import pytest

import _bench_tiny as tiny

CELLS = ["paper_10k.std", "survey_4k.vanilla2"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.tiny_root(tmp_path_factory.mktemp("tiny"), pool=2)


@pytest.mark.parametrize("cell", CELLS)
def test_traced_line_carries_the_program_spans(root, cell, capsys):
    rc, line = tiny.run_cell(root, cell, trace=1, capsys=capsys)
    assert rc == 0 and line["correct"] is True
    metrics = line["metrics"]
    assert metrics["host_prep_ms_per_frame"]["value"] > 0
    assert metrics["host_prep_ms_per_frame"]["unit"] == "ms/frame"
    assert metrics["readbacks_per_call"]["value"] > 0
    # CUDA-event times do not exist on the CPU.
    assert not {"tile_ab_ms_per_frame", "merge_ms_per_frame"} & set(metrics)


def test_untraced_run_after_a_traced_one_records_nothing(root, capsys):
    from repro_torch import telemetry
    rc, _ = tiny.run_cell(root, CELLS[0], trace=1, capsys=capsys)
    assert rc == 0 and not telemetry.enabled()
    telemetry.reset()
    rc, line = tiny.run_cell(root, CELLS[0], capsys=capsys)
    assert rc == 0 and line["correct"] is True
    assert not telemetry.enabled()
    assert telemetry.snapshot() == {"spans": [], "counters": {}}
