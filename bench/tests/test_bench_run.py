"""Whole runs of every cell on the CPU at a tiny frame size: the result
line's keys, the check passing, and the check failing under the control
and under each fault the cells can have.

The faults break the program's entry underneath the harness: a call
that hands back an earlier call's diagrams (state left unchanged), half
of a batch left out (its rows filled from the other half), and one
answer altered where it is produced.  No cell spans chips, so there is
no exchange between chips to leave out.
"""
from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

import _bench_tiny as tiny

CELLS = [w["name"] for w in json.loads(
    (tiny.ROOT / "BENCHMARK.json").read_text())["workloads"]]
RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device",
               "checks"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.tiny_root(tmp_path_factory.mktemp("tiny"), pool=2,
                          sample_calls=1000)


@pytest.mark.parametrize("cell", CELLS)
def test_end_to_end_line(root, cell, capsys):
    rc, line = tiny.run_cell(root, cell, capsys=capsys)
    assert rc == 0
    assert set(line) == RESULT_KEYS
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert {"mpix_per_s", "latency_p90_ms", "setup_s"} <= set(
        line["metrics"])
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for k, v in line["checks"].items():
        assert v["value"] == 0 or k == "calls_checked"


@pytest.mark.parametrize("cell", CELLS)
def test_traced_line(root, cell, capsys):
    rc, line = tiny.run_cell(root, cell, trace=1, capsys=capsys)
    assert rc == 0 and line["correct"] is True
    assert set(line) == RESULT_KEYS | {"breakdown"}
    assert list(line)[-1] == "checks"
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    # Host-side readings exist on the CPU; device-trace ones do not.
    assert set(line["metrics"]) == {"regrow_attempts",
                                    "host_cast_ms_per_frame",
                                    "host_sys_ms_per_call"}
    assert line["metrics"]["regrow_attempts"]["value"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(root, cell, capsys):
    """The program's own bfloat16 path in place of float32."""
    rc, line = tiny.run_cell(root, cell, capsys=capsys,
                             overrides={"dtype": "bfloat16"})
    assert rc == 0 and line["correct"] is False
    assert line["checks"]["rows_diff"]["value"] > 0


def _stale(orig):
    first = {}

    def fake(self, *args, **kwargs):
        if "out" not in first:
            first["out"] = orig(self, *args, **kwargs)
        return first["out"]
    return fake


def _half_batch(orig):
    def fake(self, images, *args, **kwargs):
        b = images.shape[0]
        tv = args[0] if args else kwargs.pop("truncate_values", None)
        args = args[1:]
        head = orig(self, images[: b // 2 or 1],
                    None if tv is None else tv[: b // 2 or 1],
                    *args, **kwargs)
        idx = torch.arange(b) % max(1, b // 2)
        diag = type(head.diagram)(*(f[idx] for f in head.diagram))
        return head.__class__(diag, head.config, head.regrow, tv)
    return fake


def _altered(orig):
    def fake(self, *args, **kwargs):
        res = orig(self, *args, **kwargs)
        death = res.diagram.death.clone()
        death[..., 1] += 1
        return res.__class__(res.diagram._replace(death=death), res.config,
                             res.regrow, res.threshold)
    return fake


FAULTS = {"stale": _stale, "half_batch": _half_batch, "altered": _altered}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_fails(root, cell, fault, capsys, monkeypatch):
    from repro_torch.ph.engine import PHEngine
    entry = "run_tiled" if cell.startswith("paper") else "run_batch"
    if fault == "half_batch" and entry == "run_tiled":
        pytest.skip("one frame a call: no half of a batch to leave out")
    monkeypatch.setattr(PHEngine, entry,
                        FAULTS[fault](getattr(PHEngine, entry)))
    rc, line = tiny.run_cell(root, cell, seconds=1.0, capsys=capsys)
    assert rc == 0 and line["correct"] is False


def test_jax_loaded_after_the_window_exits_without_a_result(
        tmp_path, capsys):
    """A reference that loads JAX while the check runs: the guard looks
    at ``sys.modules`` last, so the run gives no result line."""
    root = tiny.tiny_root(tmp_path)
    refs = root / "bench" / "references"
    refs.unlink()
    refs.mkdir()
    (refs / "loads_jax.py").write_text(
        "import sys, types\n"
        "LIMITS = {'gap': 0}\n"
        "def expected(inputs, device):\n"
        "    sys.modules.setdefault('jax', types.ModuleType('jax'))\n"
        "def compare(expected, output):\n"
        "    return {'gap': 0}\n")
    cfg_path = root / "bench" / "configs" / "survey_4k.json"
    cfg = json.loads(cfg_path.read_text())
    cfg["reference"] = "loads_jax"
    cfg_path.write_text(json.dumps(cfg))
    had = "jax" in sys.modules
    try:
        rc, line = tiny.run_cell(root, "survey_4k.vanilla2", capsys=capsys)
    finally:
        if not had:
            sys.modules.pop("jax", None)
    assert not had
    assert rc == 4 and line is None


def test_no_chip_exits_without_a_result():
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", CELLS[0], "--seed",
         "1", "--seconds", "1"], cwd=tiny.ROOT, capture_output=True,
        text=True)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert out.returncode == 3 and out.stdout == ""


def test_checkout_without_the_program_fails(tmp_path, capsys):
    root = tiny.tiny_root(tmp_path)
    (root / "src").unlink()
    saved = {m: sys.modules.pop(m) for m in list(sys.modules)
             if m.split(".")[0] == "repro_torch"}
    saved_path = list(sys.path)
    sys.path[:] = [p for p in sys.path if not p.endswith("/src")]
    try:
        with pytest.raises(ModuleNotFoundError):
            tiny.run_cell(root, CELLS[0])
    finally:
        sys.path[:] = saved_path
        sys.modules.update(saved)
    assert capsys.readouterr().out == ""


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_card(cuda, tmp_path, cell, capsys):
    """The control at 512² on the card: the program's bfloat16 path fails
    the check that its float32 path passes."""
    root = tiny.tiny_root(tmp_path, size={"paper_10k": 512,
                                          "survey_4k": 512})
    import run as bench_run
    for overrides, want in ((None, True), ({"dtype": "bfloat16"}, False)):
        rc = bench_run.main(["--workload", cell, "--seed", "2147483659",
                             "--seconds", "1"], root=root,
                            overrides=overrides)
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert rc == 0 and line["correct"] is want
