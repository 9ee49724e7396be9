"""The PyTorch port's PH examples (``examples/*_torch.py``) on the host,
each ``main(["--device", "cpu"])`` at its own defaults, against the
reference:

* quickstart: the diagram of its star field bit for bit the reference
  ``PHEngine.run``'s and the union-find oracle's, after a regrow;
* distributed_ph: every image's summary (object count, top births and
  deaths) the reference pipeline's (``run_distributed`` with the same
  config, schedule and injected failure), the failure recovered;
* serve_ph: every future's diagram the port engine's ``run`` of its
  image, and no plan built after the warmup.
"""
import importlib.util
from pathlib import Path

import numpy as np

from repro.core import persistence_oracle
from repro.data import astro as jastro
from repro.ph import FilterLevel, PHConfig as JPHConfig, PHEngine as JPHEngine
from repro.pipeline.driver import FailureInjector as JFailureInjector

ROOT = Path(__file__).resolve().parents[1]


def _example(name: str):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_quickstart_matches_reference_and_oracle():
    out = _example("quickstart_torch").main(["--device", "cpu"])
    img = jastro.generate_image(image_id=42, size=256)
    want = JPHEngine(JPHConfig(max_features=512,
                               max_candidates=1024)).run(img).to_array()
    assert out["rows"].dtype == want.dtype
    np.testing.assert_array_equal(out["rows"], want)
    np.testing.assert_array_equal(out["rows"], persistence_oracle(img))
    assert out["regrow_attempts"] > 0 and out["validated_rows"] == len(want)
    assert out["components"] == len(want)


def test_distributed_ph_matches_reference_pipeline(tmp_path):
    out = _example("distributed_ph_torch").main(
        ["--device", "cpu", "--work-log", str(tmp_path / "torch.jsonl")])
    engine = JPHEngine(JPHConfig(max_features=8192, max_candidates=32768,
                                 filter_level=FilterLevel.STD))
    want = engine.run_distributed(
        list(range(12)), image_size=256, strategy="part_LPT",
        work_log=str(tmp_path / "ref.jsonl"),
        failure_injector=JFailureInjector([2]))
    assert out["images"] == len(want.diagrams) == 12
    assert out["failures"] == want.failures == 1
    assert out["rounds"] == want.rounds
    for i, summary in want.diagrams.items():
        got = out["diagrams"][i]
        assert got["count"] == summary["count"], i
        for key in ("top_births", "top_deaths"):
            np.testing.assert_array_equal(got[key], summary[key],
                                          err_msg=f"{i} {key}")


def test_serve_ph_futures_equal_engine_runs():
    example = _example("serve_ph_torch")
    out = example.main(["--device", "cpu"])
    assert out["resolved"] + len(out["rejected"]) == 32
    assert out["resolved"] > 0 and out["steady_state_traces"] == 0
    engine = example.PHEngine(example.PHConfig(merge_impl="boruvka"),
                              device="cpu")
    for image_id, size, res in out["served"]:
        img = example.astro.generate_image(image_id=image_id, size=size)
        np.testing.assert_array_equal(res.to_array(),
                                      engine.run(img).to_array(),
                                      err_msg=f"{image_id} {size}")
    assert set(out["buckets"]) <= {"64x64", "128x128"}
