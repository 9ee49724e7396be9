"""The trace reduction on a hand-made chrome trace, the program's kernel
names, the yardstick's byte counts and the whole-window percentile."""
from __future__ import annotations

import numpy as np
import pytest

import _bench_tiny as tiny
import harness.roofline as roofline
import harness.stats as stats
from harness.trace_slice import TraceSlice, port_kernel_names, union_length


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": args}


EVENTS = [
    _x("user_annotation", "bench.call", 100, 100),
    _x("user_annotation", "bench.call", 250, 50),
    _x("cpu_op", "aten::add", 105, 10),
    _x("cuda_runtime", "cudaLaunchKernel", 106, 2, correlation=1),
    _x("kernel", "void at::native::add_kernel<float>()", 110, 20,
       correlation=1),
    _x("cuda_runtime", "cudaLaunchKernel", 120, 2, correlation=2),
    _x("kernel", "void (anonymous namespace)::strip16_kernel<float>("
       "float const*, int, int, int, int*, int*)", 125, 15, correlation=2),
    _x("user_annotation", "bench.probe", 140, 10),
    _x("cuda_runtime", "cudaLaunchKernel", 142, 2, correlation=3),
    _x("kernel", "void at::native::reduce_kernel<long>()", 150, 30,
       correlation=3),
    _x("cpu_op", "aten::item", 160, 30),
    _x("cuda_runtime", "cudaStreamSynchronize", 165, 20),
    _x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 185, 5),
    _x("cuda_runtime", "cudaEventSynchronize", 260, 5),
    _x("kernel", "void at::native::late<float>()", 290, 40, correlation=9),
]


def test_slice_reduction():
    tr = TraceSlice(EVENTS)
    assert (tr.start, tr.end, tr.calls) == (100.0, 300.0, 2)
    # the probe's kernel (150-180) is left out of busy time and of the
    # window; the late one is clipped
    assert tr.busy_us() == pytest.approx(20 + 10 + 5 + 10)
    assert tr.window_us == 200 - 30
    assert tr.sync_count() == 2
    names = port_kernel_names(tiny.ROOT)
    libs = [tr.library_of(n, names) for _, _, n in tr.kernels()]
    assert libs.count("ph_phase_a") == 1 and libs.count(None) == 2
    ops = dict((n, s) for n, s in tr.top_device_ops())
    assert ops["Memcpy DtoH (Device -> Pageable)"] == pytest.approx(5e-6)
    gaps = dict((n, s) for n, s in tr.idle_gaps())
    assert gaps == pytest.approx({
        "aten::add": 10e-6, "bench.probe": 10e-6,
        "aten::item > cudaStreamSynchronize": 5e-6, "python": 100e-6})
    assert sum(gaps.values()) * 1e6 == pytest.approx(tr.window_us
                                                     - tr.busy_us())


def test_port_kernel_names():
    names = port_kernel_names(tiny.ROOT)
    assert names["strip16_kernel"] == "ph_phase_a"
    assert names["strip32_kernel"] == "ph_phase_a"
    assert names["best_list_kernel"] == "ph_phase_c"
    assert names["pool3x3_kernel"] == "maxpool"


def test_union_length():
    assert union_length([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4
    assert union_length([]) == 0


def test_byte_counts():
    assert roofline.phase_a_bytes(4096 * 4096, 4) == 4096 * 4096 * 12
    assert roofline.best_edge_bytes(10, 8, 3, 5) == 80 + 24 + 60
    assert roofline.bound_seconds(3.35e12) == pytest.approx(1.0)


@pytest.mark.parametrize("n", [1, 2, 7, 100, 101])
@pytest.mark.parametrize("q", [0, 50, 90, 95, 100])
def test_percentile_is_numpys_linear(n, q):
    xs = list(np.random.default_rng(n).random(n))
    assert stats.percentile(xs, q) == pytest.approx(np.percentile(xs, q))

