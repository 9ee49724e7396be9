"""The plain reference against a union-find sweep written out here, and
against the port's diagrams on the CPU through both entry points."""
from __future__ import annotations

import numpy as np
import pytest
import torch

import _bench_tiny as tiny  # noqa: F401  (puts bench/ on sys.path)
from references import superlevel_ph0 as ref


def sweep(img: np.ndarray, t):
    """Pixels in descending (value, index) order, 8-neighbour unions, the
    younger root dies; survivors die at ``t``, the eldest at the global
    minimum.  Rows (birth, death, p_birth, p_death) by descending birth."""
    h, w = img.shape
    v = img.reshape(-1)
    asc = np.argsort(v, kind="stable")
    rank = np.empty(v.size, np.int64)
    rank[asc] = np.arange(v.size)
    parent = np.full(v.size, -1)

    def find(p):
        while parent[p] != p:
            p = parent[p]
        return p

    rows = []
    for p in asc[::-1]:
        if t is not None and v[p] < t:
            break
        r, c = divmod(int(p), w)
        roots = []
        for dr in (-1, 0, 1):
            for dc in (-1, 0, 1):
                rr, cc = r + dr, c + dc
                if (dr or dc) and 0 <= rr < h and 0 <= cc < w \
                        and parent[rr * w + cc] >= 0:
                    q = find(rr * w + cc)
                    if q not in roots:
                        roots.append(q)
        if not roots:
            parent[p] = p
            continue
        elder = max(roots, key=lambda q: rank[q])
        parent[p] = elder
        for q in roots:
            if q != elder:
                rows.append((v[q], v[p], q, p))
                parent[q] = elder
    for q in np.flatnonzero(parent == np.arange(v.size)):
        if q == asc[-1]:
            rows.append((v[q], v[asc[0]], q, asc[0]))
        else:
            rows.append((v[q], np.float32(t), q, -1))
    rows.sort(key=lambda x: (x[0], x[2]), reverse=True)
    return rows


@pytest.mark.parametrize("size", [9, 24, 40])
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("thresholded", [False, True])
def test_reference_equals_sweep(size, ties, thresholded):
    rng = np.random.default_rng(size * 7 + ties)
    img = rng.normal(100, 5, (size, size)).astype(np.float32)
    if ties:
        img = np.round(img / 2).astype(np.float32)
    t = float(np.float32(np.median(img) + 2)) if thresholded else None
    got = ref.persistence_diagram(torch.from_numpy(img), t)
    want = sweep(img, t)
    assert got["count"] == len(want)
    assert got["n_unmerged"] == sum(1 for r in want if r[3] == -1)
    for i, (b, d, pb, pd) in enumerate(want):
        assert (got["birth"][i], got["death"][i], got["p_birth"][i],
                got["p_death"][i]) == (b, d, pb, pd)


def _frames(size, n, seed):
    import recipes.star_field as star
    spec = {"size": size, "density_per_px": 0.02, "sky": 100.0,
            "read_noise": 5.0, "amp_min": 10.0, "amp_max": 5000.0,
            "sigma_min": 1.0, "sigma_max": 2.5, "stamp": 15,
            "count_spread": 0.4}
    return star.draw(spec, n, seed, torch.device("cpu"))


def _threshold(frame):
    import harness.threshold as th
    return th.variant2(frame, 1.0, 2.0)


@pytest.mark.parametrize("size", [64, 128, 256])
@pytest.mark.parametrize("thresholded", [False, True])
def test_reference_equals_port_run_batch(size, thresholded):
    import harness.ph_engine as ph
    frames = _frames(size, 2, size)
    tv = [_threshold(f) for f in frames] if thresholded else None
    eng = ph.build({"engine": {"merge_impl": "boruvka",
                               "phase_c_impl": "fused", "strip_rows": 8,
                               "autotune": False}}, "cpu")
    out = ph.host_diagram(eng.run_batch(frames.numpy(), tv,
                                        dedupe=False).diagram)
    want = ref.expected((frames.numpy(), tv), "cpu")
    assert len(want) == 2
    assert ref.compare(want, out) == dict.fromkeys(ref.LIMITS, 0)


@pytest.mark.parametrize("size", [64, 128, 256])
@pytest.mark.parametrize("thresholded", [False, True])
def test_reference_equals_port_run_tiled(size, thresholded):
    import harness.ph_engine as ph
    frame = _frames(size, 1, size + 1)[0]
    t = _threshold(frame) if thresholded else None
    eng = ph.build({"engine": {"merge_impl": "boruvka",
                               "phase_c_impl": "fused", "autotune": False,
                               "tile": {"grid": [2, 2]}}}, "cpu")
    out = ph.host_diagram(eng.run_tiled(frame.numpy(),
                                        truncate_value=t).diagram)
    want = ref.expected((frame.numpy()[None], None if t is None else [t]),
                        "cpu")
    assert ref.compare(want, out) == dict.fromkeys(ref.LIMITS, 0)


def test_compare_counts_each_kind_of_difference():
    frame = _frames(48, 1, 3)[0]
    want = ref.persistence_diagram(frame, None)
    c = want["count"]
    pad = 4
    fields = [torch.full((c + pad,), -float("inf")),
              torch.full((c + pad,), -float("inf")),
              torch.full((c + pad,), -1, dtype=torch.int32),
              torch.full((c + pad,), -1, dtype=torch.int32)]
    for f, k in zip(fields, ("birth", "death", "p_birth", "p_death")):
        f[:c] = torch.from_numpy(want[k].astype(f.numpy().dtype))
    good = (*fields, torch.tensor(c), torch.tensor(want["n_unmerged"]),
            torch.tensor(False))
    assert ref.compare([want], good) == dict.fromkeys(ref.LIMITS, 0)
    bad = [f.clone() for f in fields]
    bad[1][1] += 1
    bad[2][c] = 5
    out = ref.compare([want], (*bad, torch.tensor(c - 1), torch.tensor(3),
                               torch.tensor(True)))
    # rows: the changed death, the last real row now past the count, and
    # the padding row with a pixel in it.
    assert out == {"count_diff": 1, "rows_diff": 3,
                   "unmerged_diff": abs(3 - want["n_unmerged"]),
                   "overflow": 1}


def test_compare_counts_a_missing_frame():
    frames = _frames(48, 2, 4)
    want = ref.expected((frames.numpy(), None), "cpu")
    one = ref.expected((frames.numpy()[:1], None), "cpu")[0]
    n = max(one["count"], 1)
    fields = [torch.full((1, n), -float("inf")),
              torch.full((1, n), -float("inf")),
              torch.full((1, n), -1, dtype=torch.int32),
              torch.full((1, n), -1, dtype=torch.int32)]
    for f, k in zip(fields, ("birth", "death", "p_birth", "p_death")):
        f[0, :one["count"]] = torch.from_numpy(
            one[k].astype(f.numpy().dtype))
    out = ref.compare(want, (*fields, torch.tensor([one["count"]]),
                             torch.tensor([one["n_unmerged"]]),
                             torch.tensor([False])))
    assert out["count_diff"] == want[1]["count"] > 0
    # and a frame returned that no input asked for
    two = tuple(torch.cat([f, f]) for f in (*fields,
                torch.tensor([one["count"]]), torch.tensor([one["n_unmerged"]]),
                torch.tensor([False])))
    assert ref.compare(want[:1], two)["count_diff"] == one["count"]


def test_frames_repeat_by_seed():
    a, b = _frames(64, 3, 2 ** 33 + 5), _frames(64, 3, 2 ** 33 + 5)
    assert torch.equal(a, b)
    assert not torch.equal(a, _frames(64, 3, 2 ** 33 + 6))
    assert not torch.equal(a[0], a[1])
