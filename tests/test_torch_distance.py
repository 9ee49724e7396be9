"""Port parity: diagram distances (repro_torch.kernels.ph_distance and
``PHEngine.distance_matrix``) vs the reference.

Tolerances: persistence profiles and the bottleneck bound are compared
bitwise (no arithmetic beyond exact differences); projections within a
few float32 ulps (the direction cosines round differently in the two
backends: the port takes them in float64 and rounds once); the sliced
Wasserstein distance at rtol 1e-5, the tolerance the reference uses
where its sum reassociates.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from _torch_parity import assert_same_distances
from repro.kernels.ph_distance import ops as jops
from repro.kernels.ph_distance import ref as jref
from repro.ph import PHConfig as JConfig
from repro.ph import PHEngine as JEngine
from repro_torch.kernels.ph_distance import ops, ref
from repro_torch.ph import PHConfig, PHEngine

H = W = 16
N = H * W


def _image(seed, shape=(H, W)):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]].astype(np.float32)
    img = rng.normal(0.0, 0.1, shape).astype(np.float32)
    for _ in range(5):
        cy, cx = rng.uniform(0, shape[0]), rng.uniform(0, shape[1])
        img += rng.uniform(0.5, 2.0) * np.exp(
            -((yy - cy) ** 2 + (xx - cx) ** 2) / 6.0).astype(np.float32)
    return img


def _cfg(**kw):
    return {"max_features": N, "max_candidates": N, "strip_rows": 4, **kw}


def _batch(n=5, seed=9, **kw):
    """Stacked host diagrams of ``n`` images from the port's engine."""
    eng = PHEngine(PHConfig(**_cfg(**kw)), device="cpu")
    imgs = np.stack([_image(seed + i) for i in range(n)])
    return eng, eng._stack_diagrams(eng.run_batch(imgs))


def _np(triple):
    return tuple(t.numpy() for t in triple)


def test_preparation_matches_reference():
    _, triple = _batch()
    birth, death, p_birth = _np(triple)
    for n_dirs in (1, 3, 16):
        jc, js = jref._directions(n_dirs, jnp.float32)
        tc, ts = ref._directions(n_dirs, torch.float32, "cpu")
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0,
                                   atol=1.2e-7)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0,
                                   atol=1.2e-7)
    jp, jd = jref.diagram_projections(birth, death, p_birth)
    tp, td = ref.diagram_projections(*triple)
    scale = np.abs(birth[p_birth >= 0]).max()
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0,
                               atol=4e-7 * scale)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0,
                               atol=4e-7 * scale)
    assert (tp.numpy()[np.broadcast_to(p_birth[:, None] < 0, tp.shape)]
            == 0).all()
    want = np.asarray(jref.persistence_profiles(birth, death, p_birth))
    for keys in ("packed", "rank"):
        got = ref.persistence_profiles(*triple, merge_keys=keys)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=keys)
    assert (np.diff(want, axis=1) <= 0).all()


def test_distance_matrix_matches_reference():
    _, triple = _batch()
    args = _np(triple)
    want = jops.diagram_distances(*args)
    assert_same_distances(want, ops.diagram_distances(*triple),
                          "diagram_distances")
    assert_same_distances(
        want, ops.diagram_distances(*triple, use_pallas=False),
        "plain explicit")
    jeng = JEngine(JConfig(**_cfg()))
    teng = PHEngine(PHConfig(**_cfg()), device="cpu")
    assert_same_distances(jeng.distance_matrix(args),
                          teng.distance_matrix(triple), "engine triple")


def test_distance_metric_axioms():
    _, triple = _batch(n=6)
    for mat in ops.diagram_distances(*triple):
        m = mat.numpy()
        n = m.shape[0]
        np.testing.assert_array_equal(m, m.T)
        np.testing.assert_array_equal(np.diag(m), 0.0)
        assert (m >= 0).all()
        eps = 1e-5 * max(m.max(), 1.0)
        for i in range(n):
            for j in range(n):
                for k in range(n):
                    assert m[i, j] <= m[i, k] + m[k, j] + eps


def test_capacity_pads_are_inert():
    _, (birth, death, p_birth) = _batch()
    sw1, bn1 = ops.diagram_distances(birth, death, p_birth)

    def grow(a, fill):
        return torch.cat([a, torch.full_like(a, fill)], dim=1)

    sw2, bn2 = ops.diagram_distances(grow(birth, -np.inf),
                                     grow(death, -np.inf), grow(p_birth, -1))
    assert torch.equal(bn1, bn2)
    np.testing.assert_allclose(sw2.numpy(), sw1.numpy(), rtol=1e-5)


def test_engine_inputs_plan_cache_and_sublevel_exactness():
    eng, triple = _batch(n=4)
    results = [eng.run(_image(9 + i)) for i in range(4)]
    # A list of single results of mixed capacities stacks with pad rows.
    small = PHEngine(PHConfig(**_cfg(max_features=N // 2)), device="cpu")
    mixed = results[:2] + [small.run(_image(11)), small.run(_image(12))]
    assert mixed[2].diagram.birth.shape[0] != mixed[0].diagram.birth.shape[0]
    assert_same_distances(eng.distance_matrix(triple),
                          eng.distance_matrix(mixed), "mixed capacities")
    eng.distance_matrix(triple)
    before = eng.plan_stats()["traces"]
    sw_a, bn_a = eng.distance_matrix(triple)
    assert eng.plan_stats()["traces"] == before
    sub = PHEngine(PHConfig(**_cfg(filtration="sublevel")), device="cpu")
    birth, death, p_birth = triple
    sw_s, bn_s = sub.distance_matrix((-birth, -death, p_birth))
    assert torch.equal(sw_a, sw_s) and torch.equal(bn_a, bn_s)
    bad = birth.clone()
    bad[0, 0] = float("nan")
    with pytest.raises(ValueError, match="ordered by a filtration"):
        eng.distance_matrix((bad, death, p_birth))
    with pytest.raises(ValueError, match="ordered by a filtration"):
        ops.diagram_distances(bad, death, p_birth)


def _np_sw(pa, pb, n_dirs=16):
    theta = (np.arange(n_dirs) + 0.5) * np.pi / n_dirs
    total = 0.0
    for t in theta:
        c, s = np.cos(t), np.sin(t)
        va = np.sort(np.concatenate([pa[:, 0] * c + pa[:, 1] * s,
                                     (pb[:, 0] + pb[:, 1]) / 2 * (c + s)]))
        vb = np.sort(np.concatenate([pb[:, 0] * c + pb[:, 1] * s,
                                     (pa[:, 0] + pa[:, 1]) / 2 * (c + s)]))
        total += np.abs(va - vb).sum()
    return total / n_dirs


def test_distances_match_dense_numpy_reference():
    _, triple = _batch()
    birth, death, p_birth = _np(triple)
    sw, bn = (m.numpy() for m in ops.diagram_distances(*triple))
    f = birth.shape[1]

    def pts(i):
        m = p_birth[i] >= 0
        return np.stack([birth[i][m], death[i][m]], 1).astype(np.float64)

    def prof(p):
        return np.sort(np.concatenate([np.abs(p[:, 0] - p[:, 1]),
                                       np.zeros(f - len(p))]))[::-1]

    for i in range(birth.shape[0]):
        for j in range(birth.shape[0]):
            pa, pb = pts(i), pts(j)
            np.testing.assert_allclose(sw[i, j], _np_sw(pa, pb), rtol=1e-4,
                                       atol=1e-4)
            np.testing.assert_allclose(
                bn[i, j], 0.5 * np.abs(prof(pa) - prof(pb)).max(),
                rtol=1e-5, atol=1e-6)
