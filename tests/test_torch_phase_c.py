"""Port parity: the phase-C best-edge reduction and fused merge.

The port's plain ``best_edge_reduce`` is held bitwise to the reference's
Pallas kernel in interpret mode (int32 rank keys — the reference cannot
build int64 keys without 64-bit mode) and to a numpy loop (int64 packed
keys), across tie storms, dead lanes and all-dead instances.
``fused_merge`` and the Boruvka forest are held to the reference's with
rank keys.  The CUDA kernel is tested on the card
(tests/test_torch_cuda.py).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from _torch_parity import assert_same, make_image
from repro.core import parallel_merge as jpm
from repro.core import total_order_rank as jrank
from repro.core.pixhomology import phase_a as jphase_a
from repro.core.pixhomology import phase_b as jphase_b
from repro.core.pixhomology import exact_candidates_masked as jcand
from repro.kernels.ph_phase_c import kernel as jkernel
from repro.kernels.ph_phase_c import ops as jops
from repro_torch.core import parallel_merge as tpm
from repro_torch.core import (exact_candidates_masked, phase_a, phase_b,
                              total_order_rank)
from repro_torch.core.packed_keys import key_pad, pack_keys
from repro_torch.kernels.ph_phase_c import kernel as tkernel
from repro_torch.kernels.ph_phase_c import ops as tops
from repro_torch.kernels.ph_phase_c import ref as tref

CASES = [(1, 1, 0.3), (7, 3, 0.3), (33, 4, 0.3), (100, 9, 0.5),
         (64, 5, 1.0), (500, 40, 0.0)]


def _instance(e, nv, dtype, seed, dead):
    """Keys from a keyspace of 10 values (tie storms), ``dead`` share of
    pad lanes, endpoints uniform over the vertex set."""
    rng = np.random.default_rng(seed)
    pad = np.iinfo(dtype).min
    key = rng.integers(-5, 5, size=e).astype(dtype)
    key = np.where(rng.random(e) < dead, pad, key).astype(dtype)
    ra = rng.integers(0, nv, size=e).astype(np.int32)
    rb = rng.integers(0, nv, size=e).astype(np.int32)
    return key, ra, rb


def _numpy_best_edge(key, ra, rb, nv):
    pad = np.iinfo(key.dtype).min
    best = np.full(nv, pad, key.dtype)
    win = np.full(nv, -1, np.int32)
    for e in range(key.size):
        if key[e] > pad:
            for v in (ra[e], rb[e]):
                best[v] = max(best[v], key[e])
    for e in range(key.size):
        if key[e] > pad:
            for v in (ra[e], rb[e]):
                if key[e] == best[v]:
                    win[v] = max(win[v], e)
    return best, win


@pytest.mark.parametrize("e,nv,dead", CASES)
def test_plain_best_edge_matches_pallas_interpret_int32(e, nv, dead):
    key, ra, rb = _instance(e, nv, np.int32, e + nv, dead)
    jb, jw = jkernel.best_edge_reduce(jnp.asarray(key), jnp.asarray(ra),
                                      jnp.asarray(rb), nv, block_edges=16,
                                      interpret=True)
    tb, tw = tref.best_edge_reduce(torch.from_numpy(key),
                                   torch.from_numpy(ra),
                                   torch.from_numpy(rb), nv)
    assert_same(jb, tb, "best")
    assert_same(jw, tw, "win")


@pytest.mark.parametrize("e,nv,dead", CASES)
def test_plain_best_edge_matches_numpy_loop_int64(e, nv, dead):
    key, ra, rb = _instance(e, nv, np.int64, 7 * e + nv, dead)
    key = np.where(key > np.iinfo(np.int64).min, key << 33, key)  # wide keys
    want_b, want_w = _numpy_best_edge(key, ra, rb, nv)
    tb, tw = tops.best_edge_reduce(torch.from_numpy(key),
                                   torch.from_numpy(ra),
                                   torch.from_numpy(rb), nv)
    np.testing.assert_array_equal(want_b, tb.numpy())
    np.testing.assert_array_equal(want_w, tw.numpy())
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.best_edge_reduce(torch.from_numpy(key), torch.from_numpy(ra),
                                 torch.from_numpy(rb), nv)


def _stage_inputs(img):
    """Keys, labels, candidates and root mask from both packages."""
    h, w = img.shape
    jx, tx = jnp.asarray(img), torch.from_numpy(img)
    jpa = jphase_a(jx, strip_rows=4)
    jlab = jphase_b(jpa, (h, w), strip_rows=4)
    jc = jcand(jpa.hi_mask.reshape(h, w), jlab.reshape(h, w)).reshape(-1)
    tpa = phase_a(tx, strip_rows=4)
    tlab = phase_b(tpa, (h, w), strip_rows=4)
    tc = exact_candidates_masked(tpa.hi_mask.reshape(h, w),
                                 tlab.reshape(h, w)).reshape(-1)
    assert_same(jlab, tlab, "labels")
    assert_same(jc, tc, "candidates")
    n = h * w
    jroot = jlab == jnp.arange(n, dtype=jnp.int32)
    troot = tlab == torch.arange(n, dtype=torch.int32)
    return (jx.reshape(-1), jlab, jc, jroot), (tx.reshape(-1), tlab, tc, troot)


@pytest.mark.parametrize("kind,mf,mc", [("gauss", 200, 200),
                                        ("ties", 200, 200),
                                        ("gauss", 6, 10)])
def test_fused_merge_matches_reference_rank_keys(kind, mf, mc):
    """Rank keys in both packages; the last case overflows both
    capacities, where the partial records must still agree."""
    img = make_image("float32", kind, seed=11, shape=(13, 12))
    (jv, jlab, jc, jroot), (tv, tlab, tc, troot) = _stage_inputs(img)
    jkey = jrank(jv)
    tkey = total_order_rank(tv)
    assert_same(jkey, tkey, "ranks")
    want = jops.fused_merge(jv, jkey, jlab, jc, jroot, img.shape,
                            max_candidates=mc, max_features=mf,
                            use_pallas=False)
    got = tops.fused_merge(tv, tkey, tlab, tc, troot, img.shape,
                           max_candidates=mc, max_features=mf)
    for name, a, b in zip(("root_key", "root_pix", "rvalid", "dval",
                           "dpos", "overflow"), want[:6], got[:6]):
        assert_same(a, b, name)
    assert int(want[6]) == got[6], "Boruvka rounds"
    # Packed keys give the same records (root_key aside: another encoding).
    got_p = tops.fused_merge(tv, pack_keys(tv), tlab, tc, troot, img.shape,
                             max_candidates=mc, max_features=mf)
    for a, b in zip(got[1:6], got_p[1:6]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n_live", [None, 1, "roots"])
def test_boruvka_merge_matches_reference(n_live):
    """Whole-image Boruvka (phase_c_impl="xla"), including the merge-budget
    early exit: same records, same round count."""
    img = make_image("float32", "gauss", seed=3, shape=(11, 10))
    (jv, jlab, jc, jroot), (tv, tlab, tc, troot) = _stage_inputs(img)
    live = {None: None, 1: 1, "roots": int(troot.sum())}[n_live]
    jd, jp, jo, jr = jpm.boruvka_merge(jv, jrank(jv), jlab, jc, img.shape,
                                       110, n_live=live)
    td, tp, to, tr = tpm.boruvka_merge(tv, total_order_rank(tv), tlab, tc,
                                       img.shape, 110, n_live=live)
    assert_same(jd, td, "dval")
    assert_same(jp, tp, "dpos")
    assert_same(jo, to, "overflow")
    assert int(jr) == tr
    jk, ja, jb = jpm.candidate_edges(jrank(jv), jlab, jc, img.shape, 110)
    tk, ta, tb = tpm.candidate_edges(total_order_rank(tv), tlab, tc,
                                     img.shape, 110)
    for name, a, b in (("key", jk, tk), ("a", ja, ta), ("b", jb, tb)):
        assert_same(a, b, f"edge {name}")


def test_dispatch_and_pad_identity():
    key = torch.full((5,), key_pad(torch.int64), dtype=torch.int64)
    ends = torch.zeros(5, dtype=torch.int32)
    for use_pallas in (None, False):
        best, win = tops.best_edge_reduce(key, ends, ends, 3,
                                          use_pallas=use_pallas)
        assert torch.all(best == key_pad(torch.int64))
        assert torch.all(win == -1)
