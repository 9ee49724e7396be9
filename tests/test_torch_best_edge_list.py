"""CPU model of the best-edge kernel's design (``csrc/best_edge.cu``).

The CUDA kernel runs only on the card (tests/test_torch_cuda.py); this
file holds its design to the plain version and to the JAX package's
``best_edge_reduce``, bitwise:

* int32 and int64 keys alike: pass 1 reads every key once and keeps
  ``best`` by max while appending live edge indices to a compact list, in
  whatever order the blocks reach the counter (modelled by a shuffle);
  pass 2 walks only the list for ``win``;
* the key array split into a scalar head up to a 16-byte boundary, the
  16-byte vectors and a scalar tail covers every edge exactly once.

Inputs are made from seeds with numpy.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import parallel_merge as jpm
from repro_torch.kernels.ph_phase_c import ref as rc


def list_two_pass(key, ra, rb, nv, rng):
    """The kernel's design: best and the live list (shuffled), then win over
    the list only."""
    pad = np.iinfo(key.dtype).min
    best = np.full(nv, pad, key.dtype)
    win = np.full(nv, -1, np.int32)
    live = np.flatnonzero(key > pad)
    for e in rng.permutation(live):                       # pass 1
        for v in (ra[e], rb[e]):
            best[v] = max(best[v], key[e])
    for e in rng.permutation(live):                       # pass 2, the list
        for v in (ra[e], rb[e]):
            if key[e] == best[v]:
                win[v] = max(win[v], e)
    return best, win


def span(offset_bytes, e, itemsize):
    """The kernel's split of E keys at a base offset_bytes past a 16-byte
    boundary: (head, vectors, tail)."""
    head = min(e, ((16 - offset_bytes % 16) % 16) // itemsize)
    vec = 16 // itemsize
    n_vec = (e - head) // vec
    return head, n_vec, e - head - n_vec * vec


def _instance(dtype, e, nv, kind, seed):
    rng = np.random.default_rng(seed)
    lo = np.iinfo(dtype).min
    if kind == "min_plus_one":
        key = np.full(e, lo + 1, np.int64)
    elif kind == "tie_storm":
        key = rng.choice([lo + 1, -1, 0, 3], size=e)
    else:
        key = rng.integers(-(1 << 20), 1 << 20, size=e)
    dead = {"all_dead": 1.0, "all_live": 0.0}.get(kind, 0.3)
    key = np.where(rng.random(e) < dead, lo, key).astype(dtype)
    ra = rng.integers(0, nv, size=e).astype(np.int32)
    rb = rng.integers(0, nv, size=e).astype(np.int32)
    return key, ra, rb


KINDS = ["min_plus_one", "tie_storm", "all_dead", "all_live", "mixed"]


def _plain(key, ra, rb, nv):
    b, w = rc.best_edge_reduce(torch.from_numpy(key), torch.from_numpy(ra),
                               torch.from_numpy(rb), nv)
    return b.numpy(), w.numpy()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_compact_list_model_matches_plain_version(kind, dtype):
    key, ra, rb = _instance(dtype, 300, 17, kind, len(kind))
    want = _plain(key, ra, rb, 17)
    for seed in range(3):                 # the list's order varies
        got = list_two_pass(key, ra, rb, 17, np.random.default_rng(seed))
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def _jax_reference(key, ra, rb, nv):
    """The JAX package's ``best_edge_reduce``.  JAX runs here without
    64-bit types, so int64 keys go in as their int32 dense ranks (pad to
    the int32 pad), which keeps every order and tie the reduction sees,
    and ``best`` comes back through the rank table."""
    if key.dtype == np.int32:
        b, w = jpm.best_edge_reduce(jnp.asarray(key), jnp.asarray(ra),
                                    jnp.asarray(rb), nv)
        return np.asarray(b), np.asarray(w)
    pad, lo = np.iinfo(np.int64).min, np.iinfo(np.int32).min
    live = key > pad
    values = np.unique(key[live])
    rank = np.where(live, np.searchsorted(values, key) + lo + 1, lo)
    b, w = jpm.best_edge_reduce(jnp.asarray(rank.astype(np.int32)),
                                jnp.asarray(ra), jnp.asarray(rb), nv)
    b = np.asarray(b).astype(np.int64) - lo - 1
    best = np.where(b >= 0, values[np.clip(b, 0, None)] if values.size
                    else pad, pad)
    return best, np.asarray(w)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_compact_list_model_matches_jax_reference(kind, dtype):
    key, ra, rb = _instance(dtype, 300, 9, kind, 7 + len(kind))
    if dtype == np.int64 and kind != "min_plus_one":
        wide = np.where(key > np.iinfo(np.int64).min, key << 33, key)
        key = wide.astype(np.int64)             # beyond int32's range
    want = _jax_reference(key, ra, rb, 9)
    got = list_two_pass(key, ra, rb, 9, np.random.default_rng(1))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("itemsize", [4, 8])
def test_vector_span_covers_every_edge_once(itemsize):
    for offset in range(0, 16, itemsize):
        for e in range(0, 34):
            head, n_vec, tail = span(offset, e, itemsize)
            vec = 16 // itemsize
            assert head + n_vec * vec + tail == e
            assert 0 <= tail < vec and head < vec
            # The body starts on a 16-byte boundary.
            assert e == head or (offset + head * itemsize) % 16 == 0
            # Head and tail fit the 2 * (VEC - 1) scalar lanes.
            assert head + tail <= 2 * (vec - 1)
