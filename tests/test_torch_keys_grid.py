"""Port parity: packed keys and grid helpers (repro_torch.core) vs repro.core.

Without 64-bit mode the reference computes int32 key words only, so
``pack_keys`` is held to a numpy construction from the reference's
``monotone_key32``.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from _torch_parity import (DTYPES, assert_same, make_image, to_jax,
                           to_torch)
from repro.core import grid as jgrid
from repro.core import packed_keys as jpk
from repro_torch.core import grid as tgrid
from repro_torch.core import packed_keys as tpk

SPECIAL_F32 = np.array([-np.inf, -1e30, -1.0, -1e-45, -0.0, 0.0, 1e-45,
                        1e-38, 1.0, 3e38, np.inf], np.float32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["gauss", "ties", "negative"])
def test_monotone_key32_matches_reference(dtype, kind):
    img = make_image(dtype, kind, seed=3, shape=(9, 13))
    assert_same(jpk.monotone_key32(to_jax(img, dtype)),
                tpk.monotone_key32(to_torch(img, dtype)),
                f"monotone_key32 {dtype}/{kind}")


def test_monotone_key32_specials_and_signed_zeros():
    """Key equality follows each backend's own comparisons.  The
    reference's CPU backend flushes subnormals to zero when comparing, so
    its keys for them collapse onto 0; PyTorch compares subnormals exactly
    on the CPU and on the card, so the port's keys keep them distinct
    (and its diagrams order them as IEEE does)."""
    x = torch.from_numpy(SPECIAL_F32)
    want = np.asarray(jpk.monotone_key32(jnp.asarray(SPECIAL_F32)))
    got = tpk.monotone_key32(x).numpy()
    normal = (SPECIAL_F32 == 0) | (np.abs(SPECIAL_F32) >= 1.1754944e-38)
    np.testing.assert_array_equal(want[normal], got[normal])
    assert got[4] == got[5], "-0.0 and +0.0 share a key"
    distinct = [0, 1, 2, 3, 5, 6, 7, 8, 9, 10]
    assert np.all(np.diff(got[distinct]) > 0)
    eq = (x[:, None] == x[None, :]).numpy()
    np.testing.assert_array_equal(eq, got[:, None] == got[None, :])


@pytest.mark.parametrize("dtype", DTYPES)
def test_pack_keys_and_index_round_trip(dtype):
    img = make_image(dtype, "gauss", seed=5, shape=(7, 9)).reshape(-1)
    k32 = np.asarray(jpk.monotone_key32(to_jax(img, dtype))).astype(np.int64)
    want = (k32 << 32) | (np.arange(img.size, dtype=np.int64) + 1)
    got = tpk.pack_keys(to_torch(img, dtype))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(want, got.numpy())
    np.testing.assert_array_equal(tpk.packed_index(got).numpy(),
                                  np.arange(img.size, dtype=np.int32))
    # Packed order == lexicographic (value, index) order.
    order = np.argsort(got.numpy(), kind="stable")
    vals = img.astype(np.float64)
    np.testing.assert_array_equal(order, np.lexsort((np.arange(img.size),
                                                     vals)))
    pad = tpk.key_pad(torch.int64)
    assert tpk.packed_index(torch.tensor([pad])).item() == -1
    assert int(got.min()) > pad


@pytest.mark.parametrize("n,k,width", [(50, 7, 2), (200, 16, 3), (31, 64, 2),
                                       (1, 1, 2)])
def test_masked_top_k_matches_full_selection(n, k, width):
    rng = np.random.default_rng(n + k)
    vals = torch.from_numpy(rng.normal(size=n).astype(np.float32))
    mask = torch.from_numpy(rng.random(n) < 0.6)
    keys = tpk.pack_keys(vals)
    top, pos = tpk.masked_top_k(keys, mask, k, width)
    masked = np.where(mask.numpy(), keys.numpy(), tpk.key_pad(torch.int64))
    want = np.sort(masked)[::-1][:min(k, n)]
    np.testing.assert_array_equal(top.numpy(), want)
    valid = top.numpy() > tpk.key_pad(torch.int64)
    np.testing.assert_array_equal(
        pos.numpy()[valid], tpk.packed_index(top).numpy()[valid])
    # Ranks take the full top-k path; JAX's top_k is the reference.
    rank = torch.argsort(torch.argsort(keys, stable=True)).to(torch.int32)
    jt, jp = jpk.masked_top_k(jnp.asarray(rank.numpy()),
                              jnp.asarray(mask.numpy()), k)
    tt, tp = tpk.masked_top_k(rank, mask, k)
    assert_same(jt, tt, "rank top keys")
    jv = np.asarray(jt) > tpk.key_pad(torch.int32)
    np.testing.assert_array_equal(np.asarray(jp)[jv], tp.numpy()[jv])


def test_resolution_rules_and_boundary_checks():
    for dt in (torch.uint8, torch.int16, torch.int32, torch.float32,
               torch.bfloat16):
        assert tpk.resolve_merge_keys("packed", dt) == "packed"
        assert tpk.resolve_merge_keys("rank", dt) == "rank"
    assert tpk.resolve_merge_keys("packed", torch.float64) == "rank"
    with pytest.raises(ValueError):
        tpk.resolve_merge_keys("bogus", torch.float32)
    with pytest.raises(ValueError):
        tpk.filtration_view(torch.zeros(2, 2, dtype=torch.int32), "sublevel")
    x = torch.tensor([1.0, -2.5])
    assert torch.equal(tpk.filtration_view(x, "sublevel"), -x)
    for bad in (np.array([1.0, np.nan], np.float32),
                torch.tensor([np.inf, 0.0])):
        with pytest.raises(ValueError, match="non-finite"):
            tpk.check_finite(bad)
    tpk.check_finite(torch.tensor([np.inf, 0.0]), allow_inf=True)


NAN_MSG = "NaN values cannot be ordered"
INF_MSG = "infinite values collide"
# case: (values placed at (flat index, value), allow_inf, expected message)
CHECK_CASES = {
    "finite": ((), False, None),
    "nan": (((37, np.nan),), False, NAN_MSG),
    "pos_inf": (((63, np.inf),), False, INF_MSG),
    "neg_inf": (((0, -np.inf),), False, INF_MSG),
    "nan_and_inf": (((5, np.inf), (60, np.nan), (61, -np.inf)), False,
                    NAN_MSG),
    "allow_inf": (((3, np.inf), (40, -np.inf)), True, None),
    "allow_inf_nan": (((3, np.inf), (63, np.nan)), True, NAN_MSG),
}


def _check_outcome(check, values, allow_inf):
    """``"same"`` when ``check`` hands back ``values`` itself, else the
    message it raised (or ``"other"`` for any other return)."""
    try:
        got = check(values, where="frame", allow_inf=allow_inf)
    except ValueError as e:
        return str(e)
    return "same" if got is values else "other"


def _assert_check_parity(ref_values, values, allow_inf, message):
    want = _check_outcome(jpk.check_finite, ref_values, allow_inf)
    got = _check_outcome(tpk.check_finite, values, allow_inf)
    assert got == want
    if message is None:
        assert got == "same"
    else:
        assert message in got


@pytest.mark.parametrize("case", list(CHECK_CASES))
@pytest.mark.parametrize("dtype,container", [
    ("float32", "tensor"), ("float32", "numpy"),
    ("bfloat16", "tensor"),
    ("float16", "tensor"), ("float16", "numpy"),
    ("float64", "tensor"), ("float64", "numpy")])
def test_check_finite_single_pass(dtype, container, case):
    """One min/max pass keeps the reference's contract, message for
    message: NaN wins over ±inf, ``allow_inf`` still rejects NaN, and the
    caller's object comes back."""
    placed, allow_inf, message = CHECK_CASES[case]
    img = np.linspace(-3.0, 3.0, 64, dtype=np.float64).reshape(8, 8)
    for i, v in placed:
        img.reshape(-1)[i] = v
    if dtype == "bfloat16":
        ref_values = to_jax(img.astype(np.float32), dtype)
        values = to_torch(img.astype(np.float32), dtype)
    else:
        ref_values = img.astype(dtype)
        values = (ref_values.copy() if container == "numpy"
                  else torch.from_numpy(ref_values.copy()))
    _assert_check_parity(ref_values, values, allow_inf, message)


@pytest.mark.parametrize("container", ["tensor", "numpy"])
@pytest.mark.parametrize("kind", ["empty", "int32", "uint8", "bool"])
def test_check_finite_passes_empty_and_integer(kind, container):
    """Empty floating input and integer or bool input come back untouched,
    as from the reference."""
    ref_values = (np.zeros((0, 4), np.float32) if kind == "empty"
                  else (np.arange(-32, 32).reshape(8, 8) % 7).astype(kind))
    values = (ref_values.copy() if container == "numpy"
              else torch.from_numpy(ref_values.copy()))
    _assert_check_parity(ref_values, values, False, None)


def test_check_finite_makes_no_full_size_host_temporary():
    """On a host tensor the check allocates nothing near the input's size
    (the two-test form made a 4·numel ``abs`` and numel-byte masks)."""
    x = torch.rand(1024, 1024)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU],
            profile_memory=True) as prof:
        assert tpk.check_finite(x) is x
    allocated = [e.cpu_memory_usage for e in prof.events()]
    assert max(allocated, default=0) < x.numel(), allocated


@pytest.mark.parametrize("dtype", DTYPES)
def test_shift2d_matches_reference(dtype):
    img = make_image(dtype, "gauss", seed=1, shape=(5, 7))
    jx, tx = to_jax(img, dtype), to_torch(img, dtype)
    for dr, dc in jgrid.NEIGHBOR_OFFSETS + [(0, 0)]:
        assert_same(jgrid.shift2d(jx, dr, dc, jgrid.neg_inf(jx.dtype)),
                    tgrid.shift2d(tx, dr, dc, tgrid.neg_inf(tx.dtype)),
                    f"shift2d {dtype} ({dr}, {dc})")
    assert tgrid.NEIGHBOR_OFFSETS == jgrid.NEIGHBOR_OFFSETS
    for sentinel in ("neg_inf", "pos_inf"):
        want = getattr(jgrid, sentinel)(jx.dtype)
        got = getattr(tgrid, sentinel)(tx.dtype)
        assert float(want) == float(got), sentinel
    for kd in (torch.int32, torch.int64):
        assert tpk.key_top(kd) == torch.iinfo(kd).max
        assert tpk.key_pad(kd) == torch.iinfo(kd).min
    with pytest.raises(ValueError):
        tgrid.shift2d(tx, 2, 0, 0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fixed_point_iterate_matches_reference(seed):
    """Pointer doubling on a random forest: same fixed point, same count."""
    rng = np.random.default_rng(seed)
    n = 300
    parent = np.arange(n, dtype=np.int32)
    order = rng.permutation(n)
    for i in range(1, n):             # each node points at an earlier one
        if rng.random() < 0.9:
            parent[order[i]] = order[rng.integers(0, i)]
    jm, jk = jgrid.fixed_point_iterate(lambda q: q[q], jnp.asarray(parent))
    tm, tk = tgrid.fixed_point_iterate(lambda q: q[q.long()],
                                       torch.from_numpy(parent))
    assert_same(jm, tm, "fixed point")
    assert int(jk) == tk


@pytest.mark.parametrize("keys", ["rank", "packed"])
def test_higher_neighbor_basins_matches_reference(keys):
    shape = (6, 8)
    img = make_image("float32", "ties", seed=4, shape=shape).reshape(-1)
    rng = np.random.default_rng(4)
    labels = rng.integers(0, img.size, size=img.size).astype(np.int32)
    x = rng.integers(0, img.size, size=20).astype(np.int32)
    rank = np.argsort(np.argsort(img, kind="stable"), kind="stable").astype(
        np.int32)
    if keys == "rank":
        jkey, tkey = jnp.asarray(rank), torch.from_numpy(rank)
    else:   # reference keys are rank-encoded here; the port packs
        jkey = jnp.asarray(rank)
        tkey = tpk.pack_keys(torch.from_numpy(img))
    valid = rng.random(20) < 0.8
    jok, jb = jgrid.higher_neighbor_basins(
        jnp.asarray(x), jkey[x], jkey, jnp.asarray(labels), shape,
        jnp.asarray(valid))
    tx = torch.from_numpy(x)
    tok, tb = tgrid.higher_neighbor_basins(
        tx, tkey[tx.long()], tkey, torch.from_numpy(labels), shape,
        torch.from_numpy(valid))
    assert_same(jok, tok, "ok")
    assert_same(jb, tb, "basin")
