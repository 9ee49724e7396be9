"""CPU model of the distance kernel's design (``csrc/distance.cu``).

The CUDA kernel runs only on the card (tests/test_torch_cuda.py); this
file holds its arithmetic to the plain version and to the JAX package's
``distance_matrix`` on the host:

* the sort: each row's monotone 32-bit keys, sorted per block of ``n``
  slots (+inf pads past F; ``n`` = 1024 x a power of two up to 16), then
  merged level by level across a cluster of C blocks, each block making
  its ``n`` outputs from windows found by two merge-path splits; for every
  cluster of 1, 2 or 4 blocks that holds the row it must equal a full sort
  of the keys exactly (which layout the kernel picks is the card tests'
  concern);
* the pair stage: tiles of ``MERGE_TILE`` merged outputs, each with its
  splits found by binary search (equal to a full merge's prefix counts),
  windows of the tile's length, a double sum per tile and a fixed-order
  sum over tiles; sw within rtol 1e-5 of both references;
* bn as column-chunk maxima: bitwise equal to both references.

Inputs are made from seeds with numpy.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ph_distance import ref as jref
from repro_torch.kernels.ph_distance import kernel as kd
from repro_torch.kernels.ph_distance import ref as rd


def to_key(x: torch.Tensor) -> torch.Tensor:
    """The kernel's order-preserving map of float32 bits to uint32 (held
    in int64): negative values flip every bit, others set the top bit, so
    -0.0 sorts just below +0.0."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(u >= 0x80000000, u ^ 0xFFFFFFFF, u | 0x80000000)


def from_key(k: torch.Tensor) -> torch.Tensor:
    u = torch.where(k >= 0x80000000, k ^ 0x80000000, k ^ 0xFFFFFFFF)
    u = torch.where(u >= 0x80000000, u - (1 << 32), u)
    return u.to(torch.int32).view(torch.float32)


def merge_split(x, y, t: int) -> int:
    """How many of the first t outputs of the merge of sorted x and y come
    from x; x wins ties (the kernel's binary search)."""
    lo, hi = max(0, t - len(y)), min(t, len(x))
    while lo < hi:
        mid = (lo + hi) // 2
        if x[mid] <= y[t - 1 - mid]:
            lo = mid + 1
        else:
            hi = mid
    return lo


def merged_from_x(x, y) -> torch.Tensor:
    """Whether each output of the full stable merge (x first on ties)
    comes from x."""
    order = torch.sort(torch.cat([x, y]), stable=True).indices
    return order < len(x)


def merge_window(x, y, a0, a1, t0, t1):
    """The tile's outputs [t0, t1) from its windows x[a0:a1] and
    y[t0 - a0 : t1 - a1], merged with x first on ties."""
    wx, wy = x[a0:a1], y[t0 - a0:t1 - a1]
    assert len(wx) + len(wy) == t1 - t0           # a tile-length window
    return torch.sort(torch.cat([wx, wy]), stable=True).values


def cluster_sort(row: torch.Tensor, c: int, n: int) -> torch.Tensor:
    """The kernel's sort of one row (float32) as keys: c blocks of n slots
    (block b takes the runs of 32 slots b, b + c, ...), then log2(c) merge levels, block b
    making outputs [o0, o0 + n) of its group's merge from two
    split-bounded windows."""
    inf = torch.tensor([np.inf], dtype=torch.float32)
    keys = torch.full((c * n,), int(to_key(inf)))
    keys[:row.numel()] = to_key(row)
    # Block b holds every c-th run of 32 slots of the tile, from run b.
    runs = keys.view(-1, c, 32).transpose(0, 1).reshape(c, n)
    runs = torch.sort(runs, dim=1).values.reshape(-1)
    half = 1
    while half < c:
        out = torch.empty_like(runs)
        m = half * n
        for b in range(c):
            g0 = (b // (2 * half)) * (2 * half)
            x = runs[g0 * n:(g0 + half) * n]
            y = runs[(g0 + half) * n:(g0 + 2 * half) * n]
            o0 = (b - g0) * n
            a0, a1 = merge_split(x, y, o0), merge_split(x, y, o0 + n)
            assert 0 <= a0 <= a1 <= m
            out[b * n:(b + 1) * n] = merge_window(x, y, a0, a1, o0, o0 + n)
        runs, half = out, half * 2
    return runs[:row.numel()]


def cluster_layouts(f: int):
    """Every (blocks, slots per block) a cluster of 1, 2 or 4 blocks can
    sort a row of f in: the fewest slots of 1024 x 2^i (up to 16,384)
    that hold the block's share."""
    out = []
    for c in (1, 2, 4):
        n = 1024
        while n * c < f:
            n *= 2
        if n <= kd.CLUSTER_SLOTS // 4:
            out.append((c, n))
    return out


def tiled_w1(pa, da, pb, db) -> torch.Tensor:
    """w1 of one (pair, direction) the kernel's way: va merges sorted pa
    with sorted db, vb sorted pb with sorted da; a double sum per tile of
    MERGE_TILE outputs, then the tiles in order."""
    f = pa.numel()
    xa, ya, xb, yb = (torch.sort(to_key(v)).values for v in (pa, db, pb, da))
    tile, total = kd.MERGE_TILE, 0.0
    for t0 in range(0, 2 * f, tile):
        t1 = min(2 * f, t0 + tile)
        a0, a1 = merge_split(xa, ya, t0), merge_split(xa, ya, t1)
        c0, c1 = merge_split(xb, yb, t0), merge_split(xb, yb, t1)
        va = from_key(merge_window(xa, ya, a0, a1, t0, t1))
        vb = from_key(merge_window(xb, yb, c0, c1, t0, t1))
        total += float(torch.sum(torch.abs(va - vb).double()))
    return torch.tensor(total, dtype=torch.float64).float()


def model_distance_matrix(pts, diag, prof):
    """(sw, bn) of the kernel's design over the i < j pairs, mirrored."""
    b, k, f = pts.shape
    sw = torch.zeros((b, b), dtype=torch.float32)
    bn = torch.zeros((b, b), dtype=torch.float32)
    per = -(-f // kd.BN_CHUNKS)
    for i in range(b):
        for j in range(i + 1, b):
            s = torch.zeros((), dtype=torch.float32)
            for kk in range(k):
                s = s + tiled_w1(pts[i, kk], diag[i, kk], pts[j, kk],
                                 diag[j, kk])
            sw[i, j] = sw[j, i] = s / k
            d = torch.abs(prof[i] - prof[j])
            chunks = [d[c * per:(c + 1) * per].max() for c in
                      range(kd.BN_CHUNKS) if c * per < f]
            bn[i, j] = bn[j, i] = 0.5 * torch.stack(chunks).max()
    return sw, bn


def _rows(rng, b, k, f, kind):
    x = rng.normal(size=(b, k, f)) * 30
    if kind == "ties":
        x = np.round(x / 20)
    elif kind == "signed_zeros":
        x = rng.choice([0.0, -0.0, 2.5, -2.5], size=(b, k, f))
    elif kind == "pad_heavy":
        x = np.where(rng.random((b, k, f)) < 0.9, 0.0, x)
        x[0] = 0.0                                    # an all-zero diagram
    return torch.from_numpy(x.astype(np.float32))


@pytest.mark.parametrize("f", [1, 100, 5000, 16385, 40000, 65536])
@pytest.mark.parametrize("kind", ["gauss", "ties", "signed_zeros",
                                  "pad_heavy"])
def test_cluster_sort_model_equals_full_sort(f, kind):
    rng = np.random.default_rng(f)
    row = _rows(rng, 1, 1, f, kind)[0, 0]
    want = torch.sort(to_key(row)).values
    layouts = cluster_layouts(f)
    assert layouts and layouts[-1][0] == 4
    for c, n in layouts:
        got = cluster_sort(row, c, n)
        assert torch.equal(got, want), (c, n)
        # Back to floats: the plain sort's values, every -0.0 before +0.0.
        vals = from_key(got)
        assert torch.equal(vals, torch.sort(row).values)
        signs = torch.signbit(vals[vals == 0]).long()
        assert torch.equal(signs, torch.sort(signs, descending=True).values)


@pytest.mark.parametrize("f", [1, 7, 100, 5000])
@pytest.mark.parametrize("kind", ["gauss", "ties", "signed_zeros",
                                  "pad_heavy"])
def test_merge_split_equals_full_merge_prefix_counts(f, kind):
    rng = np.random.default_rng(7 * f + len(kind))
    rows = _rows(rng, 2, 1, f, kind)
    x = torch.sort(to_key(rows[0, 0])).values
    y = torch.sort(to_key(rows[1, 0])).values
    from_x = merged_from_x(x, y)
    prefix = torch.cat([torch.zeros(1, dtype=torch.int64),
                        torch.cumsum(from_x.long(), 0)])
    for t in sorted({0, 1, f, 2 * f - 1, 2 * f,
                     *range(0, 2 * f, max(1, f // 7))}):
        if 0 <= t <= 2 * f:
            assert merge_split(x, y, t) == int(prefix[t]), t


PAIR_CASES = [
    (3, 2, 1, "gauss"),                   # F = 1
    (3, 2, 100, "ties"),                  # F below one tile
    (2, 3, 5000, "signed_zeros"),         # F not a power of two, 2 tiles
    (3, 2, 4097, "pad_heavy"),            # pads, an all-zero diagram
    (2, 1, 65536, "gauss"),               # the engine's F at K = 1
]


def _tables(b, k, f, kind):
    rng = np.random.default_rng(b * k + f)
    pts, diag = _rows(rng, b, k, f, kind), _rows(rng, b, k, f, kind)
    prof = torch.sort(torch.abs(_rows(rng, b, 1, f, kind)[:, 0]), dim=1,
                      descending=True).values
    return pts, diag, prof


@pytest.mark.parametrize("b,k,f,kind", PAIR_CASES)
def test_tiled_pair_model_matches_plain_version(b, k, f, kind):
    pts, diag, prof = _tables(b, k, f, kind)
    sw, bn = model_distance_matrix(pts, diag, prof)
    want_sw, want_bn = rd.distance_matrix(pts, diag, prof)
    assert torch.equal(bn, want_bn)
    torch.testing.assert_close(sw, want_sw, rtol=1e-5, atol=0)
    assert torch.equal(sw, sw.T) and not sw.diagonal().any()


@pytest.mark.parametrize("b,k,f,kind", PAIR_CASES)
def test_tiled_pair_model_matches_jax_reference(b, k, f, kind):
    pts, diag, prof = _tables(b, k, f, kind)
    sw, bn = model_distance_matrix(pts, diag, prof)
    want_sw, want_bn = (torch.from_numpy(np.array(m)) for m in
                        jref.distance_matrix(*(jnp.asarray(t.numpy())
                                               for t in (pts, diag, prof))))
    assert torch.equal(bn, want_bn)
    torch.testing.assert_close(sw, want_sw, rtol=1e-5, atol=0)


def test_layout_constants_match_the_kernel():
    assert kd.MERGE_TILE == 512 * 15
    assert kd.merge_tiles(65536) == 18 and kd.merge_tiles(1) == 1
    assert kd.sort_width(65536) == 65536 and kd.sort_width(4097) == 4097
    assert kd.sort_width(65537) == 131072
    assert kd.sort_width(131072) == 131072
    assert kd.sort_width(196609) == 262144
    assert kd.CLUSTER_SLOTS == 4 * 16384
