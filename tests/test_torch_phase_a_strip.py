"""CPU model of the phase-A kernel's design (``csrc/phase_a.cu``).

The CUDA kernel runs only on the card (tests/test_torch_cuda.py); this
file holds its algorithm to the plain version and to the JAX package's
``phase_a`` (its XLA ``ref`` and its Pallas kernel in interpret mode):

* the stencil: each pixel's step code (dr + 1) * 3 + (dc + 1) and its
  mask bits from the dtype's comparable view, the 3x3 cells in flat-index
  order so that `>=` breaks ties by flat index (a NaN never wins, a NaN
  pixel keeps itself), out-of-image neighbours skipped by position;
* the width regime (``kernel.strip_layout``, whose constants must match
  the source's): strips of at most 65,536 pixels hold 16-bit strip-local
  pointers, with escapes frozen as their own roots and the boundary rows'
  step codes in a table of min(S, 2) * W entries that the half-hop reads;
  wider strips hold 32-bit pointers spread by rows over C blocks (an
  escape stored as ~target), looked up through the owning block;
* in-place pointer jumping in an arbitrary thread order (a random
  permutation of the moving entries, in chunks whose reads all precede
  their writes, as a warp's do), an entry leaving the moving set once it
  reads m[v] == v, until a round changes nothing.

Inputs are made from seeds with numpy.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import DTYPES, assert_same, make_image, to_jax, to_torch
from repro.kernels.ph_phase_a import kernel as jkernel
from repro.kernels.ph_phase_a import ref as jref
from repro_torch.core.grid import NEIGHBOR_OFFSETS
from repro_torch.kernels.ph_phase_a import kernel as ka
from repro_torch.kernels.ph_phase_a import ref as tref

SELF = 4                                  # step code of (0, 0)


def comparable(img: torch.Tensor) -> torch.Tensor:
    """The kernel's exact comparable view: float32 for float32 and
    bfloat16 (widened exactly), int64 for the integer dtypes."""
    return img.float() if img.dtype.is_floating_point else img.long()


def stencil(img: torch.Tensor):
    """Step codes and mask bits of an (H, W) image, as the kernel's
    window computes them: the 3x3 cells in flat-index order from a value
    at or below every pixel (self between offsets 3 and 4), a cell
    winning on `>=`; a NaN pixel keeps itself."""
    x = comparable(img)
    h, w = x.shape
    pad = torch.zeros((h + 2, w + 2), dtype=x.dtype)
    pad[1:-1, 1:-1] = x
    rows = torch.arange(h)[:, None]
    cols = torch.arange(w)[None, :]
    lowest = -np.inf if x.dtype.is_floating_point else torch.iinfo(
        torch.int32).min
    best_v = torch.full((h, w), lowest, dtype=x.dtype)
    best_c = torch.full((h, w), -1)
    bits = torch.zeros((h, w), dtype=torch.int32)
    for k, (dr, dc) in enumerate(NEIGHBOR_OFFSETS):
        if k == 4:
            win = (x >= best_v) | torch.isnan(x.double())
            best_v = torch.where(win, x, best_v)
            best_c = torch.where(win, torch.full_like(best_c, SELF), best_c)
        v = pad[1 + dr:1 + dr + h, 1 + dc:1 + dc + w]
        inside = ((rows + dr >= 0) & (rows + dr < h) & (cols + dc >= 0)
                  & (cols + dc < w))
        win = inside & (v >= best_v)
        best_v = torch.where(win, v, best_v)
        best_c = torch.where(win, torch.full_like(best_c, (dr + 1) * 3
                                                  + (dc + 1)), best_c)
        higher = v >= x if k >= 4 else v > x
        bits |= torch.where(inside & higher, 1 << k, 0).to(torch.int32)
    return best_c.reshape(-1), bits.reshape(-1)


def jump(load, store, moving: torch.Tensor, rng, terminal_at_32: bool):
    """In-place pointer jumping in an arbitrary thread order: per round a
    random permutation of the moving entries in random chunks (a chunk
    reads before it writes; at most 512 entries, or a 32nd of the moving
    set); an entry that reads m[v] == v stops moving.  Returns the rounds
    taken."""
    rounds = 0
    while True:
        rounds += 1
        changed, still = False, []
        order = moving[torch.from_numpy(rng.permutation(len(moving)))]
        at, most = 0, max(512, len(order) // 32)
        while at < len(order):
            step = int(rng.integers(1, most + 1))
            i = order[at:at + step]
            at += step
            v = load(i)
            if terminal_at_32:               # an escape (~target) is final
                i, v = i[v >= 0], v[v >= 0]
            u = load(v)
            moved = u != v
            store(i[moved], u[moved])
            changed |= bool(moved.any())
            still.append(i[moved])
        moving = torch.cat(still) if still else moving[:0]
        if not changed:
            return rounds


def owner(v: torch.Tensor, c: int, span: int) -> torch.Tensor:
    """The cluster block holding strip entry v, by the kernel's compares
    (no division)."""
    o = torch.zeros_like(v)
    for k in range(1, ka.MAX_CLUSTER):
        o += ((k < c) & (v >= k * span)).long()
    return o


def model_strip(codes, r0: int, rows: int, w: int, s: int, rng):
    """Strip-snapped pointers of one strip (image rows r0 .. r0 + rows)
    from its step codes, as the kernel's regime for (s, w) makes them."""
    n = rows * w
    i = torch.arange(n)
    dr, dc = codes // 3 - 1, codes % 3 - 1
    step = dr * w + dc
    esc = (i // w + dr < 0) | (i // w + dr >= rows)
    base = r0 * w
    regime, c = ka.strip_layout(s, w)
    if regime == "shared16":
        m = np.where(esc.numpy(), i.numpy(), (i + step).numpy())
        m = torch.from_numpy(m.astype(np.uint16).astype(np.int64))
        assert int(m.max()) < 1 << 16 and s * w <= ka.NARROW_ENTRIES
        # Boundary rows' step codes: row 0, then the last row.
        tab = torch.cat([codes[:w], codes[(rows - 1) * w:]]) if rows > 1 \
            else codes[:w]
        assert len(tab) <= min(s, 2) * w

        def store(idx, val):
            m[idx] = val

        jump(lambda idx: m[idx], store, i, rng, terminal_at_32=False)
        last = (rows - 1) * w
        code = torch.where(m < w, tab[m.clamp(max=len(tab) - 1)],
                           torch.where(m >= last,
                                       tab[(w + m - last).clamp(
                                           0, len(tab) - 1)], SELF))
        return base + m + (code // 3 - 1) * w + (code % 3 - 1)
    # 32-bit pointers over c blocks of span = ceil(s / c) * w entries (one
    # block with the whole strip in the output buffer for "global").
    span = -(-s // c) * w
    m0 = torch.where(esc, ~(base + i + step), i + step)
    parts = [m0[k * span:(k + 1) * span].clone() for k in range(c)]

    def load(idx):
        o = owner(idx, c, span)
        out = torch.empty_like(idx)
        for k in range(c):
            sel = o == k
            out[sel] = parts[k][idx[sel] - k * span]
        return out

    def store(idx, val):
        o = owner(idx, c, span)
        for k in range(c):
            sel = o == k
            parts[k][idx[sel] - k * span] = val[sel]

    jump(load, store, i, rng, terminal_at_32=True)
    t = torch.cat(parts)[:n]
    return torch.where(t < 0, ~t, base + t)


def model_phase_a(img: torch.Tensor, strip_rows: int, seed: int = 0):
    """The kernel's algorithm on an (H, W) image or a (B, H, W) batch:
    ``(ptr, mask)`` flat int32."""
    if img.dim() == 3:
        outs = [model_phase_a(im, strip_rows, seed + b)
                for b, im in enumerate(img)]
        return tuple(torch.stack(o) for o in zip(*outs))
    rng = np.random.default_rng(seed)
    h, w = img.shape
    s = max(1, min(strip_rows, h))
    codes, bits = stencil(img)
    ptr = torch.cat([model_strip(codes[r0 * w:min(h, r0 + s) * w], r0,
                                 min(s, h - r0), w, s, rng)
                     for r0 in range(0, h, s)])
    return ptr.to(torch.int32), bits


def column_ramp(h: int, w: int, s: int) -> np.ndarray:
    """The deepest in-strip chains: columns step up by 2s, and within a
    column values fall off from each strip's middle row, so every ascent
    runs to that row and along it to the right edge."""
    r, c = np.mgrid[:h, :w]
    return (c * 2 * s - np.abs(r % s - s // 2)).astype(np.float32)


def held(img: np.ndarray, dtype: str, s: int, pallas: bool = False):
    """The model against the port's plain version and the JAX package's
    XLA ref (and its Pallas kernel in interpret mode), bitwise."""
    x = to_torch(img, dtype)
    got = model_phase_a(x, s)
    want = tref.phase_a(x, strip_rows=s)
    for a, b, what in zip(want, got, ("ptr", "mask")):
        assert_same(a, b, f"{what} vs plain {dtype} S={s} {img.shape}")
    if img.ndim == 2:
        jx = to_jax(img, dtype)
        refs = [jref.phase_a(jx, strip_rows=s)]
        if pallas:
            refs.append(jkernel.phase_a(jx, strip_rows=s, interpret=True))
        for want in refs:
            for a, b, what in zip(want, got, ("ptr", "mask")):
                assert_same(a, b, f"{what} vs JAX {dtype} S={s} {img.shape}")


def test_layout_constants_match_kernel_source():
    src = (Path(ka.__file__).parent / "csrc" / "phase_a.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert const("kSmemBytes") == ka.SMEM_BYTES
    assert const("kNarrowEntries") == ka.NARROW_ENTRIES
    assert const("kMaxCluster") == ka.MAX_CLUSTER
    assert const("kStaticBytes") == ka.STATIC_BYTES
    # The wide kernel's static array fits what is kept for it.
    assert "__shared__ int vote[2][kMaxCluster];" in src
    assert 4 * 2 * ka.MAX_CLUSTER <= ka.STATIC_BYTES


@pytest.mark.parametrize("s,w,want", [
    (8, 4096, ("shared16", 1)), (8, 8192, ("shared16", 1)),
    (8, 8193, ("cluster", 2)), (16, 4097, ("cluster", 2)),
    (8, 10240, ("cluster", 2)), (8, 16384, ("cluster", 3)),
    (16, 10240, ("cluster", 4)), (16, 16384, ("cluster", 6)),
    (3, 30000, ("cluster", 3)), (8, 57856, ("cluster", 8)),
    (8, 57857, ("global", 1)), (1, 65536, ("shared16", 1)),
    (1, 65537, ("global", 1))])
def test_width_regimes(s, w, want):
    """The regime edges: S * W = 65,536; the fewest cluster blocks whose
    rows fit 227 KB (ceil(S / C) * W * 4 B plus the static array); past
    the widest strip 8 blocks hold, the output buffer."""
    assert ka.strip_layout(s, w) == want
    if want[0] == "cluster":
        c = want[1]
        assert -(-s // c) * w * 4 + ka.STATIC_BYTES <= ka.SMEM_BYTES
        assert c == 2 or -(-s // (c - 1)) * w * 4 + ka.STATIC_BYTES > \
            ka.SMEM_BYTES


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["gauss", "ties"])
def test_model_matches_references(dtype, kind):
    """13 rows: S = 3 and 8 leave a ragged last strip, 16 exceeds H."""
    img = make_image(dtype, kind, seed=len(kind) + len(dtype),
                     shape=(13, 9))
    for s in (1, 3, 8, 16):
        held(img, dtype, s, pallas=s == 3)


@pytest.mark.parametrize("shape", [(1, 17), (17, 1), (1, 1), (5, 40)])
def test_model_short_and_thin_images(shape):
    """H < S, a single row (every row both first and last), one column."""
    img = make_image("float32", "ties", seed=sum(shape), shape=shape)
    for s in (1, 3, 8, 16):
        held(img, "float32", s)


@pytest.mark.parametrize("s", [8, 16])
@pytest.mark.parametrize("dw", [-1, 0, 1])
@pytest.mark.parametrize("kind", ["gauss", "ties"])
def test_model_either_side_of_the_16_bit_switch(s, dw, kind):
    """S * W = 65,536 and one column either side: 16-bit pointers and the
    table, then 32-bit pointers over two blocks."""
    w = ka.NARROW_ENTRIES // s + dw
    img = make_image("float32", kind, seed=s + dw, shape=(2 * s + 3, w))
    held(img, "float32", s, pallas=kind == "ties")


@pytest.mark.parametrize("s,w", [(8, 300), (8, 8193), (3, 30000)])
def test_model_column_ramp(s, w):
    """Chains as long as the width, in the 16-bit and the cluster
    regimes (8 x 8193: two blocks of 4 rows; 3 x 30000: three blocks of
    one row each)."""
    held(column_ramp(2 * s + 3, w, s), "float32", s)


def test_model_past_the_widest_cluster():
    """One column past the widest strip a cluster holds: 32-bit pointers
    in the output buffer; a ramp and ties."""
    s = 8
    w = (ka.SMEM_BYTES - ka.STATIC_BYTES) // 4 + 1
    assert ka.strip_layout(s, w) == ("global", 1)
    held(column_ramp(s + 1, w, s), "float32", s)
    held(make_image("uint8", "ties", seed=3, shape=(s + 1, w)), "uint8", s)


@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_model_constant_image(dtype):
    img = np.full((21, 8193), 7, dtype=dtype)
    for s in (1, 8):
        held(img, dtype, s)


@pytest.mark.parametrize("w", [70, 8193])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_signed_zeros(dtype, w):
    """-0.0 ties +0.0 in the comparable view; flat index breaks the tie."""
    img = np.random.default_rng(w).choice(
        [0.0, -0.0, 1.0, -1.0], size=(19, w)).astype(np.float32)
    for s in (3, 8):
        held(img, dtype, s)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_nan_pixels(dtype):
    """A NaN never wins a window and a NaN pixel points at itself, in the
    kernel's flat order as in the plain version's sequence from self."""
    img = make_image("float32", "ties", seed=11, shape=(13, 40))
    img[np.random.default_rng(11).random(img.shape) < 0.2] = np.nan
    for s in (1, 4, 8):
        held(img, dtype, s)


@pytest.mark.parametrize("w", [40, 8193])
def test_model_uint8_zero_borders(w):
    """uint8's 0 is a real value: zeros at every border never lose to an
    out-of-image neighbour."""
    img = np.zeros((11, w), np.uint8)
    img[5, w // 2] = 1
    img[3:8, 2:5] = 2
    for s in (1, 4, 8):
        held(img, "uint8", s)


@pytest.mark.parametrize("w", [10, 8193])
def test_model_batch(w):
    imgs = np.stack([make_image("float32", "gauss", seed=i, shape=(9, w))
                     for i in range(3)])
    held(imgs, "float32", 4)
    x = torch.from_numpy(imgs)
    got = model_phase_a(x, 4)
    for i in range(3):
        one = jref.phase_a(jnp.asarray(imgs[i]), strip_rows=4)
        for a, b in zip(one, got):
            assert_same(a, b[i], f"batch row {i}")
