"""Port parity: flash attention (repro_torch.kernels.flash_attention) vs
repro.kernels.flash_attention.

On the CPU the port's op runs its plain version through the autograd
Function the card uses.  Both are held to the reference's Pallas kernel
(interpret mode) and to its plain version at the reference test's
tolerances: 2e-5 for float32, 2e-2 for bfloat16 (bfloat16 inputs, float32
scores, probabilities rounded to bfloat16 at another point of the sum).
Ragged lengths, which the Pallas kernel does not tile, are held to the
reference's plain version; gradients to its ``custom_vjp`` at 2e-4.
"""
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.flash_attention import kernel as jkernel
from repro.kernels.flash_attention import ops as jops
from repro.kernels.flash_attention import ref as jref
from repro.models import attention as jattention
from repro_torch.kernels.flash_attention import kernel, ops, ref

CASES = [
    # (B, H, KV, Sq, Skv, hd, causal, window)
    (1, 1, 1, 128, 128, 64, True, None),
    (2, 4, 2, 128, 128, 64, True, None),
    (1, 8, 1, 256, 256, 128, True, None),      # MQA
    (2, 4, 4, 128, 128, 128, False, None),     # bidirectional MHA
    (1, 2, 2, 256, 256, 64, True, 128),        # local window
    (1, 4, 2, 128, 256, 64, False, None),      # cross-ish (Sq != Skv)
]
RAGGED = [
    (1, 32, 8, 100, 100, 128, True, None),     # the LM's GQA 32/8, hd 128
    (2, 4, 2, 70, 130, 64, False, None),
    (1, 2, 1, 97, 97, 256, True, 40),          # window, hd 256
    (1, 2, 2, 8, 4, 64, True, 2),              # rows with no visible key
]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _mk(case, dtype, seed=0):
    b, h, kv, sq, skv, hd = case[:6]
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=shape).astype(np.float32) for shape in
              ((b, h, sq, hd), (b, kv, skv, hd), (b, kv, skv, hd))]
    jdt, tdt, _ = DTYPES[dtype]
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_op_and_plain_match_pallas_kernel_and_ref(case, dtype):
    causal, window = case[6:]
    (jq, jk, jv), (q, k, v) = _mk(case, dtype)
    tol = DTYPES[dtype][2]
    pallas = jkernel.flash_attention_fwd(jq, jk, jv, causal=causal,
                                         window=window, q_block=64,
                                         kv_block=64, interpret=True)
    jplain = jref.attention(jq, jk, jv, causal=causal, window=window)
    got = ops.flash_attention(q, k, v, causal, window)
    plain = ref.attention(q, k, v, causal=causal, window=window)
    assert got.dtype == q.dtype and got.shape == q.shape
    for want in (pallas, jplain):
        np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)
        np.testing.assert_allclose(_f32(plain), _f32(want), atol=tol,
                                   rtol=tol)
    assert torch.equal(ops.flash_attention(q, k, v, causal, window,
                                           plain=True), plain)


@pytest.mark.parametrize("case", RAGGED)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ragged_lengths_match_reference_plain_version(case, dtype):
    causal, window = case[6:]
    (jq, jk, jv), (q, k, v) = _mk(case, dtype, seed=1)
    tol = DTYPES[dtype][2]
    got = _f32(ops.flash_attention(q, k, v, causal, window))
    want = _f32(jref.attention(jq, jk, jv, causal=causal, window=window))
    # The reference's softmax gives NaN where no key is visible; the
    # Pallas kernel, and the port, give 0 there.
    empty = np.isnan(want)
    np.testing.assert_array_equal(got[empty], 0.0)
    np.testing.assert_allclose(got[~empty], want[~empty], atol=tol, rtol=tol)


def test_rows_without_visible_keys_give_zero_like_pallas_kernel():
    case = RAGGED[-1]
    (jq, jk, jv), (q, k, v) = _mk(case, "float32", seed=2)
    pallas = jkernel.flash_attention_fwd(jq, jk, jv, causal=True, window=2,
                                         interpret=True)
    got = ops.flash_attention(q, k, v, True, 2)
    np.testing.assert_allclose(_f32(got), _f32(pallas), atol=2e-5, rtol=2e-5)
    assert not got[:, :, 5:].any()          # query rows 5..7 see no key


def test_grads_match_reference_custom_vjp():
    (jq, jk, jv), (q, k, v) = _mk((1, 2, 1, 128, 128, 64), "float32")

    def loss_ref(q, k, v):
        return jnp.sum(jops.flash_attention(q, k, v, True, None, True) ** 2)

    want = jax.grad(loss_ref, argnums=(0, 1, 2))(jq, jk, jv)
    inputs = [t.clone().requires_grad_() for t in (q, k, v)]
    (ops.flash_attention(*inputs, True, None) ** 2).sum().backward()
    for t, w in zip(inputs, want):
        np.testing.assert_allclose(_f32(t.grad), np.asarray(w), atol=2e-4,
                                   rtol=2e-4)
    # The window and GQA grouping flow through the recompute too.
    (jq, jk, jv), (q, k, v) = _mk((1, 4, 2, 64, 64, 64), "float32", seed=3)
    want = jax.grad(lambda *a: jnp.sum(jref.attention(
        *a, causal=True, window=16) ** 2), argnums=(0, 1, 2))(jq, jk, jv)
    inputs = [t.clone().requires_grad_() for t in (q, k, v)]
    (ops.flash_attention(*inputs, True, 16) ** 2).sum().backward()
    for t, w in zip(inputs, want):
        np.testing.assert_allclose(_f32(t.grad), np.asarray(w), atol=2e-4,
                                   rtol=2e-4)


def test_kernel_wrapper_takes_only_cuda_tensors():
    _, (q, k, v) = _mk(CASES[0], "float32")
    with pytest.raises(ValueError, match="CUDA"):
        kernel.flash_attention_fwd(q, k, v)
    assert kernel.LIBRARY.launches == 0


@pytest.mark.parametrize("hd", [16, 96])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_head_dims_the_kernel_does_not_take_route_to_plain(hd, dtype):
    """The op's route is decided by shape, as the reference's
    ``_flash_kernel_ok``: a CUDA tensor of head dim 64, 128 or 256 goes to
    the kernel, any other head dim to the plain version, and a CPU tensor
    always to the plain version.  On the host the op at hd 16 and 96 is
    the plain version bitwise and holds to the reference's blockwise XLA
    path; nothing launches."""
    case = (2, 4, 2, 40, 40, hd, True, None)
    (jq, jk, jv), (q, k, v) = _mk(case, dtype, seed=5)
    tol = DTYPES[dtype][2]
    got = ops.flash_attention(q, k, v, True, None)
    assert torch.equal(got, ref.attention(q, k, v, causal=True))
    want = jattention.blockwise_attention(
        *(t.transpose(0, 2, 1, 3) for t in (jq, jk, jv)), q_positions=None,
        kv_positions=None, causal=True, window=None, q_block=16,
        kv_block=16).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)
    assert not ops.kernel_route(q)
    for d in (16, 32, 96, 64, 128, 256):
        card = types.SimpleNamespace(is_cuda=True, shape=(1, 4, 8, d))
        assert ops.kernel_route(card) is (d in kernel.HEAD_DIMS)
    assert kernel.LIBRARY.launches == 0


def _bf16(shape, offset=0):
    n = int(np.prod(shape))
    return torch.zeros(n + offset, dtype=torch.bfloat16)[offset:].view(shape)


@pytest.mark.parametrize("view,addressable", [
    ("contiguous", True),
    ("transposed (B, S, H, hd)", True),
    ("one KV head of a packed qkv", True),
    ("base off by one element", False),
    ("row stride of 132 elements", False),
    ("expanded heads", False),
    ("odd stride on an extent-1 dim", True),
])
def test_tma_addressable_on_strided_views(view, addressable):
    """Which bfloat16 views the kernel's TMA loads read in place (a
    16-byte aligned base, and every stepped dim's stride a positive
    multiple of 16 bytes); the wrapper copies the others.  No launch."""
    b, h, s, hd = 2, 4, 8, 128
    t = {
        "contiguous": lambda: _bf16((b, h, s, hd)),
        "transposed (B, S, H, hd)": lambda: _bf16((b, s, h, hd)
                                                  ).transpose(1, 2),
        "one KV head of a packed qkv": lambda: _bf16((b, s, 3 * h, hd))[
            :, :, h:2 * h].transpose(1, 2),
        "base off by one element": lambda: _bf16((b, h, s, hd), offset=1),
        "row stride of 132 elements": lambda: _bf16((b, h, s, hd + 4))[
            ..., :hd],
        "expanded heads": lambda: _bf16((b, 1, s, hd)).expand(b, h, s, hd),
        "odd stride on an extent-1 dim": lambda: torch.as_strided(
            _bf16((1, h, s, hd)), (1, h, s, hd), (7, s * hd, hd, 1)),
    }[view]()
    assert kernel.tma_addressable(t) is addressable
    assert kernel.LIBRARY.launches == 0
