"""Port parity: the recurrences of the RWKV-6 and RG-LRU blocks
(``repro_torch.models.rwkv6``, ``.rglru``) vs the JAX package.

The same numpy-seeded float32 inputs, a nonzero initial state among them,
go through both packages' layer functions on the CPU, held at 1e-5
(absolute and relative): the WKV recurrence in its scan and chunk-parallel
forms (chunk lengths that divide the sequence, leave a tail, or exceed
it), the per-head group norm and the token shift; the RG-LRU's
log-depth scan against the reference's ``jax.lax.associative_scan``, its
decode step and the causal conv with its carried inputs.

A WKV output is a sum of up to C·K + K products (C the chunk) of terms
as large as the output itself, and the chunk-parallel form orders that
sum otherwise than XLA's einsums and than the token loop: the
reference's own two forms differ by 1.1e-5 to 1.7e-5 at outputs of
magnitude 8 to 12 here.  So WKV outputs are held at 1e-5 relative to
their largest element (``_close_scaled``); the states at 1e-5 as they
are.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.models import rglru as jrg
from repro.models import rwkv6 as jrw
from repro_torch.models import rglru, rwkv6

TOL = 1e-5
B, H, K = 2, 3, rwkv6.HEAD_K


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _wkv_inputs(t: int, seed: int):
    """r, k, v ~ N(0, 0.5²), decays w = exp(-exp(N(0, 0.5²))) in (0, 1),
    bonus u and a nonzero state."""
    rng = np.random.default_rng(seed)
    r, k, v = (0.5 * rng.normal(size=(B, t, H, K)) for _ in range(3))
    w = np.exp(-np.exp(0.5 * rng.normal(size=(B, t, H, K))))
    u = 0.3 * rng.normal(size=(H, K))
    state = 0.2 * rng.normal(size=(B, H, K, K))
    return [a.astype(np.float32) for a in (r, k, v, w, u, state)]


def _close_scaled(got, want, tol=TOL):
    """``_close`` of both divided by max(1, max |want|)."""
    scale = max(1.0, float(np.abs(np.asarray(want, np.float32)).max()))
    _close(np.asarray(got, np.float32) / scale,
           np.asarray(want, np.float32) / scale, tol)


def _both(fn_j, fn_t, arrays, **kw):
    want = fn_j(*map(jnp.asarray, arrays), **kw)
    got = fn_t(*map(torch.from_numpy, arrays), **kw)
    return got, want


@pytest.mark.parametrize("t", [1, 31, 32, 45, 70])
def test_wkv_forms_match_reference(t):
    arrays = _wkv_inputs(t, seed=t)
    (out, state), (jout, jstate) = _both(jrw.wkv_scan, rwkv6.wkv_scan,
                                         arrays)
    _close_scaled(out, jout)
    _close(state, jstate)
    (cout, cstate), (jcout, jcstate) = _both(
        jrw.wkv_chunked, rwkv6.wkv_chunked, arrays)
    assert cout.shape == (B, t, H, K) and cstate.dtype == torch.float32
    _close_scaled(cout, jcout)
    _close(cstate, jcstate)
    # The port's two forms are one function.
    _close_scaled(cout, out)
    _close(cstate, state)


@pytest.mark.parametrize("chunk", [4, 16, 64])
def test_wkv_chunked_at_other_chunk_lengths(chunk):
    arrays = _wkv_inputs(45, seed=chunk)
    (out, state), (jout, jstate) = _both(jrw.wkv_chunked, rwkv6.wkv_chunked,
                                         arrays, chunk=chunk)
    _close_scaled(out, jout)
    _close(state, jstate)


def test_wkv_chunked_keeps_bfloat16_inputs_rounding():
    """bfloat16 r/k/v/w widen to float32 inside; the output takes r's
    dtype, the state stays float32."""
    arrays = _wkv_inputs(40, seed=5)
    bf = [torch.from_numpy(a).to(torch.bfloat16) for a in arrays[:5]]
    state = torch.from_numpy(arrays[5])
    out, new = rwkv6.wkv_chunked(*bf, state)
    want, want_state = rwkv6.wkv_scan(*(a.float() for a in bf), state)
    assert out.dtype == torch.bfloat16 and new.dtype == torch.float32
    _close(out.float(), want.to(torch.bfloat16).float(), 2e-2)
    _close(new, want_state)


def test_group_norm_uses_population_variance():
    rng = np.random.default_rng(0)
    d = 2 * K
    x = (3.0 * rng.normal(size=(B, 7, d)) + 1.0).astype(np.float32)
    p = {"scale": rng.normal(size=d).astype(np.float32),
         "bias": rng.normal(size=d).astype(np.float32)}
    want = jrw._group_norm({k: jnp.asarray(v) for k, v in p.items()},
                           jnp.asarray(x), 2)
    got = rwkv6._group_norm({k: torch.from_numpy(v) for k, v in p.items()},
                            torch.from_numpy(x), 2)
    _close(got, want)
    xs = x.reshape(B, 7, 2, K)
    manual = (xs - xs.mean(-1, keepdims=True)) / np.sqrt(
        xs.var(-1, keepdims=True) + 1e-5)          # numpy: ddof 0
    _close(got, manual.reshape(B, 7, d) * (1 + p["scale"]) + p["bias"], 1e-4)


def test_token_shift_takes_previous_token():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(B, 5, 8)).astype(np.float32)
    prev = rng.normal(size=(B, 8)).astype(np.float32)
    got = rwkv6._token_shift(torch.from_numpy(x), torch.from_numpy(prev))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jrw._token_shift(jnp.asarray(x),
                                                 jnp.asarray(prev))))
    assert np.array_equal(got[:, 0].numpy(), prev)
    assert np.array_equal(got[:, 1:].numpy(), x[:, :-1])


def _rglru_params(r: int, seed: int):
    """The reference's parameters of one recurrent block, widths r."""
    rng = np.random.default_rng(seed)
    p = {"wa": rng.normal(size=(r, r)) / np.sqrt(r),
         "ba": 0.1 * rng.normal(size=r),
         "wx": rng.normal(size=(r, r)) / np.sqrt(r),
         "bx": 0.1 * rng.normal(size=r),
         # lam over the range the reference's init gives and below it,
         # where a is not ~0 and the scan carries h far.
         "lam": rng.uniform(-6.0, 9.0, size=r),
         "conv_w": rng.normal(size=(4, r)) / 2.0,
         "conv_b": 0.1 * rng.normal(size=r)}
    return {k: np.asarray(v, np.float32) for k, v in p.items()}


@pytest.mark.parametrize("t", [1, 2, 37, 64])
def test_rglru_scan_matches_associative_scan(t):
    r = 24
    p = _rglru_params(r, seed=t)
    rng = np.random.default_rng(100 + t)
    x = rng.normal(size=(B, t, r)).astype(np.float32)
    h0 = rng.normal(size=(B, r)).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jh, jlast = jrg.rglru(jp, jnp.asarray(x), jnp.asarray(h0))
    h, last = rglru.rglru(tp, torch.from_numpy(x), torch.from_numpy(h0))
    _close(h, jh)
    _close(last, jlast)
    assert last.dtype == torch.float32
    # The decode step, token by token, is the same recurrence.
    state = torch.from_numpy(h0)
    for i in range(t):
        jy, _ = jrg.rglru_step(jp, jnp.asarray(x[:, i:i + 1]),
                               jnp.asarray(state.numpy()))
        y, state = rglru.rglru_step(tp, torch.from_numpy(x[:, i:i + 1]),
                                    state)
        _close(y[:, 0], h[:, i])
        _close(y, jy)
    _close(state, last)


def test_linear_scan_is_the_sequential_recurrence():
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.uniform(0.0, 1.0, size=(2, 100, 5)))
    b = torch.from_numpy(rng.normal(size=(2, 100, 5)))
    h, want = torch.zeros(2, 5, dtype=torch.float64), []
    for i in range(100):
        h = a[:, i] * h + b[:, i]
        want.append(h)
    torch.testing.assert_close(rglru.linear_scan(a, b),
                               torch.stack(want, 1), rtol=1e-12, atol=1e-12)


def test_causal_conv_with_state_matches_reference():
    r = 16
    p = _rglru_params(r, seed=9)
    conv = {k: p[k] for k in ("conv_w", "conv_b")}
    rng = np.random.default_rng(9)
    x = rng.normal(size=(B, 11, r)).astype(np.float32)
    state = rng.normal(size=(B, 3, r)).astype(np.float32)
    jy, jstate = jrg._causal_conv1d({k: jnp.asarray(v) for k, v in
                                     conv.items()}, jnp.asarray(x),
                                    jnp.asarray(state))
    tconv = {k: torch.from_numpy(v) for k, v in conv.items()}
    y, new = rglru._causal_conv1d(tconv, torch.from_numpy(x),
                                  torch.from_numpy(state))
    _close(y, jy)
    np.testing.assert_array_equal(new.numpy(), np.asarray(jstate))
    # Two halves with the carried inputs give the whole.
    y1, s1 = rglru._causal_conv1d(tconv, torch.from_numpy(x[:, :5]),
                                  torch.from_numpy(state))
    y2, s2 = rglru._causal_conv1d(tconv, torch.from_numpy(x[:, 5:]), s1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y, rtol=0, atol=0)
    assert torch.equal(s2, new)


def test_recurrent_block_decode_continues_the_sequence():
    """Prefill then one-token steps through ``recurrent_block_apply``
    equal the whole sequence at once (conv inputs and h carried)."""
    r, d = 16, 12
    p = _rglru_params(r, seed=4)
    rng = np.random.default_rng(4)
    p.update({"w_in": rng.normal(size=(d, r)) / np.sqrt(d),
              "w_gate": rng.normal(size=(d, r)) / np.sqrt(d),
              "w_out": rng.normal(size=(r, d)) / np.sqrt(r)})
    tp = {k: torch.from_numpy(np.asarray(v, np.float32))
          for k, v in p.items()}
    x = torch.from_numpy(rng.normal(size=(B, 9, d)).astype(np.float32))
    zero = rglru.init_recurrent_state(B, r, 4, dtype=torch.float32,
                                      device="cpu")
    whole, _ = rglru.recurrent_block_apply(tp, x, zero)
    out, state = rglru.recurrent_block_apply(tp, x[:, :5], zero)
    steps = [out]
    for i in range(5, 9):
        y, state = rglru.recurrent_block_apply(tp, x[:, i:i + 1], state,
                                               decode=True)
        steps.append(y)
    _close(torch.cat(steps, 1), whole)
    jw, _ = jrg.recurrent_block_apply(
        {k: jnp.asarray(np.asarray(v)) for k, v in tp.items()},
        jnp.asarray(x.numpy()),
        {"conv": jnp.zeros((B, 3, r)), "h": jnp.zeros((B, r))})
    _close(whole, jw)
