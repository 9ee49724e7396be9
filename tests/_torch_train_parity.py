"""Shared checks of the port's train step against the reference's.

Adam divides each gradient element by its own root mean square, so an
element whose gradient is within a few orders of ``eps`` (1e-8) moves by
a step that its gradient's last bits decide: a smoke model's gradients
agree with the reference's to ~1e-8 absolute, and a ``w_gate`` element of
gradient 1.4e-9 may then step anywhere between 0 and the learning rate.
Two correct implementations therefore differ there, and the difference
feeds every later step.  So a train step is held in two parts, each well
conditioned: the metrics and the moments ``mu``/``nu`` (linear and
quadratic in the gradients) against the reference's at ``STEP_TOL`` of
each leaf's largest element, and the parameters against the reference's
update rule applied in float64 to the port's own moments, at the same
tolerance.  Before the next step the port takes the reference's
parameters, so each step's gradients are compared at one point.
"""
import numpy as np
import jax
import jax.numpy as jnp
import torch

from repro_torch.models import convert
from repro_torch.optim.adamw import decayed_names

STEP_TOL = 1e-5
METRICS = {"loss", "ce", "aux", "grad_norm", "lr"}


def rel_close(got, want, tol, msg=""):
    """max |got - want| within ``tol`` of want's largest element."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-30)
    err = float(np.abs(got - want).max(initial=0.0)) / scale
    assert err <= tol, f"{msg}: {err:.3g} of the largest element"


def host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().double().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32), np.float64)


def port_state(params) -> dict:
    """The port's parameters as float64 numpy, by name."""
    return {k: host(p) for k, p in params.named_parameters()}


def check_train_step(opt, params, state, metrics, before: dict, jparams,
                     jstate, jmetrics, msg: str) -> None:
    """Hold one port step (``params`` after it, ``before`` them as
    :func:`port_state` gave them) to one reference step, then give the
    port the reference's parameters."""
    cfg = params.cfg
    assert metrics.keys() == set(jmetrics) == METRICS
    for k, v in metrics.items():
        assert v.shape == () and not v.requires_grad, k
        rel_close(host(v), host(jmetrics[k]), STEP_TOL, f"{msg} {k}")
    assert all(p.grad is None for p in params.parameters())
    assert int(state.count) == int(jstate.count)
    conv = lambda tree: convert.params_from_jax(  # noqa: E731
        cfg, jax.tree.map(np.asarray, tree))
    for field in ("mu", "nu"):
        for k, want in conv(getattr(jstate, field)).items():
            got = getattr(state, field)[k]
            assert got.dtype == torch.float32
            rel_close(host(got), host(want), STEP_TOL, f"{msg} {field} {k}")
    n = float(state.count)
    lr = float(metrics["lr"])
    c1, c2 = 1 - opt.b1 ** n, 1 - opt.b2 ** n
    decayed = decayed_names(params)
    for k, p in params.named_parameters():
        m, v = host(state.mu[k]), host(state.nu[k])
        step = lr * (m / c1) / (np.sqrt(v / c2) + opt.eps)
        if k in decayed:
            step = step + lr * opt.weight_decay * before[k]
        rel_close(host(p), before[k] - step, STEP_TOL, f"{msg} param {k}")
    with torch.no_grad():
        for k, want in conv(jparams).items():
            params.get_parameter(k).copy_(want)
