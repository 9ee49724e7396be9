"""Shared helpers for the port's parity tests (JAX reference vs PyTorch port).

Inputs are made with numpy from a seed and handed to both packages.
Diagrams compare bitwise (their fields are integers or gathered pixel
values); distance tables compare bitwise on the bottleneck bound and at
rtol 1e-5 on the sliced-Wasserstein sum, which reassociates.
"""
import numpy as np
import jax.numpy as jnp
import torch

DTYPES = ("uint8", "int16", "int32", "float32", "bfloat16")


def make_image(dtype: str, kind: str, seed: int, shape=(12, 11)) -> np.ndarray:
    """Seeded test image as a numpy array whose values are exact in
    ``dtype`` (bfloat16 images come back as bf16-exact float32)."""
    rng = np.random.default_rng(seed)
    if kind == "ties":                 # tiny value range => massive ties
        img = rng.integers(0, 3, size=shape).astype(np.float64)
    elif kind == "negative":
        img = -np.abs(rng.normal(size=shape) * 50)
    else:
        img = rng.normal(size=shape) * 50
    if dtype == "uint8":
        return np.clip(np.abs(img), 0, 255).astype(np.uint8)
    if dtype in ("int16", "int32"):
        return img.astype(dtype)
    img = img.astype(np.float32)
    if dtype == "bfloat16":
        return np.asarray(jnp.asarray(img, jnp.bfloat16).astype(jnp.float32))
    return img


def to_jax(img: np.ndarray, dtype: str):
    x = jnp.asarray(img)
    return x.astype(jnp.bfloat16) if dtype == "bfloat16" else x


def to_torch(img: np.ndarray, dtype: str) -> torch.Tensor:
    t = torch.from_numpy(np.array(img))          # a writable copy
    return t.to(torch.bfloat16) if dtype == "bfloat16" else t


def host(x) -> np.ndarray:
    """Either package's array as numpy (bfloat16 widened to float32)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.to(torch.float32)
        return x.numpy()
    x = jnp.asarray(x)
    if x.dtype == jnp.bfloat16:
        x = x.astype(jnp.float32)
    return np.asarray(x)


def assert_same(want, got, what: str = "") -> None:
    """Bitwise equality of two arrays from either package (values,
    shape; dtype compared by name with bfloat16 widened)."""
    a, b = host(want), host(got)
    assert a.shape == b.shape, f"{what}: shape {a.shape} != {b.shape}"
    assert a.dtype == b.dtype, f"{what}: dtype {a.dtype} != {b.dtype}"
    np.testing.assert_array_equal(a, b, err_msg=what)


def assert_same_diagram(want, got, what: str = "") -> None:
    """Field-by-field bitwise equality of two Diagrams (either package)."""
    for name, a, b in zip(got._fields, want, got):
        assert_same(a, b, f"{what} field {name}")


def assert_same_distances(want, got, what: str = "") -> None:
    """``(sw, bn)`` distance tables from either package: ``bn`` bitwise,
    ``sw`` at rtol 1e-5 (the reference's tolerance where a sum
    reassociates)."""
    sw_w, bn_w = (host(a) for a in want)
    sw_g, bn_g = (host(a) for a in got)
    assert sw_w.shape == sw_g.shape and bn_w.shape == bn_g.shape, what
    np.testing.assert_array_equal(bn_w, bn_g, err_msg=f"{what} bn")
    np.testing.assert_allclose(sw_g, sw_w, rtol=1e-5, err_msg=f"{what} sw")
