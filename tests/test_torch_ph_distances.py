"""Port parity: the ``ph_distances`` CLI (``repro_torch.launch.ph_distances``).

The port's CLI on the host (``--device cpu``) against the reference's
``repro.launch.ph_distances`` on the same frames: the report's ``images``,
``n_dirs``, config and bottleneck statistics equal, the ``--out``
bottleneck matrix bitwise, the sliced-Wasserstein matrix and statistics
at rtol 1e-5 (the sum reassociates).  Then ``--npy`` stacks, the error on
a 2-D array, and the sublevel filtration on negated frames giving the
superlevel matrices.
"""
import contextlib
import io
import json
import re
import sys

import numpy as np
import pytest

from repro.launch import ph_distances as jcli
from repro_torch.launch import ph_distances as tcli

ARGS = ["--images", "4", "--size", "64"]


def _report(text: str) -> dict:
    return json.loads(text[re.search(r"^\{", text, re.M).start():])


def _reference(argv, monkeypatch) -> dict:
    monkeypatch.setattr(sys, "argv", ["ph_distances", *argv])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jcli.main()
    return _report(buf.getvalue())


def _port(argv) -> dict:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tcli.main(["--device", "cpu", *argv])
    return _report(buf.getvalue())


def _matrices(path):
    with np.load(path) as z:
        return z["sw"], z["bottleneck"]


def _same_report(got, want):
    for key in ("config", "images", "n_dirs", "bottleneck"):
        assert got[key] == want[key], key
    for stat in ("mean", "max"):
        np.testing.assert_allclose(got["sw"][stat], want["sw"][stat],
                                   rtol=1e-5, atol=0)


def _same_matrices(got_path, want_path):
    sw_g, bn_g = _matrices(got_path)
    sw_w, bn_w = _matrices(want_path)
    np.testing.assert_array_equal(bn_g, bn_w)
    np.testing.assert_allclose(sw_g, sw_w, rtol=1e-5, atol=0)


def test_cli_matches_the_reference(tmp_path, monkeypatch):
    want = _reference([*ARGS, "--out", str(tmp_path / "j.npz")],
                      monkeypatch)
    got = _port([*ARGS, "--out", str(tmp_path / "t.npz")])
    assert set(got) == set(want)
    assert got["images"] == 4 and got["n_dirs"] == 16
    assert got["out"] == str(tmp_path / "t.npz")
    _same_report(got, want)
    _same_matrices(tmp_path / "t.npz", tmp_path / "j.npz")
    assert got["plan_cache"]["regrows"] == want["plan_cache"]["regrows"]
    sw, bn = _matrices(tmp_path / "t.npz")
    assert sw.shape == bn.shape == (4, 4)
    assert not sw.diagonal().any() and np.array_equal(bn, bn.T)


def test_cli_reads_an_npy_stack(tmp_path, monkeypatch):
    rng = np.random.default_rng(11)
    stack = (rng.standard_normal((3, 24, 20)) * 40).astype(np.float32)
    np.save(tmp_path / "stack.npy", stack)
    args = ["--npy", str(tmp_path / "stack.npy"), "--n-dirs", "8"]
    want = _reference([*args, "--out", str(tmp_path / "j.npz")],
                      monkeypatch)
    got = _port([*args, "--out", str(tmp_path / "t.npz")])
    assert got["images"] == 3 and got["n_dirs"] == 8
    _same_report(got, want)
    _same_matrices(tmp_path / "t.npz", tmp_path / "j.npz")
    # --merge-impl (the port's addition) changes the merge, not the result.
    boruvka = _port([*args, "--merge-impl", "boruvka", "--out",
                     str(tmp_path / "b.npz")])
    assert boruvka["config"]["merge_impl"] == "boruvka"
    _same_matrices(tmp_path / "b.npz", tmp_path / "j.npz")


def test_cli_rejects_a_2d_array(tmp_path):
    np.save(tmp_path / "flat.npy", np.zeros((16, 16), np.float32))
    with pytest.raises(SystemExit, match=r"\(B, H, W\) stack"):
        tcli.main(["--device", "cpu", "--npy", str(tmp_path / "flat.npy")])


def test_sublevel_on_negated_frames_gives_the_superlevel_matrices(tmp_path):
    from repro_torch.data.astro import generate_image
    frames = np.stack([generate_image(i, 48) for i in range(3)])
    np.save(tmp_path / "neg.npy", -frames)
    np.save(tmp_path / "pos.npy", frames)
    _port(["--npy", str(tmp_path / "pos.npy"), "--out",
           str(tmp_path / "sup.npz")])
    _port(["--npy", str(tmp_path / "neg.npy"), "--filtration", "sublevel",
           "--out", str(tmp_path / "sub.npz")])
    for a, b in zip(_matrices(tmp_path / "sup.npz"),
                    _matrices(tmp_path / "sub.npz")):
        np.testing.assert_array_equal(a, b)
