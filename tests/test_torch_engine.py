"""Port parity: the PHEngine facade (repro_torch.ph) vs repro.ph.

Configs cross between the packages through JSON; ``run`` and uniform
``run_batch`` give bitwise-equal diagrams and the same regrow capacities;
the port never imports JAX or the reference package; and the engine runs
on the CUDA device unless told otherwise.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from _torch_parity import assert_same_diagram
from repro.data import astro as jastro
from repro.ph import PHConfig as JConfig
from repro.ph import PHEngine as JEngine
from repro.ph import DeltaSpec, OverlapSpec, ServeSpec, TileSpec
from repro_torch.core import persistence_oracle
from repro_torch.data import astro as tastro
from repro_torch.ph import FilterLevel, PHConfig, PHEngine

ROOT = Path(__file__).resolve().parents[1]


def _bumpy(seed=0, shape=(8, 8)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _engine(**kw):
    return PHEngine(PHConfig(**kw), device="cpu")


# ---------------------------------------------------------------------------
# Configuration crosses between the packages
# ---------------------------------------------------------------------------

JSON_CASES = [
    dict(),
    dict(max_features=128, max_candidates=512, merge_impl="boruvka",
         phase_c_impl="xla", filter_level="filter_std", strip_rows=4,
         use_pallas=False, dtype="bfloat16", filtration="sublevel",
         tournament_width=3, regrow_features_ceiling=1024),
    dict(tile=dict(grid=(2, 4)), serve=dict(buckets=(64, (32, 48))),
         delta=dict(cache_entries=2), overlap=dict(staging_depth=3),
         merge_keys="rank", auto_regrow=False),
]


@pytest.mark.parametrize("fields", JSON_CASES)
def test_config_json_round_trip_across_packages(fields):
    spec = dict(fields)
    jspec = dict(spec)
    for name, cls in (("tile", TileSpec), ("serve", ServeSpec),
                      ("delta", DeltaSpec), ("overlap", OverlapSpec)):
        if name in jspec:
            jspec[name] = cls(**jspec[name])
    jcfg = JConfig(**jspec)
    tcfg = PHConfig.from_json(jcfg.to_json())
    assert tcfg.to_json() == jcfg.to_json()
    assert tcfg.stage_signature() == jcfg.stage_signature()
    assert tcfg.plan_key() == jcfg.plan_key()
    back = JConfig.from_json(PHConfig(**spec).to_json())
    assert back == jcfg
    assert back.stage_signature() == PHConfig(**spec).stage_signature()


def test_config_validation_matches_reference():
    for bad in (dict(max_features=0), dict(merge_impl="bogus"),
                dict(strip_rows=0), dict(filtration="sideways"),
                dict(max_features=100, regrow_features_ceiling=10),
                dict(tournament_width=1)):
        with pytest.raises(ValueError):
            JConfig(**bad)
        with pytest.raises(ValueError):
            PHConfig(**bad)
    assert PHConfig(filter_level="filter_std").filter_level is FilterLevel.STD


# ---------------------------------------------------------------------------
# run / run_batch against the reference engine
# ---------------------------------------------------------------------------

def test_astro_frames_are_bitwise_equal():
    for image_id, size in ((0, 64), (3, 33)):
        np.testing.assert_array_equal(jastro.generate_image(image_id, size),
                                      tastro.generate_image(image_id, size))
    img = tastro.generate_image(1, 64)
    for level in ("filter_light", "filter_std", "filter_heavy", "vanilla"):
        assert tastro.filter_threshold(img, level) == \
            jastro.filter_threshold(img, level)


def _bf16(img):
    return np.asarray(jnp.asarray(img, jnp.bfloat16))     # numpy bfloat16


@pytest.mark.parametrize("filtration,want", [("superlevel", 110.3782),
                                             ("sublevel", -110.3782 + 200)])
def test_bfloat16_auto_threshold_matches_reference(filtration, want):
    """The reference takes the median of a bfloat16 frame in bfloat16
    arithmetic (100.0, where float32 gives 100.25) and the MAD in float32;
    the port does the same with torch on the host."""
    img = _bf16(tastro.generate_window(0, 0, 0, 32, 32, size=32))
    cfg = dict(filter_level="filter_std", filtration=filtration)
    got = _engine(**cfg).auto_threshold(img)
    assert got == JEngine(JConfig(**cfg)).auto_threshold(img)
    assert got == pytest.approx(want, abs=1e-9)


@pytest.mark.parametrize("shape", [(1, 1), (1, 2), (7, 9), (8, 8), (31, 31),
                                   (33, 32)])
@pytest.mark.parametrize("filtration", ["superlevel", "sublevel"])
def test_bfloat16_auto_threshold_sweep_matches_reference(shape, filtration):
    """Even and odd pixel counts, gaussian and tied values, every filter
    level: the port's bfloat16 statistic equals the reference's exactly."""
    rng = np.random.default_rng(sum(shape))
    images = [rng.normal(loc=100.0, scale=7.0, size=shape),
              rng.integers(0, 4, size=shape) * 1.5 + 0.25]
    for img in map(_bf16, images):
        for level in ("filter_light", "filter_std", "filter_heavy"):
            cfg = dict(filter_level=level, filtration=filtration)
            assert _engine(**cfg).auto_threshold(img) == \
                JEngine(JConfig(**cfg)).auto_threshold(img), (level, img)
    batch = _bf16(np.stack(images[:1] * 2 + [rng.normal(size=shape)]))
    cfg = dict(max_features=64, max_candidates=64, filter_level="filter_std",
               filtration=filtration)
    np.testing.assert_array_equal(
        np.asarray(_engine(**cfg).run_batch(batch).threshold, np.float64),
        np.asarray(JEngine(JConfig(**cfg)).run_batch(batch).threshold,
                   np.float64))


@pytest.mark.parametrize("merge_impl", ["boruvka", "scan"])
def test_run_and_run_batch_filter_std_match_reference(merge_impl):
    cfg = dict(max_features=512, max_candidates=1024, merge_impl=merge_impl,
               filter_level="filter_std")
    frame = tastro.generate_image(0, 64)
    jres = JEngine(JConfig(**cfg)).run(frame)
    tres = _engine(**cfg).run(frame)
    assert tres.threshold == pytest.approx(jres.threshold, abs=0.0)
    assert_same_diagram(jres.diagram, tres.diagram, "run filter_std")
    assert vars(tres.regrow) == vars(jres.regrow)

    frames = np.stack([tastro.generate_image(i, 32) for i in range(3)])
    jb = JEngine(JConfig(**cfg)).run_batch(frames)
    tb = _engine(**cfg).run_batch(frames)
    np.testing.assert_array_equal(np.asarray(jb.threshold),
                                  np.asarray(tb.threshold))
    assert_same_diagram(jb.diagram, tb.diagram, "run_batch filter_std")
    tb_list = _engine(**cfg).run_batch([frames[i] for i in range(3)])
    for a, b in zip(tb.diagram, tb_list.diagram):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape,mf,mc", [((8, 8), 2, 2), ((6, 6), 1, 1)])
def test_regrow_reaches_reference_capacities(shape, mf, mc):
    img = _bumpy(2, shape)
    jeng = JEngine(JConfig(max_features=mf, max_candidates=mc))
    teng = _engine(max_features=mf, max_candidates=mc)
    jres, tres = jeng.run(img), teng.run(img)
    assert vars(tres.regrow) == vars(jres.regrow)
    assert tres.regrow.attempts >= 1 and not tres.regrow.overflow
    assert tres.config.max_features == jres.config.max_features
    assert_same_diagram(jres.diagram, tres.diagram, "regrown run")
    np.testing.assert_array_equal(tres.to_array(), persistence_oracle(img))
    assert teng.plan_stats()["regrows"] == jeng.plan_stats()["regrows"]
    # Sticky: the second call starts at the remembered capacities.
    again = teng.run(img)
    assert again.regrow.attempts == 0
    assert again.config.max_features == tres.config.max_features


def test_run_batch_regrows_like_reference():
    imgs = np.stack([_bumpy(s) for s in range(3)])
    jres = JEngine(JConfig(max_features=2, max_candidates=4)).run_batch(imgs)
    tres = _engine(max_features=2, max_candidates=4).run_batch(imgs)
    assert vars(tres.regrow) == vars(jres.regrow)
    assert not bool(tres.diagram.overflow.any())
    assert_same_diagram(jres.diagram, tres.diagram, "regrown batch")


def test_overflow_without_regrow_and_regrow_limits():
    img = _bumpy(1, (16, 16))
    eng = _engine(max_features=256, max_candidates=2, auto_regrow=False)
    assert eng.num_candidates(img) > 2
    res = eng.run(img)
    assert bool(res.diagram.overflow)
    assert res.regrow.attempts == 0 and res.regrow.overflow
    assert eng.plan_stats()["regrows"] == 0

    res = _engine(max_features=2, max_candidates=2, max_regrows=1).run(
        _bumpy(3, (16, 16)))
    assert res.regrow.attempts == 1 and res.config.max_features == 4
    assert res.regrow.overflow
    capped = _engine(max_features=4, max_candidates=4,
                     regrow_features_ceiling=8,
                     regrow_candidates_ceiling=8).run(_bumpy(3, (16, 16)))
    assert capped.config.max_features <= 8
    assert capped.config.max_candidates <= 8


def test_plan_cache_reuse():
    eng = _engine(max_features=64, max_candidates=64)
    for seed in range(5):
        eng.run(_bumpy(seed))
    eng.run_batch(np.stack([_bumpy(s) for s in range(2)]))
    eng.run_batch(np.stack([_bumpy(s) for s in range(2, 4)]))
    stats = eng.plan_stats()
    assert stats["plans"] == 2 and stats["traces"] == 2
    assert stats["calls"] == 7 and stats["hits"] == 5


def test_inputs_dtype_policy_and_errors():
    eng = _engine(max_features=64, max_candidates=64)
    img64 = _bumpy(0).astype(np.float64)
    assert eng.cast_input(img64).dtype == torch.float32
    bf = np.asarray(jnp.asarray(_bumpy(0), jnp.bfloat16))   # numpy bfloat16
    x = eng.cast_input(bf)
    assert x.dtype == torch.bfloat16
    np.testing.assert_array_equal(x.float().numpy(),
                                  bf.astype(np.float32))
    ints = _engine(max_features=64, max_candidates=64, dtype="float32")
    assert ints.run(np.arange(64, dtype=np.int32).reshape(8, 8)) \
        .diagram.birth.dtype == torch.float32
    with pytest.raises(ValueError):
        eng.run(np.zeros((2, 3, 4), np.float32))
    with pytest.raises(ValueError):
        eng.run_batch(np.zeros((3, 4), np.float32))
    with pytest.raises(ValueError, match="non-finite"):
        eng.run(np.array([[1.0, np.inf]], np.float32))
    with pytest.raises(TypeError):
        eng.run(np.zeros((3, 3), np.complex64))
    mixed = [_bumpy(4, (3, 3)), _bumpy(5, (4, 3))]
    res = eng.run_batch(mixed)
    assert res.diagram.birth.shape == (2, 16)
    for i, im in enumerate(mixed):
        one = eng.run(im).diagram
        c = int(one.count)
        for name, a, b in zip(one._fields, res.diagram, one):
            want = b[:c] if b.dim() else b
            got = a[i][:c] if a.dim() > 1 else a[i]
            assert torch.equal(got, want), (i, name)


def test_int_image_fractional_threshold_not_truncated():
    img = np.zeros((5, 5), np.int32)
    img[1, 1] = 12
    img[3, 3] = 20
    eng = _engine(max_features=25, max_candidates=25)
    assert int(eng.run(img, truncate_value=12.5).diagram.count) == 1
    assert int(eng.run(img, truncate_value=11.5).diagram.count) == 2


# ---------------------------------------------------------------------------
# Device policy and import hygiene
# ---------------------------------------------------------------------------

def test_default_device_is_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        assert PHEngine().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            PHEngine()
    assert PHEngine(device="cpu").device.type == "cpu"


def test_port_import_leaves_jax_out():
    code = ("import sys, repro_torch, repro_torch.ph, repro_torch.core, "
            "repro_torch.data.astro, repro_torch.cache, "
            "repro_torch.core.tiling, repro_torch.core.delta; "
            "import repro_torch.kernels.ph_phase_a, "
            "repro_torch.kernels.ph_phase_c, repro_torch.kernels.maxpool, "
            "repro_torch.kernels.ph_distance, "
            "repro_torch.pipeline.padding, repro_torch.pipeline.scheduler, "
            "repro_torch.pipeline.executor, repro_torch.pipeline.driver, "
            "repro_torch.ph.overlap, repro_torch.distributed.context, "
            "repro_torch.launch.ph_run, "
            "repro_torch.kernels.flash_attention, repro_torch.configs.base, "
            "repro_torch.models.model, repro_torch.models.convert, "
            "repro_torch.launch.serve_lm, repro_torch.serving, "
            "repro_torch.serving.server, repro_torch.serving.metrics, "
            "repro_torch.launch.ph_serve, repro_torch.roofline, "
            "repro_torch.roofline.analysis, repro_torch.roofline.autotune, "
            "repro_torch.launch.ph_distances, repro_torch.data.tokens, "
            "repro_torch.optim.adamw, repro_torch.checkpoint.ckpt, "
            "repro_torch.launch.steps, repro_torch.launch.train, "
            "repro_torch.distributed.sharding, "
            "repro_torch.distributed.parallel, repro_torch.launch.mesh, "
            "repro_torch.launch.dryrun; "
            "bad = sorted(m for m in sys.modules "
            "if m in ('jax', 'repro', 'ml_dtypes') "
            "or m.startswith(('jax.', 'repro.', 'ml_dtypes.'))); "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_static_scan_port_imports_neither_jax_nor_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "ml_dtypes"), \
                f"{path}: {mod}"
