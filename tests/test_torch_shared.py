"""The port's own copies of the JAX package's numpy-only modules (config,
io.sequence, dlo_init, the float64 oracle, io.raw_sequence, utils.viz,
evaluation.occlusion, evaluation.scenarios, io.camera_preset,
io.pseudo_depth, and the tools mask_preview, color_picker,
simulate_occlusion and render_results) and of the native library's C++
source against the originals, and an import scan: no file of the port, and not chip_smoke.py, imports jax or
anything of trackdlo_tpu; nor does tests/torch_shard_workers.py, which the
point-sharded tests' spawned ranks import."""

import ast
import dataclasses
import os
from pathlib import Path

import numpy as np
import pytest

import trackdlo_tpu.config as jcfg
import trackdlo_tpu.dlo_init as jinit
import trackdlo_tpu.io.sequence as jseq
import trackdlo_tpu.oracle.pipeline as jpipe
import trackdlo_tpu_torch.config as tcfg
import trackdlo_tpu_torch.dlo_init as tinit
import trackdlo_tpu_torch.io.sequence as tseq
import trackdlo_tpu_torch.oracle.pipeline as tpipe

REPO = Path(__file__).resolve().parents[1]
SMALL = dict(fx=120.0, fy=120.0, cx=80.0, cy=60.0, width=160, height=120)


@pytest.mark.parametrize("make", ["live_params", "eval_params"])
def test_params_equal_field_by_field(make):
    a, b = getattr(jcfg, make)(), getattr(tcfg, make)()
    fa = {f.name: getattr(a, f.name) for f in dataclasses.fields(a)}
    fb = {f.name: getattr(b, f.name) for f in dataclasses.fields(b)}
    assert fa == fb
    assert a.candidate_cap() == b.candidate_cap()
    ia, ib = jcfg.CameraIntrinsics(), tcfg.CameraIntrinsics()
    assert dataclasses.asdict(ia) == dataclasses.asdict(ib)
    assert np.array_equal(np.asarray(ia.proj_matrix()), np.asarray(ib.proj_matrix()))


@pytest.mark.parametrize("t", [0.0, 0.37])
def test_render_frame_bit_equal(t):
    kw = dict(rope_pixel_radius=3, depth_noise_mm=1.0, markers=4)
    ra, da = jseq.render_frame(jseq.SyntheticRope(), t, jcfg.CameraIntrinsics(**SMALL), **kw)
    rb, db = tseq.render_frame(tseq.SyntheticRope(), t, tcfg.CameraIntrinsics(**SMALL), **kw)
    assert np.array_equal(ra, rb) and np.array_equal(da, db)
    assert np.array_equal(jseq.SyntheticRope().nodes(t, 45), tseq.SyntheticRope().nodes(t, 45))


def _quarter(cfg):
    live = cfg.CameraIntrinsics()
    return cfg.CameraIntrinsics(fx=live.fx / 4, fy=live.fy / 4, cx=live.cx / 4, cy=live.cy / 4,
                                width=live.width // 4, height=live.height // 4)


def test_oracle_step_frame_bit_equal():
    """Three frames of the float64 oracle, the middle one occluded."""
    runs = []
    for cfg, seq, pipe in ((jcfg, jseq, jpipe), (tcfg, tseq, tpipe)):
        params, intr, rope = cfg.live_params(max_points=512, dlo_pixel_width=10), _quarter(cfg), seq.SyntheticRope()
        state = pipe.init_state(rope.nodes(0.0, params.M), params)
        ys = []
        for i in range(1, 4):
            rgb, depth = seq.render_frame(rope, i / 15.0, intr, rope_pixel_radius=3)
            occ = None
            if i == 2:
                occ = np.ones((intr.height, intr.width), np.uint8)
                occ[:, 125:200] = 0
            state, res, _ = pipe.step_frame(state, rgb, depth, params, intr, occ)
            ys.append((state.y.copy(), state.sigma2, res.guide_nodes.copy()))
        runs.append(ys)
    for (ya, sa, ga), (yb, sb, gb) in zip(*runs):
        assert np.array_equal(ya, yb) and sa == sb and np.array_equal(ga, gb)


def test_initialize_nodes_equal():
    out = []
    for cfg, seq, init in ((jcfg, jseq, jinit), (tcfg, tseq, tinit)):
        params, intr = cfg.live_params(), _quarter(cfg)
        rgb, depth = seq.render_frame(seq.SyntheticRope(), 0.0, intr, rope_pixel_radius=3)
        out.append(init.initialize_nodes(rgb, depth, params, intr))
    assert out[0].shape == (45, 3)
    assert np.array_equal(out[0], out[1])


# Copies whose text is the original's but for the package name in imports.
COPIES = ["io/raw_sequence.py", "utils/viz.py", "evaluation/occlusion.py",
          "evaluation/scenarios.py", "io/camera_preset.py", "io/pseudo_depth.py",
          "tools/mask_preview.py", "tools/color_picker.py", "tools/simulate_occlusion.py",
          "tools/render_results.py"]


@pytest.mark.parametrize("rel", COPIES)
def test_copied_module_is_the_original_but_for_imports(rel):
    original = (REPO / "trackdlo_tpu" / rel).read_text()
    copy = (REPO / "trackdlo_tpu_torch" / rel).read_text()
    assert copy == original.replace("trackdlo_tpu.", "trackdlo_tpu_torch.")


def test_native_source_is_the_original_byte_for_byte():
    rel = "native/preprocess.cpp"
    assert (REPO / "trackdlo_tpu_torch" / rel).read_bytes() == (REPO / "trackdlo_tpu" / rel).read_bytes()


def test_raw_sequences_cross_between_the_packages(tmp_path):
    import trackdlo_tpu.io.raw_sequence as jraw
    import trackdlo_tpu_torch.io.raw_sequence as traw

    intr = jcfg.CameraIntrinsics(**SMALL)
    frames = [jseq.render_frame(jseq.SyntheticRope(), t, intr) for t in (0.0, 0.2)]
    for write, read in ((jraw, traw), (traw, jraw)):
        path = write.write_raw_sequence(str(tmp_path / f"{write.__name__}.tdlo"), frames)
        back = read.read_raw_sequence(path)
        assert len(back) == 2
        for (r0, d0), (r1, d1) in zip(frames, back):
            assert np.array_equal(r0, r1) and np.array_equal(d0, d1)


def test_viz_occlusion_and_scenarios_bit_equal():
    import trackdlo_tpu.evaluation.occlusion as jocc
    import trackdlo_tpu.evaluation.scenarios as jsc
    import trackdlo_tpu.utils.viz as jviz
    import trackdlo_tpu_torch.evaluation.occlusion as tocc
    import trackdlo_tpu_torch.evaluation.scenarios as tsc
    import trackdlo_tpu_torch.utils.viz as tviz

    intr = jcfg.CameraIntrinsics(**SMALL)
    proj = np.asarray(intr.proj_matrix())
    rgb, _ = jseq.render_frame(jseq.SyntheticRope(), 0.1, intr)
    y = jseq.SyntheticRope().nodes(0.1, 45)
    vis = np.arange(45) % 3 > 0
    occ = tocc.rect_mask(120, 160, (40, 30, 90, 80))
    assert np.array_equal(occ, jocc.rect_mask(120, 160, (40, 30, 90, 80)))
    assert np.array_equal(tviz.draw_tracking_overlay(rgb, y, proj, vis, occ),
                          jviz.draw_tracking_overlay(rgb, y, proj, vis, occ))
    assert tviz.geometry_markers(y) == jviz.geometry_markers(y)
    assert tocc.gt_bbox_rect(y, 50, proj, 120, 160) == jocc.gt_bbox_rect(y, 50, proj, 120, 160)
    for name in ("stationary", "self_occlusion"):
        a = tsc.generate(tsc.make_scenario(name), 2, tcfg.CameraIntrinsics(**SMALL), 45)
        b = jsc.generate(jsc.make_scenario(name), 2, intr, 45)
        assert a[2] == b[2] and np.array_equal(a[1], b[1])
        for (ra, da), (rb, db) in zip(a[0], b[0]):
            assert np.array_equal(ra, rb) and np.array_equal(da, db)


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "trackdlo_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "tests" / "torch_shard_workers.py"]
    assert len(files) > 20
    scanned = {os.path.relpath(p, REPO / "trackdlo_tpu_torch") for p in files}
    for rel in ("native/__init__.py", "utils/profiling.py", "io/ros_adapter.py",
                "tools/live_view.py", "tools/record.py", "ops/graph_loop.py", *COPIES):
        assert rel in scanned, rel
    bad = []
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "trackdlo_tpu"):
                bad.append(f"{os.path.relpath(path, REPO)}: {name}")
    assert not bad, bad
