"""The port's operator tools, profiling helpers and sensor-model modules
against the JAX package's on the same seeded inputs:

- tools.record, tools.render_results, tools.mask_preview,
  tools.color_picker, tools.simulate_occlusion and tools.live_view (OpenCV
  only where the JAX tool needs it);
- utils.profiling (the recorder's report, log_step_outputs);
- ops.preprocess.rgb_to_hsv_cv against the JAX package's;
- io.camera_preset and io.pseudo_depth: the port's step on a decimated,
  sensor-quantised frame and on a pseudo-real depth frame, each against the
  JAX package's step from the same state (tests/test_torch_tracker.py's
  per-step bound)."""

import json
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trackdlo_tpu.config import CameraIntrinsics, live_params
from trackdlo_tpu.io.sequence import SyntheticRope, render_frame

SMALL = CameraIntrinsics(fx=120.0, fy=120.0, cx=80.0, cy=60.0, width=160, height=120)
SMALL_PARAMS = live_params(max_points=256, downsample_cell_px=4, dlo_pixel_width=5)
LIVE = CameraIntrinsics()
QUARTER = CameraIntrinsics(fx=LIVE.fx / 4, fy=LIVE.fy / 4, cx=LIVE.cx / 4, cy=LIVE.cy / 4,
                           width=LIVE.width // 4, height=LIVE.height // 4)
QUARTER_PARAMS = live_params(max_points=512, dlo_pixel_width=10)
STEP_TOL_M = 5e-4


@pytest.fixture(scope="module")
def small_step():
    """Two frames through the port's tracker on the CPU: the state and the
    outputs of the second."""
    from trackdlo_tpu_torch.models.trackdlo import Tracker

    rope = SyntheticRope()
    tracker = Tracker(SMALL_PARAMS, SMALL, device="cpu")
    state = tracker.init_from_nodes(rope.nodes(0.0, SMALL_PARAMS.M))
    frames = [render_frame(rope, i / 15.0, SMALL, rope_pixel_radius=3) for i in (1, 2)]
    for rgb, depth in frames:
        state, out = tracker.step(state, rgb, depth)
    return tracker, state, out, frames


def test_record_saves_frames_and_outputs(tmp_path, small_step):
    from trackdlo_tpu.tools.record import SequenceRecorder as JaxRecorder
    from trackdlo_tpu_torch.tools.record import SequenceRecorder

    _, state, out, frames = small_step
    rec, jrec = SequenceRecorder(), JaxRecorder()
    for rgb, depth in frames:
        rec.record(rgb, depth, out)
        jrec.record(rgb, depth, out._replace(**{k: v.numpy() for k, v in out._asdict().items()}))
    assert len(rec) == len(jrec) == 2
    a = np.load(rec.save(str(tmp_path / "port.npz")))
    b = np.load(jrec.save(str(tmp_path / "jax.npz")))
    assert sorted(a.files) == sorted(b.files) == ["depths", "results", "rgbs"]
    for k in a.files:
        assert np.array_equal(a[k], b[k])
    assert a["results"].shape == (2, SMALL_PARAMS.M, 3)
    assert all(np.array_equal(p, q) for p, q in zip(rec.points, jrec.points))


def test_render_results_overlays_equal(small_step):
    from trackdlo_tpu.tools.render_results import render_result_images as jrender
    from trackdlo_tpu_torch.tools.render_results import render_result_images

    _, state, _, frames = small_step
    traj = np.stack([state.y.numpy()] * len(frames))
    proj = np.asarray(SMALL.proj_matrix())
    got = list(render_result_images(frames, traj, proj))
    want = list(jrender(frames, traj, proj))
    assert len(got) == len(want) == 2
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


def test_mask_preview_and_color_picker_equal():
    import trackdlo_tpu.tools.color_picker as jcp
    import trackdlo_tpu.tools.mask_preview as jmp
    import trackdlo_tpu_torch.tools.color_picker as tcp
    import trackdlo_tpu_torch.tools.mask_preview as tmp

    params = live_params()
    rgb, _ = render_frame(SyntheticRope(), 0.2, SMALL, rope_pixel_radius=3)
    assert np.array_equal(tmp.preview_mask(rgb, params), jmp.preview_mask(rgb, params))
    assert tmp.mask_stats(rgb, params) == jmp.mask_stats(rgb, params)
    region = tmp.preview_mask(rgb, params)[..., 0]
    assert region.any()
    bounds = tcp.suggest_hsv_bounds(rgb, region)
    assert bounds == jcp.suggest_hsv_bounds(rgb, region)
    assert tcp.coverage(rgb, *bounds, region) == jcp.coverage(rgb, *bounds, region) > 0.9


def test_simulate_occlusion_masks_equal():
    from trackdlo_tpu.tools.simulate_occlusion import OcclusionSimulator as JaxSim
    from trackdlo_tpu_torch.tools.simulate_occlusion import OcclusionSimulator

    kw = dict(height=120, width=160, rect=(40, 0, 80, 119), velocity=(3.0, 1.0))
    sim, jsim = OcclusionSimulator(**kw), JaxSim(**kw)
    for i in range(4):
        assert np.array_equal(sim.mask_at(i), jsim.mask_at(i))
    assert not sim.mask_at(0).all()


def test_live_view_renders_what_the_jax_view_renders(tmp_path, small_step):
    pytest.importorskip("cv2")
    from trackdlo_tpu.tools.live_view import LiveView as JaxView
    from trackdlo_tpu_torch.tools.live_view import LiveView

    tracker, state, out, frames = small_step
    occ = np.ones((SMALL.height, SMALL.width), bool)
    occ[:, :40] = False
    view = LiveView(tracker, out_path=str(tmp_path / "port.mp4"))
    jview = JaxView(tracker, out_path=str(tmp_path / "jax.mp4"))
    np_out = out._replace(**{k: v.numpy() for k, v in out._asdict().items()})
    for rgb, _ in frames:
        img = view.show(rgb, state, out, occlusion_mask=torch.from_numpy(occ))
        want = jview.show(rgb, state._replace(y=state.y.numpy()), np_out, occlusion_mask=occ)
        assert np.array_equal(img, want)
    view.close()
    jview.close()
    assert view.frames_shown == 2 and (tmp_path / "port.mp4").stat().st_size > 0


def test_phase_timers_and_step_log(caplog, small_step):
    """The recorder's report is the reference's "Avg ..." block (each span's
    mean ms a call, then the calls' total); the per-frame log line."""
    from trackdlo_tpu_torch.utils import profiling
    from trackdlo_tpu_torch.utils.profiling import log_step_outputs

    profiling.enable()
    try:
        for _ in range(3):
            with profiling.span("tracking"):
                with profiling.span("tracking.em"):
                    pass
        drained = profiling.drain()
    finally:
        profiling.disable()
    assert [s.name for s in drained.spans].count("tracking") == 3
    lines = profiling.report(drained.spans).splitlines()
    assert [ln.split(":")[0] for ln in lines] == ["Avg tracking.em", "Avg tracking", "Avg total"]
    with caplog.at_level(logging.INFO, logger="trackdlo_tpu_torch"):
        log_step_outputs(small_step[2], frame_idx=7)
    assert "[frame 7]" in caplog.text and "EM iterations=" in caplog.text


def test_rgb_to_hsv_cv_equals_jax():
    from trackdlo_tpu.ops.preprocess import rgb_to_hsv_cv as jhsv
    from trackdlo_tpu_torch.ops.preprocess import rgb_to_hsv_cv

    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (64, 96, 3), dtype=np.uint8)
    rgb[0, :6] = [[0, 0, 0], [255, 255, 255], [10, 10, 10], [255, 0, 0], [0, 255, 0], [0, 0, 255]]
    got = rgb_to_hsv_cv(torch.from_numpy(rgb)).numpy()
    want = np.asarray(jhsv(jnp.asarray(rgb)))
    assert got.dtype == np.float32 and got.shape == (64, 96, 3)
    assert np.array_equal(got, want)


def _step_pair(params, intr, rgb, depth):
    """One step of the JAX package's Tracker and the port's from the same
    state: the largest node distance."""
    from trackdlo_tpu.models.trackdlo import Tracker as JaxTracker
    from trackdlo_tpu_torch.convert import state_from_numpy
    from trackdlo_tpu_torch.models.trackdlo import Tracker

    rope = SyntheticRope()
    jt, tt = JaxTracker(params, intr), Tracker(params, intr, device="cpu")
    js = jt.init_from_nodes(rope.nodes(0.0, params.M))
    ts = state_from_numpy(np.asarray(js.y), np.asarray(js.sigma2), np.asarray(js.geodesic_coord),
                          device="cpu")
    js, jo = jt.step(js, rgb, depth)
    ts, to = tt.step(ts, rgb, depth)
    assert int(to.n_points) == int(jo.n_points) > 0
    return float(np.abs(ts.y.numpy() - np.asarray(js.y)).max())


def test_camera_preset_copy_and_the_d435_regime_step(tmp_path):
    """The shipped preset's regime (100 µm depth units, decimation 4): a
    720p frame quantised and decimated to 320x180 by the port's copy (equal
    to the JAX package's), stepped by both trackers."""
    import trackdlo_tpu.io.camera_preset as jcp
    import trackdlo_tpu_torch.config as tcfg
    import trackdlo_tpu_torch.io.camera_preset as tcp

    path = tmp_path / "preset_decimation_4.0_depth_step_100.json"
    path.write_text(json.dumps({
        "device": {"fw version": "05.13.00.50", "name": "Intel RealSense D435"},
        "parameters": {"param-zunits": "100", "param-depthclampmin": "0",
                       "param-depthclampmax": "65536"},
        "viewer": {"stream-fps": "30", "stream-height": "720", "stream-width": "1280"}}))
    pre, jpre = tcp.load_preset(str(path)), jcp.load_preset(str(path))
    assert pre.__dict__ == jpre.__dict__ and pre.decimation == 4
    rgb, depth = render_frame(SyntheticRope(), 1 / 15.0, LIVE, depth_noise_mm=0.7)
    rng = np.random.default_rng(0)
    fine = depth.astype(np.float64) + rng.uniform(-0.5, 0.5, depth.shape) * (depth > 0)
    q = tcp.sensor_depth_mm(fine, pre)
    assert np.array_equal(q, jcp.sensor_depth_mm(fine, jpre))
    dq = np.round(q).astype(np.uint16)
    dec = tcp.decimate_depth(dq, pre)
    assert np.array_equal(dec, jcp.decimate_depth(dq, jpre))
    intr = tcp.decimated_intrinsics(tcfg.CameraIntrinsics(), pre)
    assert intr.__dict__ == jcp.decimated_intrinsics(LIVE, jpre).__dict__
    assert (intr.width, intr.height) == dec.shape[::-1] == (320, 180)
    jintr = CameraIntrinsics(**intr.__dict__)
    assert _step_pair(QUARTER_PARAMS, jintr, np.ascontiguousarray(rgb[::4, ::4]), dec) <= STEP_TOL_M


def test_pseudo_depth_copy_and_its_step():
    """A pseudo-real D435 depth frame (tilted desk, rope bump, mixed pixels,
    shadows, speckle) from the port's copy, equal to the JAX package's for
    the same seed, stepped by both trackers at the quarter camera."""
    import trackdlo_tpu.io.pseudo_depth as jpd
    import trackdlo_tpu_torch.io.pseudo_depth as tpd
    from trackdlo_tpu.oracle.preprocess import segment_dlo

    params = QUARTER_PARAMS
    rgb, _ = render_frame(SyntheticRope(), 1 / 15.0, QUARTER)
    mask = segment_dlo(rgb, params.hsv_lower, params.hsv_upper, params.multi_color_dlo) > 0
    depth = tpd.pseudo_depth_from_photo(rgb, mask, seed=3)
    assert depth.dtype == np.uint16
    assert np.array_equal(depth, jpd.pseudo_depth_from_photo(rgb, mask, seed=3))
    assert _step_pair(params, QUARTER, rgb, depth) <= STEP_TOL_M
