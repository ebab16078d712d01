"""The port's Tracker (trackdlo_tpu_torch.models.trackdlo) end to end on the
CPU, where every kernel wrapper takes its plain version:

- frame by frame against the JAX package's Tracker.step, both started from
  the same state through trackdlo_tpu_torch.convert;
- a closed loop against the float64 oracle;
- the API's checks, and that the port never imports JAX."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from trackdlo_tpu.config import CameraIntrinsics, live_params
from trackdlo_tpu.io.sequence import SyntheticRope, render_frame
from trackdlo_tpu_torch.convert import state_from_numpy, state_to_numpy
from trackdlo_tpu_torch.models.trackdlo import Tracker, init_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIVE = CameraIntrinsics()
SMALL = CameraIntrinsics(fx=120.0, fy=120.0, cx=80.0, cy=60.0, width=160, height=120)
# The small camera sees the rope at 1/7.65 of the live scale: the painter's
# line width scales with it (40 px live), or every node self-occludes.
SMALL_PARAMS = live_params(max_points=256, downsample_cell_px=4, dlo_pixel_width=5)
QUARTER = CameraIntrinsics(fx=LIVE.fx / 4, fy=LIVE.fy / 4, cx=LIVE.cx / 4, cy=LIVE.cy / 4,
                           width=LIVE.width // 4, height=LIVE.height // 4)
QUARTER_PARAMS = live_params(max_points=512, dlo_pixel_width=10)
# Per frame from one state, the port and JAX run the same float32 algorithm
# with sums in another order. On these frames JAX's own two routes (XLA and
# the interpreted kernels) differ by up to 1.7e-4 m in y: the
# pre-registration solve (cond near 4e6) moves the guide nodes by up to 4 mm,
# and the main EM's exit at a 0.2 mm mean move can stop one iteration apart.
# The port is held to the same scale, below the 1 mm closed-loop bound.
STEP_TOL_M = 5e-4


def _occlusion(intr, i, frames):
    if i not in frames:
        return None
    occ = np.ones((intr.height, intr.width), np.uint8)
    occ[:, int(0.39 * intr.width):int(0.625 * intr.width)] = 0
    return occ


@pytest.mark.parametrize("jax_route", ["xla", "interpreted_kernels"])
def test_step_matches_jax_frame_by_frame(jax_route):
    from trackdlo_tpu.models.trackdlo import Tracker as JaxTracker

    params, intr = SMALL_PARAMS, SMALL
    rope = SyntheticRope()
    jt = JaxTracker(dataclasses.replace(params, use_pallas_estep=jax_route != "xla"), intr)
    tt = Tracker(params, intr, device="cpu")
    js = jt.init_from_nodes(rope.nodes(0.0, params.M))
    states = set()
    for i in range(1, 6):
        rgb, depth = render_frame(rope, i / 15.0, intr, rope_pixel_radius=3)
        occ = _occlusion(intr, i, (2, 3))
        ts = state_from_numpy(np.asarray(js.y), np.asarray(js.sigma2), np.asarray(js.geodesic_coord),
                              device="cpu")
        js, jo = jt.step(js, rgb, depth, occ)
        ts, to = tt.step(ts, rgb, depth, occ)
        assert int(to.n_points) == int(jo.n_points)
        assert int(to.occlusion_state) == int(jo.occlusion_state)
        for f in ("visible_mask", "extended_mask", "not_self_occluded", "prior_mask"):
            np.testing.assert_array_equal(getattr(to, f).numpy(), np.asarray(getattr(jo, f)), err_msg=f)
        assert np.abs(ts.y.numpy() - np.asarray(js.y)).max() <= STEP_TOL_M
        states.add(int(to.occlusion_state))
    assert len(states) >= 2


def test_step_from_points_matches_jax():
    from trackdlo_tpu.models.trackdlo import Tracker as JaxTracker

    params, intr = QUARTER_PARAMS, QUARTER
    rope = SyntheticRope()
    rng = np.random.default_rng(0)
    curve = rope.curve(1 / 15.0)
    pts = (curve[rng.integers(0, len(curve), 300)] + rng.normal(0, 0.002, (300, 3))).astype(np.float32)
    jt = JaxTracker(params, intr)
    tt = Tracker(params, intr, device="cpu")
    js = jt.init_from_nodes(rope.nodes(0.0, params.M))
    ts = state_from_numpy(np.asarray(js.y), np.asarray(js.sigma2), np.asarray(js.geodesic_coord),
                          device="cpu")
    js, jo = jt.step_from_points(js, pts)
    ts, to = tt.step_from_points(ts, pts)
    assert int(to.n_points) == int(jo.n_points) == 300
    assert int(to.occlusion_state) == int(jo.occlusion_state)
    assert np.abs(ts.y.numpy() - np.asarray(js.y)).max() <= STEP_TOL_M


def test_closed_loop_tracks_the_float64_oracle():
    """Ten frames, the middle five behind an occluder, at a quarter of the
    live camera (at 160x120 the oracle's own LLE fails on its two visible
    nodes). Mean node deviation from the oracle at most 1 mm."""
    from trackdlo_tpu.oracle.pipeline import init_state, step_frame

    params, intr = QUARTER_PARAMS, QUARTER
    rope = SyntheticRope()
    tracker = Tracker(params, intr, device="cpu")
    state = tracker.init_from_nodes(rope.nodes(0.0, params.M))
    o_state = init_state(rope.nodes(0.0, params.M), params)
    dev_mm, states = [], set()
    for i in range(1, 11):
        rgb, depth = render_frame(rope, i / 15.0, intr, rope_pixel_radius=3)
        occ = _occlusion(intr, i, range(3, 8))
        state, out = tracker.step(state, rgb, depth, occ)
        o_state, _, _ = step_frame(o_state, rgb, depth, params, intr, occ)
        y = state.y.numpy()
        assert y.shape == (params.M, 3) and np.isfinite(y).all()
        dev_mm.append(1000 * np.linalg.norm(y - o_state.y, axis=1).mean())
        states.add(int(out.occlusion_state))
    assert np.mean(dev_mm) <= 1.0, dev_mm
    assert len(states) >= 2


def test_port_never_imports_jax():
    """The port's single and batched steps, the oracle and the initialiser,
    through the port's own copies: neither jax nor trackdlo_tpu is loaded."""
    code = (
        "import sys, numpy as np\n"
        "from trackdlo_tpu_torch.config import CameraIntrinsics, live_params\n"
        "from trackdlo_tpu_torch.io.sequence import SyntheticRope, render_frame\n"
        "from trackdlo_tpu_torch.oracle.pipeline import init_state, step_frame\n"
        "from trackdlo_tpu_torch.parallel import build_batched_step_fn, replicate_state\n"
        "import trackdlo_tpu_torch.models.trackdlo as m, trackdlo_tpu_torch.convert\n"
        "import trackdlo_tpu_torch.models.multi, trackdlo_tpu_torch.dlo_init\n"
        "intr = CameraIntrinsics(fx=120., fy=120., cx=80., cy=60., width=160, height=120)\n"
        "p = live_params(max_points=256, downsample_cell_px=4, dlo_pixel_width=5)\n"
        "t = m.Tracker(p, intr, device='cpu')\n"
        "s = t.init_from_nodes(SyntheticRope().nodes(0.0, p.M))\n"
        "rgb, depth = render_frame(SyntheticRope(), 1 / 15.0, intr, rope_pixel_radius=3)\n"
        "t.step(s, rgb, depth)\n"
        "step_frame(init_state(SyntheticRope().nodes(0.0, p.M), p), rgb, depth, p, intr)\n"
        "fn = build_batched_step_fn(p, intr, device='cpu')\n"
        "fn(replicate_state(s, 2), np.stack([rgb, rgb]), np.stack([depth, depth]),\n"
        "   np.ones((2, 120, 160), bool))\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "             or k == 'trackdlo_tpu' or k.startswith('trackdlo_tpu.'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         cwd=REPO, timeout=300)
    assert res.returncode == 0, res.stderr


def test_cuda_device_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: nothing to refuse")
    with pytest.raises(RuntimeError):
        Tracker(SMALL_PARAMS, SMALL, device="cuda")


def test_default_device_is_the_card():
    """No device named: the card, never the CPU on its own."""
    if torch.cuda.is_available():
        assert Tracker(SMALL_PARAMS, SMALL).device.type == "cuda"
        return
    for make in (lambda: Tracker(SMALL_PARAMS, SMALL),
                 lambda: init_state(SyntheticRope().nodes(0.0, SMALL_PARAMS.M), SMALL_PARAMS),
                 lambda: state_from_numpy(np.zeros((3, 3)), np.float32(1e-3), np.zeros(3))):
        with pytest.raises(RuntimeError):
            make()


def test_construction_sets_full_fp32():
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    Tracker(SMALL_PARAMS, SMALL, device="cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_step_checks_its_inputs():
    params, intr = SMALL_PARAMS, SMALL
    tracker = Tracker(params, intr, device="cpu")
    state = tracker.init_from_nodes(SyntheticRope().nodes(0.0, params.M))
    rgb, depth = render_frame(SyntheticRope(), 0.0, intr, rope_pixel_radius=3)
    with pytest.raises(ValueError):
        tracker.step(state, rgb[:, :-1], depth)
    with pytest.raises(ValueError):
        tracker.step(state, rgb, depth[:-1])
    with pytest.raises(ValueError):
        tracker.step(state._replace(y=state.y[:-1]), rgb, depth)
    with pytest.raises(ValueError):
        tracker.init_from_nodes(np.zeros((params.M - 1, 3)))


def test_init_from_frame_uses_the_shared_initialiser():
    from trackdlo_tpu.dlo_init import initialize_nodes

    params, intr = QUARTER_PARAMS, QUARTER
    rgb, depth = render_frame(SyntheticRope(), 0.0, intr, rope_pixel_radius=3)
    state = Tracker(params, intr, device="cpu").init_from_frame(rgb, depth)
    want = initialize_nodes(rgb, depth, params, intr).astype(np.float32)
    np.testing.assert_array_equal(state.y.numpy(), want)
    seg = np.linalg.norm(np.diff(want, axis=0), axis=1)
    np.testing.assert_allclose(state.geodesic_coord.numpy()[1:], np.cumsum(seg), rtol=1e-5)


def test_state_round_trips_through_numpy():
    tracker = Tracker(SMALL_PARAMS, SMALL, device="cpu")
    state = tracker.init_from_nodes(SyntheticRope().nodes(0.3, SMALL_PARAMS.M))
    back = state_from_numpy(*state_to_numpy(state), device="cpu")
    for a, b in zip(state, back):
        assert torch.equal(a, b)
