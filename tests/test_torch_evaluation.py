"""The port's evaluation harness (trackdlo_tpu_torch.evaluation) against the
JAX package's on the CPU: the batched metric, a scoring run with a port
tracker, and the batched occlusion sweep."""

import numpy as np
import pytest
import torch

from trackdlo_tpu.config import CameraIntrinsics, live_params
from trackdlo_tpu.evaluation import evaluator as jev
from trackdlo_tpu.io.sequence import SyntheticRope, render_frame
from trackdlo_tpu_torch.evaluation import (
    EvalConfig,
    OcclusionSchedule,
    piecewise_error,
    piecewise_error_batch,
    run_evaluation,
)
from trackdlo_tpu_torch.models.trackdlo import Tracker

SMALL = CameraIntrinsics(fx=120.0, fy=120.0, cx=80.0, cy=60.0, width=160, height=120)
PARAMS = live_params(max_points=256, downsample_cell_px=4, dlo_pixel_width=5)
# The metric in float32 on both sides, sums in another order.
METRIC_TOL_M = 1e-6
# A closed loop of the batched step against the JAX package's: per
# stream-frame, the open-loop step bound of tests/test_torch_batched.py; the
# (E1+E2)/2 error moves by at most the nodes' largest move.
STEP_TOL_M = 5e-4


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_piecewise_error_batch_matches_jax(seed):
    rng = np.random.default_rng(seed)
    rope = SyntheticRope()
    gt = np.stack([rope.nodes(0.1 * b, 30) for b in range(4)])
    track = (np.stack([rope.nodes(0.1 * b + 0.02, 45) for b in range(4)])
             + rng.normal(0, 0.003, (4, 45, 3)))
    want = jev.piecewise_error_batch(track, gt)
    got = piecewise_error_batch(track, gt, device="cpu")
    assert got.shape == (4,) and got.dtype == np.float32
    assert np.abs(got - want).max() <= METRIC_TOL_M
    got_t = piecewise_error_batch(torch.from_numpy(track.astype(np.float32)), gt, device="cpu")
    assert np.array_equal(got_t, got)
    for b in range(4):
        assert abs(float(got[b]) - piecewise_error(track[b], gt[b])) <= METRIC_TOL_M


def test_run_evaluation_with_a_port_tracker(tmp_path):
    """Six frames with exact ground truth, occlusion from frame 3: the error
    file in the reference's format, each error the JAX package's metric on
    the port's trajectory."""
    rope = SyntheticRope()
    frames = [render_frame(rope, i / 15.0, SMALL, rope_pixel_radius=3) for i in range(6)]
    gt = np.array([rope.nodes(i / 15.0, PARAMS.M) for i in range(6)])
    tracker = Tracker(PARAMS, SMALL, device="cpu")
    state = tracker.init_from_nodes(gt[0])
    config = EvalConfig(scenario="stationary", pct_occlusion=25, save_location=str(tmp_path))
    schedule = OcclusionSchedule(start_record_at=0.0, wait_before_occlusion=2.5 / 15.0,
                                 exit_at=None)
    result = run_evaluation(tracker, state, frames, config, SMALL, gt_nodes=gt, schedule=schedule)
    assert len(result.errors) == 6 and result.trajectories.shape == (6, PARAMS.M, 3)
    assert result.mean_error < 0.01
    for y, g, e in zip(result.trajectories, gt, result.errors):
        assert abs(e - jev.piecewise_error(y, g)) <= 1e-12
    lines = (tmp_path / "trackdlo_0_25_stationary_error.txt").read_text().strip().split("\n")
    assert len(lines) == 6
    assert float(lines[0].split()[1]) == pytest.approx(result.errors[0], abs=1e-5)


def test_occlusion_sweep_matches_jax():
    from trackdlo_tpu.evaluation.sweep import occlusion_sweep as jax_sweep
    from trackdlo_tpu_torch.evaluation.sweep import occlusion_sweep

    rope = SyntheticRope()
    frames = [render_frame(rope, i / 15.0, SMALL, rope_pixel_radius=3) for i in range(4)]
    gt = np.array([rope.nodes(i / 15.0, PARAMS.M) for i in range(4)])
    kw = dict(pct_values=(0, 30, 60), occlude_from_frame=1)
    jp, je = jax_sweep(PARAMS, SMALL, frames, gt, gt[0], **kw)
    tp, te = occlusion_sweep(PARAMS, SMALL, frames, gt, gt[0], device="cpu", **kw)
    assert np.array_equal(tp, jp) and te.shape == je.shape == (3, 4)
    assert np.abs(te - je).max() <= STEP_TOL_M
    assert te[0, -1] < 0.01
