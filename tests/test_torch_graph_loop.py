"""The lockstep EM loop's in-place trip body (ops.cpd_lle.em_loop_lockstep),
which a CUDA graph holds as a conditional WHILE node on the card
(ops.graph_loop), run here under its host ``while``:

- bit for bit the loop as it was before the body went in place (kept below
  as the reference), for a batch of four and for every single-stream
  per-iteration route (each solver, kernel F's route);
- kernel L's plain version (the trip flag);
- the batched step and the lstsq step against the JAX package's jitted
  steps, within the bounds of tests/test_torch_batched.py and
  tests/test_torch_tracker.py;
- the compiled entry points (build_batched_step_fn(jit=True), build_step_fn
  with every solver, the points step) default to the card and raise
  without one, unless the caller names the CPU."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trackdlo_tpu_torch.config import CameraIntrinsics, live_params
from trackdlo_tpu_torch.io.sequence import SyntheticRope, render_frame
from trackdlo_tpu_torch.ops import cpd_lle as tc
from trackdlo_tpu_torch.ops import graph_loop
from trackdlo_tpu_torch.ops.hopper_kernels import fused_estep_packed_batch

M, N = 45, 256
PARAMS = live_params()
SMALL = CameraIntrinsics(fx=120.0, fy=120.0, cx=80.0, cy=60.0, width=160, height=120)
SMALL_PARAMS = live_params(max_points=256, downsample_cell_px=4, dlo_pixel_width=5)
LIVE = CameraIntrinsics()
QUARTER = CameraIntrinsics(fx=LIVE.fx / 4, fy=LIVE.fy / 4, cx=LIVE.cx / 4, cy=LIVE.cy / 4,
                           width=LIVE.width // 4, height=LIVE.height // 4)
QUARTER_PARAMS = live_params(max_points=512, dlo_pixel_width=10)
STEP_TOL_M = 5e-4
SOLVERS = ["lu", "lstsq", "normal_cholesky", "svd_lstsq", "xla_lu"]


def reference_loop(st, params, iteration):
    """The lockstep loop before its body went in place (the port as of its
    first compiled step): new tensors every trip, one flag read a trip."""
    y = st.args[1]
    s2 = st.args[0][:, 0]
    bsz = y.shape[0]
    it = torch.zeros(bsz, dtype=torch.int32)
    done = torch.zeros(bsz, dtype=torch.bool)
    converged = torch.ones(bsz, dtype=torch.bool)
    while True:
        active = ~done & (it < params.max_iter)
        if not bool(active.any()):
            break
        t, s2_new, delta = iteration(y, s2)
        new_done = delta < params.tol
        y = torch.where(active[:, None, None], t, y)
        s2 = torch.where(active, s2_new, s2)
        converged = torch.where(active, new_done | (it + 1 < params.max_iter), converged)
        done = torch.where(active, new_done, done)
        it = it + active.to(torch.int32)
    return y, s2, it, converged


def _staging(bsz, seed, **kw):
    """A main-pass staging of ``bsz`` streams (priors, the visibility gate
    on in odd streams) and its CpdParams."""
    rng = np.random.default_rng(seed)
    p = PARAMS
    base = dict(beta=p.beta, lam=p.lam, lle_weight=p.lle_weight, mu=p.mu, max_iter=p.max_iter,
                tol=p.tol, include_lle=False, visibility_threshold=p.visibility_threshold,
                prune_radius=p.prune_radius, use_visibility=True, k_vis=p.k_vis,
                use_priors=True, alpha=p.alpha)
    params = tc.CpdParams(**{**base, **kw})
    ys, xs, xms, pps, pms, vcs = [], [], [], [], [], []
    for b in range(bsz):
        curve = SyntheticRope().curve(1 / 15.0 + 0.01 * b)
        n_valid = 180 + 10 * b
        x = np.zeros((N, 3), np.float32)
        x[:n_valid] = curve[rng.integers(0, len(curve), n_valid)] + rng.normal(0, 0.002, (n_valid, 3))
        y = SyntheticRope().nodes(0.01 * b, M).astype(np.float32)
        ys.append(y)
        xs.append(x)
        xms.append(np.arange(N) < n_valid)
        pps.append((y + 0.004).astype(np.float32))
        pms.append(np.arange(M) < 12 + b)
        vcs.append(30 if b % 2 else M)
    t = lambda a: torch.from_numpy(np.stack(a))
    st = tc.em_staging(t(xs), t(xms), t(ys), torch.ones(bsz, M, dtype=torch.bool),
                       torch.full((bsz,), p.sigma2_init), params, prior_pos=t(pps),
                       prior_mask=t(pms), visible_count=torch.tensor(vcs))
    return st, params


def _assert_bit_equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_in_place_body_is_the_reference_loop_batched():
    st, params = _staging(4, seed=0)
    iteration = tc.iteration_route(st, params, fused_estep_packed_batch)
    got = tc.em_loop_lockstep(st, params, iteration)
    want = reference_loop(st, params, iteration)
    _assert_bit_equal(got, want)
    assert len(set(got[2].tolist())) >= 2  # the streams exit on different trips
    # The staging's own tensors are read, never written.
    st2, _ = _staging(4, seed=0)
    for a, b in zip(st.args, st2.args):
        assert torch.equal(a, b)


@pytest.mark.parametrize("route", SOLVERS[1:] + ["fused_mstep"])
def test_in_place_body_is_the_reference_loop_single_stream(route):
    kw = {"use_fused_mstep": True} if route == "fused_mstep" else {"solver": route}
    st, params = _staging(1, seed=1, **kw)
    iteration = tc.iteration_route(st, params, tc._estep_one_stream)
    got = tc.em_loop_lockstep(st, params, iteration)
    want = reference_loop(st, params, iteration)
    _assert_bit_equal(got, want)
    assert 1 <= int(got[2][0]) < params.max_iter


def test_in_place_body_stops_at_max_iter():
    st, params = _staging(2, seed=2, tol=0.0, max_iter=3)
    iteration = tc.iteration_route(st, params, fused_estep_packed_batch)
    got = tc.em_loop_lockstep(st, params, iteration)
    _assert_bit_equal(got, reference_loop(st, params, iteration))
    assert got[2].tolist() == [3, 3] and not got[3].any()
    st0, params0 = _staging(2, seed=2, max_iter=0)
    got0 = tc.em_loop_lockstep(st0, params0, tc.iteration_route(st0, params0, fused_estep_packed_batch))
    assert got0[2].tolist() == [0, 0] and torch.equal(got0[0], st0.args[1])


def test_loop_flag_plain():
    done = torch.tensor([True, False, False])
    it = torch.tensor([1, 5, 2], dtype=torch.int32)
    assert int(graph_loop.loop_flag(done, it, 5)) == 1  # stream 2 is below 5
    assert int(graph_loop.loop_flag(done, it, 2)) == 0
    assert int(graph_loop.loop_flag(torch.ones(3, dtype=torch.bool), it, 9)) == 0
    assert graph_loop.loop_flag(done, it, 5).dtype == torch.int32


def test_device_while_needs_a_recorded_capture():
    z = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="CompiledStep"):
        graph_loop.device_while(z.bool(), z, 1, lambda: None)
    assert not graph_loop.capturing(torch.device("cpu"))


def test_batched_step_matches_jax_jitted_step():
    from trackdlo_tpu.models.trackdlo import init_state as jax_init
    from trackdlo_tpu.parallel import build_batched_step_fn as jax_batched
    from trackdlo_tpu.parallel import replicate_state as jax_replicate
    from trackdlo_tpu_torch.models.trackdlo import Tracker
    from trackdlo_tpu_torch.parallel import build_batched_step_fn, replicate_state

    bsz, rope = 4, SyntheticRope()
    fr = [render_frame(rope, 1 / 15.0 + 0.01 * b, SMALL, rope_pixel_radius=3) for b in range(bsz)]
    rgb, depth = np.stack([f[0] for f in fr]), np.stack([f[1] for f in fr])
    occ = np.ones((bsz, SMALL.height, SMALL.width), bool)
    occ[1, :, 62:100] = False
    state = replicate_state(Tracker(SMALL_PARAMS, SMALL, device="cpu").init_from_nodes(
        rope.nodes(0.0, SMALL_PARAMS.M)), bsz)
    js = jax_replicate(jax_init(rope.nodes(0.0, SMALL_PARAMS.M), SMALL_PARAMS), bsz)
    js, jo = jax_batched(SMALL_PARAMS, SMALL, cohort_size=2)(
        js, jnp.asarray(rgb), jnp.asarray(depth), jnp.asarray(occ))
    ts, to = build_batched_step_fn(SMALL_PARAMS, SMALL, cohort_size=2, device="cpu", jit=True)(
        state, rgb, depth, occ)
    np.testing.assert_array_equal(to.n_points.numpy(), np.asarray(jo.n_points))
    np.testing.assert_array_equal(to.occlusion_state.numpy(), np.asarray(jo.occlusion_state))
    assert np.abs(ts.y.numpy() - np.asarray(js.y)).max() <= STEP_TOL_M


def test_lstsq_step_matches_jax_jitted_step():
    from trackdlo_tpu.models.trackdlo import Tracker as JaxTracker
    from trackdlo_tpu_torch.convert import state_from_numpy
    from trackdlo_tpu_torch.models.trackdlo import Tracker

    params = dataclasses.replace(QUARTER_PARAMS, solver="lstsq")
    rope = SyntheticRope()
    jt, tt = JaxTracker(params, QUARTER), Tracker(params, QUARTER, device="cpu")
    js = jt.init_from_nodes(rope.nodes(0.0, params.M))
    ts = state_from_numpy(np.asarray(js.y), np.asarray(js.sigma2), np.asarray(js.geodesic_coord),
                          device="cpu")
    for i in (1, 2):
        rgb, depth = render_frame(rope, i / 15.0, QUARTER)
        js, jo = jt.step(js, rgb, depth)
        ts, to = tt.step(ts, rgb, depth)
        assert int(to.n_points) == int(jo.n_points)
        assert np.abs(ts.y.numpy() - np.asarray(js.y)).max() <= STEP_TOL_M
        ts = state_from_numpy(np.asarray(js.y), np.asarray(js.sigma2),
                              np.asarray(js.geodesic_coord), device="cpu")


@pytest.mark.parametrize("solver", SOLVERS)
def test_compiled_entry_points_default_to_the_card(solver):
    from trackdlo_tpu_torch.models.trackdlo import (
        Tracker,
        build_points_step_fn,
        build_step_fn,
    )
    from trackdlo_tpu_torch.parallel import build_batched_step_fn

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    params = dataclasses.replace(SMALL_PARAMS, solver=solver)
    for make in (lambda: build_step_fn(params, SMALL), lambda: build_points_step_fn(params, SMALL),
                 lambda: build_batched_step_fn(params, SMALL, cohort_size=2),
                 lambda: build_batched_step_fn(params, SMALL, jit=True),
                 lambda: Tracker(params, SMALL)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    # Named, the CPU gets the eager step: a plain function, no graph.
    assert not hasattr(build_step_fn(params, SMALL, device="cpu"), "graph")
    assert not hasattr(build_points_step_fn(params, SMALL, device="cpu"), "graph")


def test_points_step_is_the_eager_track_from_points():
    """Tracker.step_from_points through build_points_step_fn: on the CPU the
    eager step, equal to _track_from_points on the same padded cloud."""
    from trackdlo_tpu_torch.models.trackdlo import Tracker, _track_from_points
    from trackdlo_tpu_torch.ops.preprocess import PointCloud

    params, rope = QUARTER_PARAMS, SyntheticRope()
    tracker = Tracker(params, QUARTER, device="cpu")
    state = tracker.init_from_nodes(rope.nodes(0.0, params.M))
    rng = np.random.default_rng(4)
    curve = rope.curve(1 / 15.0)
    pts = (curve[rng.integers(0, len(curve), 300)] + rng.normal(0, 0.002, (300, 3))).astype(np.float32)
    s1, o1 = tracker.step_from_points(state, pts)
    cap = params.max_points
    full = torch.zeros(cap, 3)
    full[:300] = torch.from_numpy(pts)
    msk = torch.arange(cap) < 300
    proj = torch.as_tensor(np.array(QUARTER.proj_matrix(), np.float32))
    s2, o2 = _track_from_points(state, PointCloud(full, msk, msk.to(torch.int64).sum()), proj,
                                params=params, intr=QUARTER)
    _assert_bit_equal(s1, s2)
    _assert_bit_equal(o1, o2)
