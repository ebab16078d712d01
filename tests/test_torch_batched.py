"""The port's batched multi-stream step (trackdlo_tpu_torch.parallel) on the
CPU, where every kernel wrapper takes its plain version:

- against the JAX package's ``build_batched_step_fn`` (no mesh) on its XLA
  route and on its interpreted kernels;
- against the port's single-stream ``Tracker.step``, stream by stream;
- convergence cohorts: bit-equal to the lockstep batch, a cohort of one
  bit-equal to ``Tracker.step``;
- ``MultiTracker``, ``replicate_state`` and batched state conversion."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trackdlo_tpu_torch.config import CameraIntrinsics, live_params
from trackdlo_tpu_torch.convert import state_from_numpy, state_to_numpy
from trackdlo_tpu_torch.io.sequence import SyntheticRope, render_frame
from trackdlo_tpu_torch.models.multi import MultiTracker
from trackdlo_tpu_torch.models.trackdlo import Tracker
from trackdlo_tpu_torch.parallel import (
    build_batched_step_fn,
    build_parallel_step_fn,
    make_tracking_mesh,
    replicate_state,
)

SMALL = CameraIntrinsics(fx=120.0, fy=120.0, cx=80.0, cy=60.0, width=160, height=120)
# The small camera sees the rope at 1/7.65 of the live scale: the painter's
# line width scales with it (40 px live), or every node self-occludes.
PARAMS = live_params(max_points=256, downsample_cell_px=4, dlo_pixel_width=5)
# The JAX package's parity route merges voxels k and k+2 of one parity
# where an image cell's pixels span them (ROADMAP §C fault 6); the port's
# step keeps both. At this camera a 2 px cell's pixel centres lie ~5 mm
# apart at the rope, under the 8 mm leaf, so no cell spans two voxels of
# one parity there and both routes take the same voxels (a 24 mm leaf, as
# the other such tests take, leaves every stream of these frames in one
# occlusion state).
JAX_PARAMS = dataclasses.replace(PARAMS, downsample_cell_px=2)
B = 3
# Per frame from one state, two float32 realisations of the same step (see
# tests/test_torch_tracker.py): the open-loop step bound.
STEP_TOL_M = 5e-4
# The batched step runs the per-iteration EM, the single step kernel E's
# whole loop: two float32 routes through pre-registration solves with
# cond(A) near 4e6. On these frames the JAX package's own two kernel routes
# (batched vs single, interpreted) differ by up to 4.3e-5 m; the 1e-5 m of
# tests/test_parallel.py holds there only between two runs of one XLA route.
ROUTES_TOL_M = 1e-4


def _frames(batch, t=1 / 15.0, occluded=()):
    rope = SyntheticRope()
    fr = [render_frame(rope, t + 0.01 * b, SMALL, rope_pixel_radius=3) for b in range(batch)]
    occ = np.ones((batch, SMALL.height, SMALL.width), bool)
    for b in occluded:
        occ[b, :, 62:100] = False
    return np.stack([f[0] for f in fr]), np.stack([f[1] for f in fr]), occ


def _state0(batch):
    tracker = Tracker(PARAMS, SMALL, device="cpu")
    return tracker, replicate_state(tracker.init_from_nodes(SyntheticRope().nodes(0.0, PARAMS.M)), batch)


@pytest.mark.parametrize("jax_route", ["xla", "interpreted_kernels"])
def test_batched_step_matches_jax(jax_route):
    from trackdlo_tpu.models.trackdlo import init_state as jax_init
    from trackdlo_tpu.parallel import build_batched_step_fn as jax_batched
    from trackdlo_tpu.parallel import replicate_state as jax_replicate

    jparams = dataclasses.replace(JAX_PARAMS, use_pallas_estep=jax_route != "xla")
    rgb, depth, occ = _frames(B, occluded=(1,))
    _, state = _state0(B)
    js = jax_replicate(jax_init(SyntheticRope().nodes(0.0, PARAMS.M), jparams), B)
    js, jo = jax_batched(jparams, SMALL)(js, jnp.asarray(rgb), jnp.asarray(depth), jnp.asarray(occ))
    ts, to = build_batched_step_fn(JAX_PARAMS, SMALL, device="cpu")(state, rgb, depth, occ)
    np.testing.assert_array_equal(to.n_points.numpy(), np.asarray(jo.n_points))
    np.testing.assert_array_equal(to.occlusion_state.numpy(), np.asarray(jo.occlusion_state))
    for f in ("visible_mask", "extended_mask", "not_self_occluded", "prior_mask", "points_mask"):
        np.testing.assert_array_equal(getattr(to, f).numpy(), np.asarray(getattr(jo, f)), err_msg=f)
    assert ts.y.shape == (B, PARAMS.M, 3) and ts.sigma2.shape == (B,)
    assert np.abs(ts.y.numpy() - np.asarray(js.y)).max() <= STEP_TOL_M
    assert len(set(to.occlusion_state.tolist())) >= 2


def test_batched_streams_match_single_step():
    tracker, state = _state0(B)
    rgb, depth, occ = _frames(B)
    bs, bo = build_batched_step_fn(PARAMS, SMALL, device="cpu")(state, rgb, depth, occ)
    s0 = tracker.init_from_nodes(SyntheticRope().nodes(0.0, PARAMS.M))
    for b in range(B):
        single, out = tracker.step(s0, rgb[b], depth[b])
        err = float((single.y - bs.y[b]).abs().max())
        assert err <= (ROUTES_TOL_M if b == 1 else STEP_TOL_M), (b, err)
        assert int(out.n_points) == int(bo.n_points[b])
        assert int(out.occlusion_state) == int(bo.occlusion_state[b])


def test_batched_stream_matches_single_step_on_its_route():
    """Stream 1 against a single step that runs the batched step's EM route
    (the per-iteration loop with an LU solve): tests/test_parallel.py's
    1e-5 m, where both sides take one route."""
    _, state = _state0(B)
    rgb, depth, occ = _frames(B)
    bs, _ = build_batched_step_fn(PARAMS, SMALL, device="cpu")(state, rgb, depth, occ)
    tracker = Tracker(dataclasses.replace(PARAMS, solver="xla_lu"), SMALL, device="cpu")
    single, _ = tracker.step(tracker.init_from_nodes(SyntheticRope().nodes(0.0, PARAMS.M)),
                             rgb[1], depth[1])
    assert float((single.y - bs.y[1]).abs().max()) <= 1e-5


def test_cohorts_are_bit_equal_to_lockstep():
    _, state = _state0(4)
    rgb, depth, occ = _frames(4, occluded=(1, 3))
    lock, lock_o = build_batched_step_fn(PARAMS, SMALL, device="cpu")(state, rgb, depth, occ)
    coh, coh_o = build_batched_step_fn(PARAMS, SMALL, cohort_size=2, device="cpu")(state, rgb, depth, occ)
    assert torch.equal(lock.y, coh.y)
    assert torch.equal(lock.sigma2, coh.sigma2)
    assert torch.equal(lock_o.iterations, coh_o.iterations)


def test_cohort_of_one_is_the_single_step():
    """A cohort of one takes kernel E's whole loop: bit-equal to Tracker.step."""
    tracker, state = _state0(B)
    rgb, depth, occ = _frames(B, occluded=(2,))
    bs, bo = build_batched_step_fn(PARAMS, SMALL, cohort_size=1, device="cpu")(state, rgb, depth, occ)
    s0 = tracker.init_from_nodes(SyntheticRope().nodes(0.0, PARAMS.M))
    for b in range(B):
        single, out = tracker.step(s0, rgb[b], depth[b], occ[b])
        assert torch.equal(single.y, bs.y[b])
        assert torch.equal(single.sigma2, bs.sigma2[b])
        for f in out._fields:
            assert torch.equal(getattr(out, f), getattr(bo, f)[b]), f


def test_cohort_size_must_divide_batch():
    _, state = _state0(3)
    rgb, depth, occ = _frames(3)
    with pytest.raises(ValueError, match="not divisible"):
        build_batched_step_fn(PARAMS, SMALL, cohort_size=2, device="cpu")(state, rgb, depth, occ)


def test_batched_step_checks_shapes_and_device():
    _, state = _state0(2)
    rgb, depth, occ = _frames(2)
    fn = build_batched_step_fn(PARAMS, SMALL, device="cpu")
    with pytest.raises(ValueError):
        fn(state, rgb[:, :-1], depth, occ)
    with pytest.raises(ValueError):
        fn(replicate_state(type(state)(*(v[0] for v in state)), 3), rgb, depth, occ)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            build_batched_step_fn(PARAMS, SMALL)


@pytest.fixture
def one_rank_group(tmp_path):
    """A process group of this process alone."""
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)
    yield
    dist.destroy_process_group()


def test_one_rank_mesh_matches_batched_step(one_rank_group):
    """The mesh and the point-sharded step: on a mesh of one rank
    the DP × SP step matches the lockstep batched step, every discrete
    output equal (tests/test_torch_shard_step.py runs them over 4 ranks).
    The main pass's visibility weights are summed over 45 rows there and
    over the E-step's 48 padded rows here: y and sigma2 agree to rounding."""
    mesh = make_tracking_mesh()
    assert (mesh.data_size, mesh.model_size, mesh.data_rank, mesh.model_rank) == (1, 1, 0, 0)
    with pytest.raises(ValueError, match="not divisible"):
        make_tracking_mesh(model_parallel=2)
    _, state = _state0(2)
    rgb, depth, occ = _frames(2, occluded=(1,))
    ps, po = build_parallel_step_fn(PARAMS, SMALL, mesh, device="cpu")(state, rgb, depth, occ)
    bs, bo = build_batched_step_fn(PARAMS, SMALL, device="cpu")(state, rgb, depth, occ)
    for name, a, b in zip(ps._fields + po._fields, (*ps, *po), (*bs, *bo)):
        if name in ("y", "sigma2"):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6 if name == "y" else 2e-7)
        else:
            assert torch.equal(a, b), name


def test_replicate_state_and_batched_conversion():
    tracker, _ = _state0(1)
    s = tracker.init_from_nodes(SyntheticRope().nodes(0.2, PARAMS.M))
    rs = replicate_state(s, 4)
    assert rs.y.shape == (4, PARAMS.M, 3) and rs.sigma2.shape == (4,)
    assert rs.geodesic_coord.shape == (4, PARAMS.M)
    for b in range(4):
        for a, v in zip(s, rs):
            assert torch.equal(a, v[b])
    back = state_from_numpy(*state_to_numpy(rs), device="cpu")
    for a, v in zip(rs, back):
        assert torch.equal(a, v)


def test_multitracker_add_step_remove():
    rope = SyntheticRope()
    mt = MultiTracker(PARAMS, SMALL, device="cpu")
    mt.add_stream("cam0", init_nodes=rope.nodes(0.0, PARAMS.M))
    mt.add_stream("cam1", init_nodes=rope.nodes(0.01, PARAMS.M))
    with pytest.raises(ValueError):
        mt.add_stream("cam2")
    rgb, depth, occ = _frames(2)
    outs = mt.step_all({"cam0": (rgb[0], depth[0]), "cam1": (rgb[1], depth[1])},
                       {"cam1": occ[1]})
    assert set(outs) == {"cam0", "cam1"}
    single, _ = Tracker(PARAMS, SMALL, device="cpu").step(
        Tracker(PARAMS, SMALL, device="cpu").init_from_nodes(rope.nodes(0.0, PARAMS.M)), rgb[0], depth[0])
    np.testing.assert_array_equal(mt.nodes("cam0"), single.y.numpy())
    mt.remove_stream("cam0")
    assert set(mt.states) == {"cam1"} and set(mt.last_outputs) == {"cam1"}
    out = mt.step("cam1", rgb[1], depth[1])
    assert np.isfinite(mt.nodes("cam1")).all() and int(out.n_points) > 0
