"""Node counts past 48 (every ``num_of_nodes`` up to 128 runs the
hand-written kernels on the card): each kernel's node bound
(``hopper_kernels.NODE_MAX``: the narrow builds take m <= 48, V's 64, W's 65,
the wide builds up to 128, W's 129), the port's step at 49, 64 and 100 nodes
against the JAX package's, and the plain EM loop's solve (``solve_ex``, no
status read on the card) bit-equal to the ``torch.linalg.solve`` it
replaced."""

import numpy as np
import pytest
import torch

from trackdlo_tpu.config import CameraIntrinsics, live_params
from trackdlo_tpu.io.sequence import SyntheticRope, render_frame
from trackdlo_tpu_torch import _build
from trackdlo_tpu_torch.config import live_params as torch_live_params
from trackdlo_tpu_torch.convert import state_from_numpy
from trackdlo_tpu_torch.models.trackdlo import Tracker
from trackdlo_tpu_torch.ops import cpd_lle as tc
from trackdlo_tpu_torch.ops import hopper_kernels as hk

# The frame-by-frame setup of tests/test_torch_tracker.py: the small camera
# with the painter's line width scaled to it.
SMALL = CameraIntrinsics(fx=120.0, fy=120.0, cx=80.0, cy=60.0, width=160, height=120)
SMALL_KW = dict(max_points=256, downsample_cell_px=4, dlo_pixel_width=5)
# Per frame from one state: the open-loop step bound of
# tests/test_torch_tracker.py (two float32 realisations of the same step).
STEP_TOL_M = 5e-4
# The most nodes each kernel takes on the card: the wide builds of
# csrc/estep_cluster.cuh and gj.cuh (E, S, G, F), nearest.cu and
# visibility.cu take 128, walks.cu 129 (four segments a lane).
KERNEL_MAX_NODES = {"em_loop": 128, "estep": 128, "estep_batch": 128, "gj_solve": 128,
                    "em_iteration": 128, "nearest": 128, "visibility": 128, "walks": 129}


@pytest.mark.parametrize("m", [1, 2, 45, 48, 49, 64, 65, 66, 100, 128, 129, 130])
def test_node_bound_by_kernel(m):
    assert hk.NODE_MAX == KERNEL_MAX_NODES
    assert set(KERNEL_MAX_NODES) <= set(_build.launch_counts)
    for name, top in KERNEL_MAX_NODES.items():
        lo = 2 if name in ("visibility", "walks") else 1
        if lo <= m <= top:
            hk.check_nodes("f", name, m, lo=lo)
        else:
            with pytest.raises(ValueError, match=f"m={m} outside"):
                hk.check_nodes("f", name, m, lo=lo)


def test_replay_counts_add_to_the_launch_counters(monkeypatch):
    """A CUDA graph's replay adds the launches its capture recorded
    (``CompiledStep``): a difference of two copies of the counters, added
    back with ``add_counts``."""
    monkeypatch.setattr(_build, "launch_counts", dict.fromkeys(_build.launch_counts, 0))
    _build.count_launch("em_loop")
    before = dict(_build.launch_counts)
    _build.count_launch("em_loop")
    _build.count_launch("walks")
    after = dict(_build.launch_counts)
    delta = {k: after[k] - before[k] for k in after}
    assert delta == dict(dict.fromkeys(after, 0), em_loop=1, walks=1)
    _build.add_counts(delta)
    assert _build.launch_counts["em_loop"] == 3 and _build.launch_counts["walks"] == 2
    _build.reset_launch_counts()
    assert not any(_build.launch_counts.values())


def _occlusion(intr, i):
    if i not in (2, 3):
        return None
    occ = np.ones((intr.height, intr.width), np.uint8)
    occ[:, int(0.39 * intr.width):int(0.625 * intr.width)] = 0
    return occ


@pytest.mark.parametrize("m", [49, 64, 100])
def test_step_past_the_kernel_range_matches_jax(m):
    """Five frames, the second and third occluded, each from the JAX step's
    state (the frames of tests/test_torch_tracker.py's frame-by-frame test).
    At a quarter of the live camera, frame 3 of 64 nodes runs the
    pre-registration pass to max_iter and the JAX package's own two routes
    (XLA and the interpreted kernels) land 0.79 mm apart there, past this
    bound: that frame measures the step's sensitivity, not the port."""
    from trackdlo_tpu.models.trackdlo import Tracker as JaxTracker

    rope = SyntheticRope()
    jt = JaxTracker(live_params(num_of_nodes=m, **SMALL_KW), SMALL)
    tt = Tracker(torch_live_params(num_of_nodes=m, **SMALL_KW), SMALL, device="cpu")
    js = jt.init_from_nodes(rope.nodes(0.0, m))
    for i in range(1, 6):
        rgb, depth = render_frame(rope, i / 15.0, SMALL, rope_pixel_radius=3)
        occ = _occlusion(SMALL, i)
        ts = state_from_numpy(np.asarray(js.y), np.asarray(js.sigma2),
                              np.asarray(js.geodesic_coord), device="cpu")
        js, jo = jt.step(js, rgb, depth, occ)
        ts, to = tt.step(ts, rgb, depth, occ)
        assert ts.y.shape == (m, 3)
        assert int(to.n_points) == int(jo.n_points)
        assert int(to.occlusion_state) == int(jo.occlusion_state)
        # The clouds may differ by a voxel where a point sits on a voxel
        # boundary (frame 4 of 64 nodes: one point 1.78 mm apart), which can
        # move one node's nearest point across the visibility threshold.
        flips = (to.visible_mask.numpy() != np.asarray(jo.visible_mask)).sum()
        assert flips <= 1, (i, flips)
        assert np.abs(ts.y.numpy() - np.asarray(js.y)).max() <= STEP_TOL_M, i


def _prereg_staging(m, seed):
    """A pre-registration pass's staging (LLE, cond(A) near 4e6) of ``m``
    nodes on a noisy cloud along the rope."""
    rng = np.random.default_rng(seed)
    rope = SyntheticRope()
    y = torch.from_numpy(rope.nodes(0.0, m).astype(np.float32))
    curve = rope.curve(1 / 15.0)
    x = np.zeros((256, 3), np.float32)
    x[:200] = curve[rng.integers(0, len(curve), 200)] + rng.normal(0, 0.002, (200, 3))
    p = torch_live_params()
    params = tc.CpdParams(beta=p.beta_pre_proc, lam=p.lambda_pre_proc, lle_weight=p.lle_weight,
                          mu=p.mu, max_iter=p.max_iter, tol=p.tol, include_lle=True,
                          prune_radius=p.prune_radius,
                          visibility_threshold=p.visibility_threshold)
    return tc.em_staging(torch.from_numpy(x), torch.from_numpy(np.arange(256) < 200), y,
                         torch.ones(m, dtype=torch.bool), torch.tensor(p.sigma2_init), params)


@pytest.mark.parametrize("m", [45, 64])
def test_plain_loop_solve_ex_equals_solve(m, monkeypatch):
    st = _prereg_staging(m, seed=m)
    got = hk.fused_em_loop_plain(*st.args, **st.kwargs)
    monkeypatch.setattr(torch.linalg, "solve_ex",
                        lambda a, b: (torch.linalg.solve(a, b), torch.zeros((), dtype=torch.int32)))
    before = hk.fused_em_loop_plain(*st.args, **st.kwargs)
    assert int(got[1][1]) > 1
    for a, b in zip(got, before):
        assert torch.equal(a, b)


@pytest.mark.parametrize("m", [64, 100])
def test_live_camera_step_sits_with_the_jax_step_against_the_oracle(m):
    """The live profile at the 720p camera, the first ten frames of
    chip_smoke.py's closed loop (columns 500:800 occluded from frame 10), each
    stepped from the port's own state by the port, by the JAX package's TPU
    route (its Pallas kernels, interpreted: the kernels the port's replace)
    and by the float64 oracle. At 64 nodes the steps land up to ~5 mm apart
    from one state: the live profile's sensitivity (an EM pass that exits
    early in one runs to max_iter in another), which the JAX step shares;
    over the frames the oracle steps, the port's mean distance from it is at
    most the JAX step's. At 100 nodes two of the 100 nodes are visible and
    the oracle's LLE raises (fewer than 7 guide nodes); every frame's step
    is held to the JAX step at the open-loop bound. The JAX package's XLA
    route differs there: with fewer than 3 guides the anchor fallback's row
    -1 wraps to the last node in XLA, where B1's select gives 0."""
    import dataclasses

    from trackdlo_tpu.models.trackdlo import Tracker as JaxTracker, TrackerState as JaxState
    from trackdlo_tpu_torch.config import CameraIntrinsics as TorchIntrinsics
    from trackdlo_tpu_torch.oracle.pipeline import init_state, step_frame

    live, rope = CameraIntrinsics(), SyntheticRope()
    params = torch_live_params(num_of_nodes=m)
    tt = Tracker(params, TorchIntrinsics(), device="cpu")
    jt = JaxTracker(live_params(num_of_nodes=m, use_pallas_estep=True), live)
    state = tt.init_from_nodes(rope.nodes(0.0, m))
    base = init_state(rope.nodes(0.0, m), params)
    port_mm, jax_mm, apart = [], [], []
    for i in range(1, 11):
        rgb, depth = render_frame(rope, i / 15.0, live)
        occ = np.ones((live.height, live.width), np.uint8) * 255
        if i >= 10:
            occ[:, 500:800] = 0
        before = dataclasses.replace(base, y=state.y.numpy().astype(np.float64),
                                     sigma2=float(state.sigma2))
        js, _ = jt.step(JaxState(*(np.asarray(t.numpy()) for t in state)), rgb, depth, occ)
        state, _ = tt.step(state, rgb, depth, occ)
        y, yj = state.y.numpy(), np.asarray(js.y)
        apart.append(float(np.abs(y - yj).max()))
        try:
            one, _, _ = step_frame(before, rgb, depth, params, TorchIntrinsics(), occ)
        except IndexError:  # the oracle's LLE: fewer than 7 guide nodes
            continue
        port_mm.append(1000 * float(np.linalg.norm(y - one.y, axis=1).mean()))
        jax_mm.append(1000 * float(np.linalg.norm(yj - one.y, axis=1).mean()))
    assert np.isfinite(state.y.numpy()).all()
    if m == 64:
        assert len(port_mm) >= 8
        assert np.mean(port_mm) <= np.mean(jax_mm), (port_mm, jax_mm)
    else:
        assert max(apart) <= STEP_TOL_M, apart
