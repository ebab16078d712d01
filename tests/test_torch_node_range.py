"""Node counts past 48 (every ``num_of_nodes`` runs the hand-written kernels
on the card): each kernel's builds (``hopper_kernels.NODE_BUILDS``: the
narrow builds take m <= 48, V's 64, W's 65, the wide builds up to 128, W's
129, the node-unbounded builds any m past those; ``NODE_MIN`` the only
bound), the port's step at 49, 64, 100, 129 and 256 nodes against the JAX
package's, the plain versions of the EM loop, visibility, the walks and the
E-step past 128 nodes (and 16,384 rows) against the JAX package's, and the
plain EM loop's solve (``solve_ex``, no status read on the card) bit-equal
to the ``torch.linalg.solve`` it replaced."""

import importlib
from pathlib import Path

import jax.numpy as jnp
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
# The JAX package's parity route merges voxels k and k+2 of one parity
# where an image cell's pixels span them (ROADMAP §C fault 6); the port's
# step keeps both. At this camera a 4 px cell spans ~22 mm at the rope,
# under a 24 mm leaf, so no cell spans two voxels of one parity there and
# both routes take the same voxels: the leaf of the tests that hold the
# port's step to the JAX package's.
JAX_KW = dict(SMALL_KW, downsample_leaf_size=0.024)
# Per frame from one state: the open-loop step bound of
# tests/test_torch_tracker.py (two float32 realisations of the same step).
STEP_TOL_M = 5e-4
# Each kernel's builds on the card, by the most nodes each takes (None: the
# node-unbounded build): csrc/estep_cluster.cuh and gj.cuh (E, S, G, F) 48
# and 128, nearest.cu 128, visibility.cu 64 and 128, walks.cu 65 and 129 (two
# or four segments a lane); past those every kernel takes any m.
KERNEL_BUILDS = {"em_loop": (48, 128, None), "estep": (48, 128, None),
                 "estep_batch": (48, 128, None), "gj_solve": (48, 128, None),
                 "em_iteration": (48, 128, None), "nearest": (128, None),
                 "visibility": (64, 128, None), "walks": (65, 129, None)}
CSRC = Path(__file__).resolve().parents[1] / "trackdlo_tpu_torch" / "csrc"


@pytest.mark.parametrize("m", [1, 2, 45, 48, 49, 64, 65, 66, 100, 128, 129, 130, 192, 256, 257,
                               512, 513, 1024])
def test_node_bound_by_kernel(m):
    """Every node count from the lower bound up is taken, by the first build
    whose bound holds it; below the lower bound (1; 2 for V and W, which
    need an edge) the wrapper raises."""
    assert hk.NODE_BUILDS == KERNEL_BUILDS
    assert set(KERNEL_BUILDS) <= set(_build.launch_counts)
    for name, builds in KERNEL_BUILDS.items():
        lo = 2 if name in ("visibility", "walks") else 1
        assert hk.NODE_MIN[name] == lo
        if m >= lo:
            hk.check_nodes("f", name, m)
            want = next(i for i, top in enumerate(builds) if top is None or m <= top)
            assert hk.node_build(name, m) == want
            assert hk.unbounded(name, m) == (builds[want] is None)
        else:
            with pytest.raises(ValueError, match=f"m={m} below {lo}"):
                hk.check_nodes("f", name, m)


@pytest.mark.parametrize("source, text", [
    ("estep_cluster.cuh", "constexpr int EC_MMAX = 48;"),
    ("estep_cluster.cuh", "constexpr int EC_MMAX_WIDE = 128;"),
    ("gj.cuh", "constexpr int GJ_MMAX = 48;"),
    ("gj.cuh", "constexpr int GJ_MMAX_WIDE = 128;"),
    ("unbounded.cuh", "constexpr int UB_MMIN = EC_MMAX_WIDE + 1;"),
    ("nearest.cu", "if (m > MMAX) {"),
    ("visibility.cu", "return m <= 64 ? launch<64>("),
    ("visibility.cu", "*out = m <= 128 ? 0 :"),
    ("walks.cu", "if (m > 32 * 4 + 1) {"),
    ("walks.cu", "} else if (m <= 32 * 2 + 1) {"),
])
def test_card_dispatch_follows_node_builds(source, text):
    """The C entry points pick their builds at the bounds NODE_BUILDS names
    (the wrappers choose the unbounded entry points by the same table)."""
    assert text in (CSRC / source).read_text()


def test_cluster_shape_of_the_unbounded_builds():
    """Past 128 nodes kernels E, S and F run 8 CTAs whatever n (the solve's
    pivot steps spread over the cluster), each CTA's rows a function of n
    alone; up to 128 nodes the shape of the bounded builds."""
    for n in (0, 1, 700, 2048, 16385, 65536):
        assert hk.cluster_shape(n, 129) == (8, -(-n // 8))
        assert hk.cluster_shape(n, 128) == hk.cluster_shape(n)


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
    jt = JaxTracker(live_params(num_of_nodes=m, **JAX_KW), SMALL)
    tt = Tracker(torch_live_params(num_of_nodes=m, **JAX_KW), SMALL, device="cpu")
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


# ---------------------------------------------------------------------------
# Past 128 nodes (and 16,384 rows): the plain versions, which the card's
# node-unbounded builds are held to (tests/test_torch_cuda.py, chip_smoke.py),
# against the JAX package's own functions, which take any m.
# ---------------------------------------------------------------------------

jc = importlib.import_module("trackdlo_tpu.ops.cpd_lle")
jv = importlib.import_module("trackdlo_tpu.ops.visibility")
jpr = importlib.import_module("trackdlo_tpu.ops.priors")
jpk = importlib.import_module("trackdlo_tpu.ops.pallas_kernels")


def _rope_cloud(m, seed, n_cap=256, n_valid=200):
    """Nodes of the rope at t=0 and a noisy cloud along it at t=1/15 (the
    cloud of ``_prereg_staging``)."""
    rng = np.random.default_rng(seed)
    rope = SyntheticRope()
    y = rope.nodes(0.0, m).astype(np.float32)
    curve = rope.curve(1 / 15.0)
    x = np.zeros((n_cap, 3), np.float32)
    x[:n_valid] = curve[rng.integers(0, len(curve), n_valid)] + rng.normal(0, 0.002, (n_valid, 3))
    return y, x, np.arange(n_cap) < n_valid


def _em_both(m, prereg=False):
    p = torch_live_params()
    kw = dict(beta=p.beta_pre_proc if prereg else p.beta,
              lam=p.lambda_pre_proc if prereg else p.lam, lle_weight=p.lle_weight, mu=p.mu,
              max_iter=3, tol=0.0, include_lle=True, visibility_threshold=p.visibility_threshold,
              prune_radius=p.prune_radius)
    y, x, xm = _rope_cloud(m, seed=m)
    nm = np.ones(m, bool)
    t = torch.from_numpy
    got = tc.cpd_lle(t(x), t(xm), t(y), t(nm), torch.tensor(p.sigma2_init), tc.CpdParams(**kw))
    ref = jc.cpd_lle(*(jnp.asarray(a) for a in (x, xm, y, nm)), jnp.float32(p.sigma2_init),
                     jc.CpdParams(**kw, use_pallas=False))
    return got, ref, kw


@pytest.mark.parametrize("m", [256, 512])
def test_em_loop_past_128_matches_jax(m):
    """Three EM iterations with LLE (the main pass's beta and lambda): the
    port's loop (its plain version on the CPU) and the JAX package's XLA
    route take the same trips and land within 1e-6 m."""
    got, ref, _ = _em_both(m)
    assert int(got.iterations) == int(ref.iterations) == 3
    assert np.abs(got.y.numpy() - np.asarray(ref.y)).max() <= 1e-6


@pytest.mark.parametrize("m", [256, 512])
def test_prereg_em_loop_past_128_against_float64(m):
    """The pre-registration pass's staging (``_prereg_staging``: beta 3,
    lambda 1, LLE; cond(A) near 4e6 at 45 nodes, more here): three
    iterations in float32 land 1.3e-5 to 6.3e-5 m from the same loop in
    float64 in both packages (the port's plain loop and the JAX package's
    XLA route), so the two cannot be held within 1e-6 m of each other. The
    port's loop is held no further from float64 than twice the JAX route's
    distance, with the same trips."""
    p = torch_live_params()
    got, ref, kw = _em_both(m, prereg=True)
    y, x, xm = _rope_cloud(m, seed=m)
    st = tc.em_staging(torch.from_numpy(x), torch.from_numpy(xm), torch.from_numpy(y),
                       torch.ones(m, dtype=torch.bool), torch.tensor(p.sigma2_init),
                       tc.CpdParams(**kw))
    y64, _ = hk.fused_em_loop_plain(*(a.double() for a in st.args), **st.kwargs)
    assert int(got.iterations) == int(ref.iterations) == 3
    port = float((got.y.double() - y64).abs().max())
    jax_xla = float(np.abs(np.asarray(ref.y, np.float64) - y64.numpy()).max())
    assert port <= 2.0 * jax_xla, (port, jax_xla)


def _vis_case(m, occluded):
    rng = np.random.default_rng(m + occluded)
    rope = SyntheticRope()
    y = rope.nodes(0.0, m).astype(np.float32)
    pts = rope.curve(1 / 15.0)[rng.integers(0, 400, 230)] + rng.normal(0, 0.002, (230, 3))
    if occluded:
        pts = pts[np.abs(pts[:, 0]) > 0.08]
    x = np.zeros((256, 3), np.float32)
    x[:len(pts)] = pts
    return y, x, np.arange(256) < len(pts)


@pytest.mark.parametrize("occluded", [False, True], ids=["rope", "occluded_middle"])
def test_visibility_past_128_matches_jax(occluded):
    """512 nodes at the 720p camera with a 2 px painter (node spacing ~2.2
    px, over its half-width, so the nodes stay visible): the port's
    visibility and the JAX package's, every mask and index equal, the
    distances within 1e-6 m."""
    from trackdlo_tpu_torch.ops.kernels import geodesic_coords
    from trackdlo_tpu_torch.ops.visibility import compute_visibility

    m, intr, p = 512, CameraIntrinsics(), live_params()
    y, x, xm = _vis_case(m, occluded)
    coord = geodesic_coords(torch.from_numpy(y)).numpy()
    proj = np.array(intr.proj_matrix(), np.float32)
    scal = (intr.height, intr.width, p.visibility_threshold, 2, p.d_vis)
    got = compute_visibility(*(torch.from_numpy(a) for a in (y, x, xm, proj, coord)), *scal)
    ref = jv.compute_visibility(*(jnp.asarray(a) for a in (y, x, xm, proj, coord)), *scal)
    for f in ("visible_mask", "extended_mask", "not_self_occluded", "vis_idx", "vis_ext_idx",
              "vis_count", "vis_ext_count"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)), err_msg=f)
    for f in ("shortest_node_pt_dists", "point_min_sq_all", "point_min_sq_ext"):
        a = np.minimum(getattr(got, f).numpy(), 1.0)
        assert np.abs(a - np.minimum(np.asarray(getattr(ref, f)), 1.0)).max() <= 1e-6, f
    assert 2 < int(got.vis_count) < m


@pytest.mark.parametrize("ext", [(0, 200, 330, 512), (60, 300, 380, 450)],
                         ids=["mid_occluded", "both_ends_occluded"])
def test_walks_past_129_match_jax(ext):
    """The correspondence priors of 512 nodes (four pursuit walks of up to
    511 steps over 511 segments, through kernel W's plain version): the
    occlusion state, alignment and prior masks equal to the JAX package's
    XLA walks, the positions within 5e-6 m."""
    from trackdlo_tpu_torch.ops import priors as tp
    from trackdlo_tpu_torch.ops.kernels import geodesic_coords

    m = 512
    rng = np.random.default_rng(sum(ext))
    rope = SyntheticRope()
    y = rope.nodes(0.0, m).astype(np.float32)
    coord = geodesic_coords(torch.from_numpy(y)).numpy()
    nodes = [*range(ext[0], ext[1]), *range(ext[2], ext[3])]
    idx = np.full(m, m - 1, np.int32)
    idx[:len(nodes)] = nodes
    moved = rope.nodes(1 / 15.0, m) + rng.normal(0, 0.001, (m, 3))
    guides = np.zeros((m, 3), np.float32)
    guides[:len(nodes)] = moved[nodes]
    count = np.int32(len(nodes))
    got = tp.correspondence_priors(*(torch.as_tensor(a) for a in (
        y, coord, guides, idx.astype(np.int64), np.int64(count), idx.astype(np.int64),
        np.int64(count))))
    ref = jpr.correspondence_priors(*(jnp.asarray(a) for a in (y, coord, guides, idx, count,
                                                                 idx, count)))
    assert int(got.state) == int(ref.state)
    assert int(got.alignment_idx) == int(ref.alignment_idx)
    mask = got.prior_mask.numpy()
    np.testing.assert_array_equal(mask, np.asarray(ref.prior_mask))
    assert mask.sum() > m // 2
    assert np.abs(got.prior_pos.numpy() - np.asarray(ref.prior_pos))[mask].max() <= 5e-6


def test_estep_past_16384_rows_matches_jax_kernel():
    """The batched E-step of two streams (45 nodes; one gated) over 20,000
    rows, 12,000 of them valid (a CTA of the card's kernel S takes 2,500
    rows, over its 2,048, so it runs a tile at a time): the port's plain
    version against the JAX package's B7 interpreted, rtol 2e-4 / atol
    1e-6, shortest_sq within the same bounds where defined."""
    from trackdlo_tpu_torch.ops.kernels import masked_geodesic_coords

    m, m_pad, n, n_pad = 45, 48, 20000, 20480
    p = live_params()
    rng = np.random.default_rng(7)
    scal, ys, coords, nms, pvs, xs, xms = [], [], [], [], [], [], []
    for b, gate in enumerate((1.0, 0.0)):
        y = SyntheticRope().nodes(0.01 * b, m).astype(np.float32)
        nm = np.ones(m, np.float32)
        coord = masked_geodesic_coords(torch.from_numpy(y), torch.from_numpy(nm > 0)).numpy()
        x = np.zeros((n, 3), np.float32)
        x[:12000] = (SyntheticRope().curve(1 / 15.0 + 0.01 * b)[rng.integers(0, 400, 12000)]
                     + rng.normal(0, 0.002, (12000, 3)))
        xm = (np.arange(n) < 12000).astype(np.float32)
        pv = rng.random(m).astype(np.float32)
        pv /= pv.sum()
        s2 = np.float32(1e-3 * (1 + b))
        c_base = (2 * np.pi * s2) ** 1.5 * p.mu / (1 - p.mu)
        scal.append([s2, c_base * m / 12000, c_base / 12000, gate, m, p.k_vis,
                     p.visibility_threshold, 0.0])
        for lst, a in zip((ys, coords, nms, pvs, xs, xms), (y, coord, nm, pv, x, xm)):
            lst.append(a)
    args = [np.asarray(a, np.float32) for a in (scal, ys, coords, nms, pvs, xs, xms)]
    got = hk.fused_estep_packed_batch_plain(*(torch.from_numpy(a) for a in args), two_phase=True)
    scal_a, y_a, coord_a, nm_a, pv_a, x_a, xm_a = args

    def rows(a, fill=0.0):
        out = np.full(a.shape[:-1] + (m_pad,), fill, np.float32)
        out[..., :m] = a
        return out[..., None]

    yp = np.zeros((2, m_pad, 3), np.float32)
    yp[:, :m] = y_a
    xt = np.zeros((2, 3, n_pad), np.float32)
    xt[:, :, :n] = x_a.transpose(0, 2, 1)
    xmp = np.zeros((2, 1, n_pad), np.float32)
    xmp[:, 0, :n] = xm_a
    ref = jpk.fused_estep_packed_batch(
        *(jnp.asarray(a) for a in (np.broadcast_to(scal_a[:, :, None], (2, 8, 128)), yp,
                                   rows(coord_a), rows(nm_a), rows(pv_a, 1.0), xt, xmp)),
        two_phase=True, interpret=True)
    want = (np.asarray(ref[0])[:, :m, 0], np.asarray(ref[1])[:, :m], np.asarray(ref[2])[:, 0],
            np.asarray(ref[3])[:, :m, 0])
    for g, w, what in zip(got, want, ("p1", "px", "stats", "shortest_sq")):
        np.testing.assert_allclose(g.numpy(), w, rtol=2e-4, atol=1e-6, err_msg=what)
    assert float(got[0].sum()) > 0


# Per frame from one state at a 320x240 camera (fx 240) with a 2 px painter:
# node spacing ~2.3 px at 129 nodes and ~1.16 px at 256, over the painter's
# half-width, so visibility keeps the nodes (at the small camera of
# test_step_past_the_kernel_range_matches_jax it would keep at most 2 and the
# JAX package's own two routes differ, ROADMAP §C).
MID = CameraIntrinsics(fx=240.0, fy=240.0, cx=160.0, cy=120.0, width=320, height=240)
MID_KW = dict(max_points=512, dlo_pixel_width=2)


@pytest.mark.parametrize("m", [129, 256])
def test_step_past_the_wide_builds_matches_jax(m):
    """Four frames, the second and third occluded, each from the JAX step's
    state: the port's step at 129 and 256 nodes (the node-unbounded builds'
    counts on the card) against the JAX package's TPU route (its Pallas
    kernels interpreted, the kernels the port's replace: the same cloud and
    the same visible nodes) and its XLA route (whose cloud can differ by a
    voxel-boundary point or two). On every frame the port lands within the
    open-loop bound of one of the two routes: on frame 3 at 129 nodes the
    TPU route takes one more main-pass trip and the two routes land 0.90 mm
    apart, the port 0.17 mm from the XLA route (my CPU run)."""
    import jax.numpy as jnp

    from trackdlo_tpu.models.trackdlo import Tracker as JaxTracker

    rope = SyntheticRope()
    routes = [JaxTracker(live_params(num_of_nodes=m, use_pallas_estep=tpu, **MID_KW), MID)
              for tpu in (True, False)]
    tt = Tracker(torch_live_params(num_of_nodes=m, **MID_KW), MID, device="cpu")
    js = routes[0].init_from_nodes(rope.nodes(0.0, m))
    copy = lambda st: type(st)(*(jnp.array(np.asarray(a)) for a in st))
    visible = []
    for i in range(1, 5):
        rgb, depth = render_frame(rope, i / 15.0, MID, rope_pixel_radius=3)
        occ = _occlusion(MID, i)
        ts = state_from_numpy(np.asarray(js.y), np.asarray(js.sigma2),
                              np.asarray(js.geodesic_coord), device="cpu")
        (js, jo), (xs, _) = (r.step(copy(js), rgb, depth, occ) for r in routes)
        ts, to = tt.step(ts, rgb, depth, occ)
        assert ts.y.shape == (m, 3)
        assert int(to.n_points) == int(jo.n_points)
        assert int(to.occlusion_state) == int(jo.occlusion_state)
        flips = (to.visible_mask.numpy() != np.asarray(jo.visible_mask)).sum()
        assert flips <= 1, (i, flips)
        visible.append(int(to.visible_mask.sum()))
        apart = min(np.abs(ts.y.numpy() - np.asarray(r.y)).max() for r in (js, xs))
        assert apart <= STEP_TOL_M, i
    assert min(visible) > 2, visible
