"""The port's five CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs an NVIDIA GPU and nvcc, and skips without them.

The file imports no JAX, so it runs on a GPU machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``--noconftest``: the repository's conftest pins JAX to the CPU.)"""

import numpy as np
import pytest
import torch

from trackdlo_tpu_torch.config import CameraIntrinsics, live_params
from trackdlo_tpu_torch.io.sequence import SyntheticRope, render_frame
from trackdlo_tpu_torch import _build
from trackdlo_tpu_torch.ops import priors as tp
from trackdlo_tpu_torch.ops.cpd_lle import CpdParams, em_staging
from trackdlo_tpu_torch.ops.hopper_kernels import (
    fused_em_loop,
    fused_em_loop_plain,
    pursuit_walks,
    pursuit_walks_plain,
)
from trackdlo_tpu_torch.ops.kernels import geodesic_coords
from trackdlo_tpu_torch.ops.preprocess import (
    cell_sums_plain,
    compact_channels,
    compact_channels_plain,
    compact_parity_channels,
    default_cell_px,
    kept_cells,
)
from trackdlo_tpu_torch.ops.preprocess_kernel import cell_sums
from trackdlo_tpu_torch.ops.visibility import compute_visibility
from trackdlo_tpu_torch.ops.visibility_kernel import fused_visibility

pytestmark = pytest.mark.cuda

M = 45
PARAMS = live_params()
LIVE = CameraIntrinsics()
QUARTER = CameraIntrinsics(fx=LIVE.fx / 4, fy=LIVE.fy / 4, cx=LIVE.cx / 4, cy=LIVE.cy / 4,
                           width=LIVE.width // 4, height=LIVE.height // 4)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels run only on the card")
    _build.lib()
    return torch.device("cuda")


def _frame(intr, occluded, dev, radius):
    rgb, depth = render_frame(SyntheticRope(), 1 / 15.0, intr, rope_pixel_radius=radius)
    occ = np.ones((intr.height, intr.width), bool)
    if occluded:
        occ[:, int(0.39 * intr.width):int(0.625 * intr.width)] = False
    return (torch.from_numpy(rgb).to(dev), torch.from_numpy(depth.view(np.int16)).to(dev),
            torch.from_numpy(occ).to(dev))


def _p_args(intr, occluded, dev, radius=9):
    cell = default_cell_px(PARAMS.downsample_leaf_size, intr.fx)
    return (*_frame(intr, occluded, dev, radius), intr.fx, intr.fy, intr.cx, intr.cy,
            PARAMS.hsv_lower, PARAMS.hsv_upper, PARAMS.multi_color_dlo, cell,
            PARAMS.downsample_leaf_size)


def _cloud(dev, occluded=False):
    sums = cell_sums_plain(*_p_args(LIVE, occluded, dev))
    return compact_parity_channels(*sums, PARAMS.max_points, PARAMS.downsample_leaf_size,
                                   PARAMS.candidate_cap(), inputs_are_sums=True)


@pytest.mark.parametrize("intr,occluded", [(LIVE, False), (LIVE, True), (QUARTER, True)])
def test_cell_sums_kernel_matches_plain(cuda, intr, occluded):
    args = _p_args(intr, occluded, cuda, radius=9 if intr is LIVE else 3)
    got = cell_sums(*args)
    torch.cuda.synchronize()
    ref = cell_sums_plain(*args)
    assert torch.equal(got[3], ref[3])  # count_delta 0 in every cell and channel
    assert float(ref[3].sum()) > 0
    for g, r in zip(got[:3], ref[:3]):
        # Sums of up to 121 coordinates below 1 m, added in another order: a
        # few float32 ulps of each sum.
        torch.testing.assert_close(g, r, rtol=2e-6, atol=2e-6)


def test_cell_sums_parity_over_every_u16_depth(cuda):
    """One pixel per cell over all 65536 depths: the kernel's parity channel
    equals the plain version's, and z's parity the integer floor's."""
    side = 256
    depth = torch.arange(65536, dtype=torch.int32).to(torch.int16).reshape(side, side).to(cuda)
    rgb = torch.tensor([30, 60, 200], dtype=torch.uint8).expand(side, side, 3).contiguous().to(cuda)
    occ = torch.ones((side, side), dtype=torch.bool, device=cuda)
    args = (rgb, depth, occ, LIVE.fx, LIVE.fy, 128.5, 127.25, PARAMS.hsv_lower, PARAMS.hsv_upper,
            False, 1, PARAMS.downsample_leaf_size)
    cnt_k, cnt_p = cell_sums(*args)[3], cell_sums_plain(*args)[3]
    assert torch.equal(cnt_k, cnt_p)
    have = cnt_k.sum(0) > 0
    assert bool(have[1:].all())  # every depth but 0 is kept
    ch = cnt_k.argmax(0).cpu().numpy()
    truth_z = (np.arange(65536) // 8) & 1
    assert np.array_equal((ch & 1)[1:], truth_z[1:])


@pytest.mark.parametrize("intr,occluded,cap_per", [(LIVE, False, None), (LIVE, True, None),
                                                   (QUARTER, True, None), (LIVE, False, 16)])
def test_compact_kernel_matches_plain(cuda, intr, occluded, cap_per):
    """Every output bit-equal: each valid slot is a copy of one cell.
    ``cap_per=16`` thins an overflow and leaves kept cells beyond the slots."""
    sums = cell_sums(*_p_args(intr, occluded, cuda, radius=9 if intr is LIVE else 3))
    cap_per = cap_per or PARAMS.candidate_cap() // 8
    kept = kept_cells(sums[3], cap_per)
    got = compact_channels(*sums, kept, cap_per)
    torch.cuda.synchronize()
    ref = compact_channels_plain(*sums, kept, cap_per)
    assert int(ref[2].sum()) > 0
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def _self_occluding_chain():
    xs_far = np.linspace(-0.2, 0.2, 22)
    xs_near = np.linspace(0.2, -0.2, M - 22) * 0.6 / 0.75
    far = np.stack([xs_far, np.zeros(22), np.full(22, 0.75)], 1)
    near = np.stack([xs_near, np.zeros(M - 22), np.full(M - 22, 0.6)], 1)
    return np.concatenate([far, near]).astype(np.float32)


@pytest.mark.parametrize("case", ["rope", "rope_occluded", "self_occluding", "empty", "far"])
def test_visibility_kernel_matches_plain(cuda, case):
    y = SyntheticRope().nodes(0.0, M).astype(np.float32)
    pc = _cloud(cuda, occluded=case == "rope_occluded")
    x, xm = pc.points, pc.mask
    if case == "self_occluding":
        y = _self_occluding_chain()
    elif case == "empty":
        xm = torch.zeros_like(xm)
    elif case == "far":
        x = torch.full_like(x, 5.0)
        xm = torch.ones_like(xm)
    y = torch.from_numpy(y).to(cuda)
    proj = torch.tensor(np.array(LIVE.proj_matrix(), np.float32), device=cuda)
    args = (y, x.contiguous(), xm.contiguous(), proj, geodesic_coords(y), LIVE.height, LIVE.width,
            PARAMS.visibility_threshold, PARAMS.dlo_pixel_width, PARAMS.d_vis)
    got = fused_visibility(*args)
    torch.cuda.synchronize()
    ref = compute_visibility(*args)
    for f in ("visible_mask", "extended_mask", "not_self_occluded", "vis_idx", "vis_ext_idx",
              "vis_count", "vis_ext_count"):
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
    for f in ("shortest_node_pt_dists", "point_min_sq_all", "point_min_sq_ext"):
        assert float((getattr(got, f) - getattr(ref, f)).abs().max()) <= 1e-6, f


WALK_CASES = {
    "all_visible": range(M),
    "mid_occluded": [*range(0, 15), *range(30, M)],
    "tail_occluded": range(0, 35),
    "head_occluded": range(10, M),
    "both_ends_occluded": range(10, 35),
    "single_node": [20],
    "no_visible_nodes": [],
}


@pytest.mark.parametrize("case", sorted(WALK_CASES))
def test_walks_kernel_matches_plain(cuda, case):
    vis = list(WALK_CASES[case])
    rope = SyntheticRope()
    y = torch.from_numpy(rope.nodes(0.0, M).astype(np.float32)).to(cuda)
    moved = torch.from_numpy(rope.nodes(1 / 15.0, M).astype(np.float32)).to(cuda)
    idx = torch.full((M,), M - 1, dtype=torch.int64, device=cuda)
    idx[: len(vis)] = torch.tensor(vis, dtype=torch.int64, device=cuda)
    cnt = torch.tensor(len(vis), device=cuda)
    guides = torch.zeros_like(y)
    guides[: len(vis)] = moved[idx[: len(vis)]]
    wi = tp.walk_inputs(y, geodesic_coords(y), guides, idx, cnt, idx, cnt)
    pk, vk = pursuit_walks(wi.guides, wi.seglens, wi.ints)
    torch.cuda.synchronize()
    pp, vp = pursuit_walks_plain(wi.guides, wi.seglens, wi.ints)
    assert torch.equal(vk, vp)
    if bool(vk.any()):
        assert float((pk - pp).abs()[vk].max()) <= 5e-6


def _em_params(**kw):
    base = dict(beta=PARAMS.beta, lam=PARAMS.lam, lle_weight=PARAMS.lle_weight, mu=PARAMS.mu,
                max_iter=3, tol=0.0, include_lle=False, k_vis=PARAMS.k_vis,
                visibility_threshold=PARAMS.visibility_threshold, use_visibility=True)
    base.update(kw)
    return CpdParams(**base)


PREREG = {"include_lle": True, "beta": PARAMS.beta_pre_proc, "lam": PARAMS.lambda_pre_proc,
          "use_visibility": False}
# name: (CpdParams changes, valid nodes, priors on, empty cloud, bound in m)
EM_CASES = {
    "plain": ({}, M, False, False, 1e-6),
    "lle": ({"include_lle": True}, M, False, False, 1e-6),
    "priors_gate": ({"use_priors": True, "alpha": PARAMS.alpha}, M, True, False, 1e-6),
    # cond(A) near 4e6: the JAX package's own two routes differ by 1.7e-5 m.
    "prereg": (PREREG, 30, False, False, 5e-5),
    "prereg_v1": (PREREG, 1, False, False, 5e-5),
    "prereg_v2": (PREREG, 2, False, False, 5e-5),
    "prereg_v3": (PREREG, 3, False, False, 5e-5),
    "empty_cloud": ({}, M, False, True, 0.0),
}


@pytest.mark.parametrize("case", sorted(EM_CASES))
def test_em_loop_kernel_matches_plain(cuda, case):
    extra, valid, priors, empty, tol = EM_CASES[case]
    pc = _cloud(cuda)
    xm = torch.zeros_like(pc.mask) if empty else pc.mask
    nodes = torch.from_numpy(SyntheticRope().nodes(0.0, M).astype(np.float32)).to(cuda)
    nm = torch.arange(M, device=cuda) < valid
    nodes = torch.where(nm[:, None], nodes, 0.0)
    kw = dict(visible_count=torch.tensor(30, device=cuda))
    if priors:
        kw.update(prior_pos=nodes + 0.004, prior_mask=torch.arange(M, device=cuda) < 12)
    st = em_staging(pc.points, xm, nodes, nm, torch.tensor(PARAMS.sigma2_init, device=cuda),
                    _em_params(**extra), **kw)
    yk, sk = fused_em_loop(*st.args, **st.kwargs)
    torch.cuda.synchronize()
    yp, sp = fused_em_loop_plain(*st.args, **st.kwargs)
    assert int(sk[1]) == int(sp[1])
    assert bool(sk[2]) == bool(sp[2])
    assert float((yk - yp).abs()[nm].max()) <= tol


# ---------------------------------------------------------------------------
# The batched slice: kernels S (B6/B7) and G (B8), and P, C, V, W batched.
# ---------------------------------------------------------------------------


def _batch_frames(dev, n, occluded_odd=True):
    frames = [render_frame(SyntheticRope(), 1 / 15.0 + 0.01 * b, LIVE) for b in range(n)]
    occ = np.ones((n, LIVE.height, LIVE.width), bool)
    if occluded_odd:
        occ[1::2, :, 500:800] = False
    rgb = torch.from_numpy(np.stack([f[0] for f in frames])).to(dev)
    depth = torch.from_numpy(np.stack([f[1] for f in frames]).view(np.int16)).to(dev)
    return rgb, depth, torch.from_numpy(occ).to(dev)


def _batch_sums(dev, n):
    cell = default_cell_px(PARAMS.downsample_leaf_size, LIVE.fx)
    return cell_sums(*_batch_frames(dev, n), LIVE.fx, LIVE.fy, LIVE.cx, LIVE.cy, PARAMS.hsv_lower,
                     PARAMS.hsv_upper, PARAMS.multi_color_dlo, cell, PARAMS.downsample_leaf_size)


def test_batched_cell_sums_equal_single_launches(cuda):
    """One launch for 4 frames: bit-equal to 4 single-frame launches."""
    rgb, depth, occ = _batch_frames(cuda, 4)
    cell = default_cell_px(PARAMS.downsample_leaf_size, LIVE.fx)
    rest = (LIVE.fx, LIVE.fy, LIVE.cx, LIVE.cy, PARAMS.hsv_lower, PARAMS.hsv_upper,
            PARAMS.multi_color_dlo, cell, PARAMS.downsample_leaf_size)
    got = cell_sums(rgb, depth, occ, *rest)
    for b in range(4):
        one = cell_sums(rgb[b], depth[b], occ[b], *rest)
        for g, o in zip(got, one):
            assert torch.equal(g[b], o)
    ref = cell_sums_plain(rgb, depth, occ, *rest)
    assert torch.equal(got[3], ref[3])


def test_batched_compaction_matches_plain(cuda):
    """B·8 channel rows in one launch of kernel C, bit-equal to the sort."""
    sums = _batch_sums(cuda, 4)
    rows = tuple(s.reshape(-1, s.shape[-1]) for s in sums)
    cap_per = PARAMS.candidate_cap() // 8
    kept = kept_cells(rows[3], cap_per)
    got = compact_channels(*rows, kept, cap_per)
    ref = compact_channels_plain(*rows, kept, cap_per)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    pc = compact_parity_channels(*sums, PARAMS.max_points, PARAMS.downsample_leaf_size,
                                 PARAMS.candidate_cap(), inputs_are_sums=True)
    for b in range(4):
        one = compact_parity_channels(*(s[b] for s in sums), PARAMS.max_points,
                                      PARAMS.downsample_leaf_size, PARAMS.candidate_cap(),
                                      inputs_are_sums=True)
        assert torch.equal(pc.points[b], one.points) and torch.equal(pc.mask[b], one.mask)


def _batch_cloud(dev, n):
    sums = _batch_sums(dev, n)
    return compact_parity_channels(*sums, PARAMS.max_points, PARAMS.downsample_leaf_size,
                                   PARAMS.candidate_cap(), inputs_are_sums=True)


def test_batched_visibility_kernel_matches_plain(cuda):
    pc = _batch_cloud(cuda, 4)
    y = torch.stack([torch.from_numpy(SyntheticRope().nodes(0.01 * b, M).astype(np.float32))
                     for b in range(4)]).to(cuda)
    proj = torch.tensor(np.array(LIVE.proj_matrix(), np.float32), device=cuda)
    args = (y, pc.points, pc.mask, proj, geodesic_coords(y), LIVE.height, LIVE.width,
            PARAMS.visibility_threshold, PARAMS.dlo_pixel_width, PARAMS.d_vis)
    got = fused_visibility(*args)
    ref = compute_visibility(*args)
    for f in ("visible_mask", "extended_mask", "not_self_occluded", "vis_idx", "vis_ext_idx",
              "vis_count", "vis_ext_count"):
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
    for f in ("shortest_node_pt_dists", "point_min_sq_all", "point_min_sq_ext"):
        assert float((getattr(got, f) - getattr(ref, f)).abs().max()) <= 1e-6, f
    assert len(set(got.vis_count.tolist())) >= 2


def test_batched_priors_pack_walks_into_one_launch(cuda):
    """4·B walks in one launch of kernel W, equal to B single-stream calls."""
    rope = SyntheticRope()
    cases = [WALK_CASES[k] for k in ("all_visible", "mid_occluded", "tail_occluded", "head_occluded")]
    ys, coords, guides, idxs, cnts = [], [], [], [], []
    for b, vis in enumerate(cases):
        vis = list(vis)
        y = torch.from_numpy(rope.nodes(0.01 * b, M).astype(np.float32)).to(cuda)
        moved = torch.from_numpy(rope.nodes(1 / 15.0 + 0.01 * b, M).astype(np.float32)).to(cuda)
        idx = torch.full((M,), M - 1, dtype=torch.int64, device=cuda)
        idx[: len(vis)] = torch.tensor(vis, dtype=torch.int64, device=cuda)
        g = torch.zeros_like(y)
        g[: len(vis)] = moved[idx[: len(vis)]]
        ys.append(y), coords.append(geodesic_coords(y)), guides.append(g), idxs.append(idx)
        cnts.append(torch.tensor(len(vis), device=cuda))
    st = lambda a: torch.stack(a)
    before = _build.launch_counts["walks"]
    got = tp.correspondence_priors(st(ys), st(coords), st(guides), st(idxs), st(cnts), st(idxs), st(cnts))
    assert _build.launch_counts["walks"] == before + 1
    for b in range(4):
        one = tp.correspondence_priors(ys[b], coords[b], guides[b], idxs[b], cnts[b], idxs[b], cnts[b])
        assert torch.equal(got.prior_mask[b], one.prior_mask) and int(got.state[b]) == int(one.state)
        assert torch.equal(got.prior_pos[b], one.prior_pos)


def _estep_args(dev, n=8):
    from trackdlo_tpu_torch.ops.cpd_lle import estep_scalars

    pc = _batch_cloud(dev, n)
    y = torch.stack([torch.from_numpy(SyntheticRope().nodes(0.01 * b, M).astype(np.float32))
                     for b in range(n)]).to(dev)
    nm = torch.ones((n, M), dtype=torch.bool, device=dev)
    nm[-1, 3:] = False
    nm[-2, 2:] = False
    y = torch.where(nm[..., None], y, 0.0)
    vc = torch.tensor([30 if b % 2 == 0 else M for b in range(n)], device=dev)
    params = _em_params()
    s2 = torch.linspace(5e-4, 2e-3, n, device=dev)
    st = em_staging(pc.points, pc.mask, y, nm, s2, params, visible_count=vc)
    scal = estep_scalars(st.args[0], s2, params)
    pv = torch.rand(st.args[3].shape, generator=torch.Generator().manual_seed(0)).to(dev) * st.args[3]
    pv = pv / pv.sum(dim=1, keepdim=True)
    return scal, y, st.args[2], st.args[3], pv, st.args[9], st.args[10]


def _assert_estep_close(got, ref, short_exact=True):
    for g, r in zip(got[:3], ref[:3]):
        torch.testing.assert_close(g, r, rtol=2e-4, atol=1e-6)
    if short_exact:
        assert torch.equal(got[3], ref[3])


@pytest.mark.parametrize("two_phase", [True, False])
@pytest.mark.parametrize("gates", ["mixed", "all_off"])
def test_estep_batch_kernel_matches_plain(cuda, two_phase, gates):
    from trackdlo_tpu_torch.ops.hopper_kernels import (
        fused_estep_packed_batch,
        fused_estep_packed_batch_plain,
    )

    args = list(_estep_args(cuda))
    if gates == "all_off":
        args[0] = args[0].clone()
        args[0][:, 3] = 0.0
    else:
        assert 0 < int((args[0][:, 3] > 0).sum()) < args[0].shape[0]
    got = fused_estep_packed_batch(*args, two_phase=two_phase)
    torch.cuda.synchronize()
    ref = fused_estep_packed_batch_plain(*args, two_phase=two_phase)
    _assert_estep_close(got, ref)
    if not two_phase or gates == "all_off":
        assert bool((got[3] == 1e5).all())


@pytest.mark.parametrize("stream", [0, 1, 7])
def test_estep_single_kernel_matches_plain(cuda, stream):
    from trackdlo_tpu_torch.ops.hopper_kernels import fused_estep_packed, fused_estep_packed_plain

    one = tuple(a[stream] for a in _estep_args(cuda))
    for two_phase in (True, False):
        got = fused_estep_packed(*one, two_phase=two_phase)
        torch.cuda.synchronize()
        _assert_estep_close(got, fused_estep_packed_plain(*one, two_phase=two_phase))


def test_gj_kernel_matches_float64_and_plain(cuda):
    from trackdlo_tpu_torch.ops.hopper_kernels import (
        gauss_jordan_solve_batched,
        gauss_jordan_solve_batched_plain,
    )

    rng = np.random.default_rng(0)
    a = rng.standard_normal((8, 48, 48)).astype(np.float32)
    a = a @ a.transpose(0, 2, 1) + 48 * np.eye(48, dtype=np.float32)
    b = rng.standard_normal((8, 48, 3)).astype(np.float32)
    w64 = np.linalg.solve(a.astype(np.float64), b.astype(np.float64))
    at, bt = torch.from_numpy(a).to(cuda), torch.from_numpy(b).to(cuda)
    got = gauss_jordan_solve_batched(at, bt)
    torch.cuda.synchronize()
    assert np.abs(got.cpu().numpy() - w64).max() <= 2e-8  # gj_solve_vs_f64_max
    assert float((got - gauss_jordan_solve_batched_plain(at, bt)).abs().max()) <= 4e-8


def test_gj_kernel_pivots(cuda):
    """Rows permuted so the diagonal is zero: the elimination must pivot."""
    from trackdlo_tpu_torch.ops.hopper_kernels import gauss_jordan_solve_batched

    rng = np.random.default_rng(1)
    a = rng.standard_normal((4, 45, 45)).astype(np.float32) + 8 * np.eye(45, dtype=np.float32)
    a = np.ascontiguousarray(a[:, rng.permutation(45)])
    a[:, np.arange(45), np.arange(45)] = 0.0
    b = rng.standard_normal((4, 45, 3)).astype(np.float32)
    w64 = np.linalg.solve(a.astype(np.float64), b.astype(np.float64))
    got = gauss_jordan_solve_batched(torch.from_numpy(a).to(cuda), torch.from_numpy(b).to(cuda))
    assert np.abs(got.cpu().numpy() - w64).max() <= 1e-5 * np.abs(w64).max()


def test_batched_em_matches_single_stream_kernel(cuda):
    """em10_batched_vs_single_max_m: 4 copies of one stream through kernels
    S and G against kernel E on that stream, 10 iterations, tol 0."""
    from trackdlo_tpu_torch.ops.cpd_lle import cpd_lle, cpd_lle_batched

    pc = _cloud(cuda)
    nodes = torch.from_numpy(SyntheticRope().nodes(0.0, M).astype(np.float32)).to(cuda)
    nm = torch.ones(M, dtype=torch.bool, device=cuda)
    params = _em_params(max_iter=10)
    s2, vc = torch.tensor(0.001, device=cuda), torch.tensor(30, device=cuda)
    single = cpd_lle(pc.points, pc.mask, nodes, nm, s2, params, visible_count=vc)
    rep = lambda t: t.unsqueeze(0).expand(4, *t.shape).contiguous()
    before = dict(_build.launch_counts)
    batched = cpd_lle_batched(rep(pc.points), rep(pc.mask), rep(nodes), rep(nm), rep(s2), params,
                              visible_count=rep(vc))
    assert _build.launch_counts["estep_batch"] - before["estep_batch"] == 10
    assert _build.launch_counts["gj_solve"] - before["gj_solve"] == 10
    assert float((batched.y - single.y[None]).abs().max()) <= 2e-6
