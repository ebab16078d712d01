"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs an NVIDIA GPU and nvcc, and skips without them.

The file imports no JAX, so it runs on a GPU machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``--noconftest``: the repository's conftest pins JAX to the CPU.)"""

import re

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
    compact_occupied_channels,
    compact_occupied_channels_plain,
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


@pytest.mark.parametrize("case", ["live", "live_b4", "quarter", "quarter_b4", "odd", "odd_b4",
                                  "big", "big_b4"])
def test_cell_sums_equal_the_previous_design_bit_for_bit(cuda, case):
    """Kernel P in its three modes, for one frame and a batch of 4 streams,
    at the live, quarter and an odd size (313 x 177: rows that are no
    multiple of 16 bytes, staged byte by byte), and with cells of 110 pixels
    (too large to stage their pixels' values), against the outputs of the
    design before the strip-staged one (tests/data/preprocess_bits.npz,
    written by perf/preprocess_bits.py, whose ``cases`` renders the same
    frames): every sum bit for bit."""
    import importlib.util
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("preprocess_bits", root / "perf" / "preprocess_bits.py")
    pb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pb)
    saved = np.load(root / "tests" / "data" / "preprocess_bits.npz")
    frame, rest = pb.cases(torch, cuda)[case]
    for mode, outs in pb.run_modes(cell_sums, frame, rest).items():
        assert len(outs) == (7 if mode == "votes" else 4)
        for i, o in enumerate(outs):
            want = saved[f"{case}_{mode}_{i}"]
            got = o.cpu().numpy()
            assert got.shape == want.shape, (mode, i)
            assert np.array_equal(got.view(np.int32), want.view(np.int32)), (case, mode, i)
        assert float(outs[3].sum()) > 0


# (intrinsics, occluded, voxel leaf, slots per channel, whether the thinning fires)
OCCUPIED_CASES = {
    "live": (LIVE, False, PARAMS.downsample_leaf_size, None, False),
    "live_occluded": (LIVE, True, PARAMS.downsample_leaf_size, None, False),
    "quarter_cap16": (QUARTER, True, PARAMS.downsample_leaf_size, 16, True),
    "live_leaf5mm": (LIVE, False, 0.005, None, True),
}


@pytest.mark.parametrize("case", sorted(OCCUPIED_CASES))
def test_occupied_compaction_matches_plain(cuda, case):
    """Kernel C's derived mode (the kept cells by the even-stride thinning,
    the pack and, for sums, the centroid division, in one launch) against
    its plain composition, with and without the division: every output
    bit-equal. Two cases thin an overflow: 16 slots at the quarter size, and
    the 5 mm leaf at 720p (cell_px 7, 18,849 cells a channel, three chunks a
    CTA) with the live 256 slots."""
    intr, occluded, leaf, cap_per, thins = OCCUPIED_CASES[case]
    args = _p_args(intr, occluded, cuda, radius=9 if intr is LIVE else 3)
    args = args[:-2] + (default_cell_px(leaf, intr.fx), leaf)
    sums = cell_sums(*args)
    cap_per = cap_per or PARAMS.candidate_cap() // 8
    assert (int((sums[3] > 0).sum(1).max()) > cap_per) == thins
    for div in (False, True):
        before = _build.launch_counts["compact"]
        got = compact_occupied_channels(*sums, cap_per, div)
        torch.cuda.synchronize()
        assert _build.launch_counts["compact"] == before + 1
        ref = compact_occupied_channels_plain(*sums, cap_per, div)
        assert int(ref[2].sum()) > 0
        for g, r in zip(got, ref):
            assert g.dtype == r.dtype and g.shape == r.shape
            assert torch.equal(g.view(torch.int32) if g.is_floating_point() else g,
                               r.view(torch.int32) if r.is_floating_point() else r)


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


def _cluster_layout(dev, layout):
    """The live cloud (8 channel blocks of 256 rows, valid rows at each
    block's front) rearranged for one of kernel E's cluster layouts."""
    pc = _cloud(dev)
    x, xm = pc.points, pc.mask
    valid = torch.nonzero(xm).flatten()
    if layout == "last_block":  # every valid row in the last CTA's range
        n = x.shape[0]
        keep = valid[:256]
        x2 = torch.zeros_like(x)
        x2[n - len(keep):] = x[keep]
        xm = torch.zeros_like(xm)
        xm[n - len(keep):] = True
        x = x2
    elif layout == "one_point":
        xm = torch.zeros_like(xm)
        xm[valid[5]] = True
    elif layout.startswith("rows_"):  # n not a multiple of the CTA row range
        n = int(layout[5:])
        x, xm = x[:n].contiguous(), xm[:n].contiguous()
    return x, xm


@pytest.mark.parametrize("layout", ["live", "last_block", "one_point", "rows_2001", "rows_700"])
def test_em_loop_cluster_layouts(cuda, layout):
    """Kernel E's cluster against its plain version (3 iterations, tol 0,
    the main pass's configuration with the gate on): equal iterations and
    y within 1e-6 m, whatever the CTAs' ranges hold. One valid point runs 2
    iterations: its σ² falls to 1.5e-5 after the second and 1.5e-6 after the
    third (one point's trace cancels), and after three the plain version in
    float32 is itself 1.4e-6 m from float64 and moves 4.3e-6 m under a 1e-7
    m nudge of the point (perf/port_em_probes.py one-point)."""
    from trackdlo_tpu_torch.ops.hopper_kernels import cluster_shape

    x, xm = _cluster_layout(cuda, layout)
    c, rows = cluster_shape(x.shape[0])
    if layout == "live":
        assert (c, rows) == (8, 256)
    if layout.startswith("rows_"):
        assert x.shape[0] % rows != 0  # the last CTA's range is shorter
    nodes = torch.from_numpy(SyntheticRope().nodes(0.0, M).astype(np.float32)).to(cuda)
    nm = torch.ones(M, dtype=torch.bool, device=cuda)
    iters = 2 if layout == "one_point" else 3
    st = em_staging(x, xm, nodes, nm, torch.tensor(PARAMS.sigma2_init, device=cuda),
                    _em_params(max_iter=iters), visible_count=torch.tensor(30, device=cuda))
    assert bool(st.args[0][3] > 0) and int(st.n_count) > 0
    yk, sk = fused_em_loop(*st.args, **st.kwargs)
    torch.cuda.synchronize()
    yp, sp = fused_em_loop_plain(*st.args, **st.kwargs)
    assert int(sk[1]) == int(sp[1]) == iters
    assert float((yk - yp).abs().max()) <= 1e-6


def test_cluster_shape_is_the_launch(cuda):
    """The cluster size and rows per CTA that kernels E, S and F launch with
    are cluster_shape's, a function of n alone (and past 128 nodes, of the
    unbounded builds' 8 CTAs); the card holds the 16 clusters of a lockstep
    batch of 16 live streams at once."""
    from trackdlo_tpu_torch.ops.hopper_kernels import cluster_info, cluster_shape

    for kernel in ("em_loop", "estep", "em_iter"):
        for m in (45, 128, 129, 256, 1024):
            for n in (0, 1, 700, 1024, 2000, 2048, 4096, 16384, 16385, 65536):
                got = cluster_info(kernel, n, m)
                assert (got["cluster_size"], got["rows_per_cta"]) == cluster_shape(n, m)
                assert got["max_active_clusters"] >= 1
                assert got["smem_bytes"] <= 227 * 1024
    assert cluster_info("estep", 2048)["max_active_clusters"] >= 16


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


@pytest.mark.parametrize("two_phase", [True, False])
def test_estep_stream_bits_do_not_depend_on_the_batch(cuda, two_phase):
    """Each stream of a batch of 16 gives the same bits launched alone and
    in a batch of 8 (one cluster per stream, its shape a function of n
    alone). shortest_sq is compared where the batches agree on the sweep:
    it runs for every stream when any stream's gate is on."""
    from trackdlo_tpu_torch.ops.hopper_kernels import fused_estep_packed, fused_estep_packed_batch

    args = _estep_args(cuda, n=16)
    gates = args[0][:, 3] > 0
    assert 0 < int(gates.sum()) < 16
    b16 = fused_estep_packed_batch(*args, two_phase=two_phase)
    halves = [fused_estep_packed_batch(*(a[h * 8:(h + 1) * 8] for a in args), two_phase=two_phase)
              for h in (0, 1)]
    for s in range(16):
        alone = fused_estep_packed(*(a[s] for a in args), two_phase=two_phase)
        b8 = tuple(o[s % 8] for o in halves[s // 8])
        for k in range(3):  # p1, px, stats
            assert torch.equal(b16[k][s], alone[k]) and torch.equal(b16[k][s], b8[k]), (s, k)
        assert torch.equal(b16[3][s], b8[3])  # every batch here has a gate on
        if not two_phase or bool(gates[s]):
            assert torch.equal(b16[3][s], alone[3])


def _pins():
    """Kernel G's and the 30-frame loop's outputs since the M-step's products
    follow B1's _exact_dot (ROADMAP §C fault 1), saved on the card by
    chip_smoke.py: G on the (16, 48, 48) SPD systems and on the saved live
    system, the loop's final nodes and every pass's trips."""
    from pathlib import Path

    return np.load(Path(__file__).parent / "data" / "exact_products_bits.npz")


def test_gj_kernel_on_live_prereg_system_equals_saved_solution(cuda):
    """The live cond-2.4e6 pre-registration system saved by chip_smoke.py
    (tests/data/gj_prereg_system.npz): the solve gives exactly the solution
    saved for the current design (only entries that are read again are
    updated; each update is the same multiply then subtract)."""
    from pathlib import Path

    from trackdlo_tpu_torch.ops.hopper_kernels import gauss_jordan_solve_batched

    d = np.load(Path(__file__).parent / "data" / "gj_prereg_system.npz")
    a = torch.from_numpy(d["a"]).to(cuda)[None]
    b = torch.from_numpy(d["b"]).to(cuda)[None]
    got = gauss_jordan_solve_batched(a, b)[0].cpu().numpy()
    assert np.array_equal(got, _pins()["gj_saved_live"])


def _parent_bits():
    """Outputs of the solve's design before its redesign and before fault 1's
    repair, saved on the card by chip_smoke.py
    (chiprun_out/solve_bits.npz): kernel G on the (16, 48, 48) SPD systems
    and on the saved live system, the 30-frame closed loop's final nodes and
    EM trips."""
    from pathlib import Path

    return np.load(Path(__file__).parent / "data" / "solve_bits.npz")


def _spd_systems(dev):
    """chip_smoke.py's (8, 48, 48) SPD systems (seed 0), twice: (16, 48, 48)."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((8, 48, 48)).astype(np.float32)
    a = a @ a.transpose(0, 2, 1) + 48 * np.eye(48, dtype=np.float32)
    b = rng.standard_normal((8, 48, 3)).astype(np.float32)
    return (torch.from_numpy(np.concatenate([a, a])).to(dev),
            torch.from_numpy(np.concatenate([b, b])).to(dev))


def test_gj_kernel_equals_the_previous_design_bit_for_bit(cuda):
    """Kernel G on the SPD systems and the saved live system: bit for bit
    the solutions saved for the current design (tests/data/
    exact_products_bits.npz)."""
    from pathlib import Path

    from trackdlo_tpu_torch.ops.hopper_kernels import gauss_jordan_solve_batched

    pins = _pins()
    got = gauss_jordan_solve_batched(*_spd_systems(cuda)).cpu().numpy()
    assert np.array_equal(got, pins["gj_spd16"])
    d = np.load(Path(__file__).parent / "data" / "gj_prereg_system.npz")
    live = gauss_jordan_solve_batched(torch.from_numpy(d["a"]).to(cuda)[None],
                                      torch.from_numpy(d["b"]).to(cuda)[None])[0].cpu().numpy()
    assert np.array_equal(live, pins["gj_saved_live"])


def test_gj_kernel_is_no_further_from_float64_than_before_the_repair(cuda):
    """Kernel G with B1's exact residual against its outputs before fault 1's
    repair (tests/data/solve_bits.npz): on the SPD systems and on the saved
    live pre-registration system, no further from float64."""
    from pathlib import Path

    from trackdlo_tpu_torch.ops.hopper_kernels import gauss_jordan_solve_batched

    old = _parent_bits()
    a, b = _spd_systems(cuda)
    d = np.load(Path(__file__).parent / "data" / "gj_prereg_system.npz")
    for (a, b), before in (((a, b), old["gj_spd16"]),
                           ((torch.from_numpy(d["a"]).to(cuda)[None],
                             torch.from_numpy(d["b"]).to(cuda)[None]), old["gj_saved_live"][None])):
        w64 = np.linalg.solve(a.double().cpu().numpy(), b.double().cpu().numpy())
        got = gauss_jordan_solve_batched(a, b).cpu().numpy()
        assert np.abs(got - w64).max() <= np.abs(before - w64).max()


def test_gj_kernel_node_update_matches_plain(cuda):
    """Kernel G's launch with the EM's node update: w as the solve alone
    gives it, bit for bit, and t = y0 + g w, like the plain version's on its
    own w, within two float32 units of |y0| + |g||w| of float64 (both take
    g w from bfloat16 pieces)."""
    from trackdlo_tpu_torch.ops.hopper_kernels import (
        gauss_jordan_solve_batched,
        gauss_jordan_solve_batched_plain,
    )

    a, b = _spd_systems(cuda)
    rng = np.random.default_rng(2)
    g = torch.from_numpy(rng.uniform(0, 1, (16, 48, 48)).astype(np.float32)).to(cuda)
    y0 = torch.from_numpy(rng.uniform(-0.5, 0.5, (16, 48, 3)).astype(np.float32)).to(cuda)
    w, t = gauss_jordan_solve_batched(a, b, g, y0)
    assert torch.equal(w, gauss_jordan_solve_batched(a, b))
    for ww, tt in ((w, t), gauss_jordan_solve_batched_plain(a, b, g, y0)):
        t64 = y0.double() + g.double() @ ww.double()
        scale = y0.double().abs() + g.double().abs() @ ww.double().abs()
        assert bool(((tt.double() - t64).abs() <= 2.0 ** -22 * scale).all())


def test_closed_loop_equals_the_previous_design_bit_for_bit(cuda):
    """chip_smoke.py's phase-4 loop (30 live frames, columns 500:800
    occluded on frames 10-20) through Tracker.step: the final nodes and
    every pass's trips of the kernel E saved in tests/data/
    exact_products_bits.npz (its M-step's two products as B1's _exact_dot,
    ROADMAP §C fault 1; the pins in solve_bits.npz are those of the kernel
    before that repair)."""
    from trackdlo_tpu_torch.models.trackdlo import Tracker

    bits = _pins()
    rope, tracker = SyntheticRope(), Tracker(PARAMS, LIVE, device=cuda)
    state = tracker.init_from_nodes(rope.nodes(0.0, M))
    trips = []
    for i in range(1, 31):
        rgb, depth = render_frame(rope, i / 15.0, LIVE)
        occ = np.ones((LIVE.height, LIVE.width), np.uint8) * 255
        if 10 <= i <= 20:
            occ[:, 500:800] = 0
        state, out = tracker.step(state, rgb, depth, occ)
        trips.append([int(out.guide_iterations), int(out.iterations)])
    assert np.array_equal(np.array(trips), bits["loop_trips"])
    assert np.array_equal(state.y.cpu().numpy(), bits["loop_y"])


@pytest.mark.parametrize("frame", (3, 9, 24, 25))
def test_em_loop_kernel_prereg_trips_follow_b1(cuda, frame):
    """Kernel E on the staged pre-registration inputs of
    tests/data/prereg_frames.npz: within one trip of the JAX package's B1
    (interpreted on the CPU, its trips saved beside the inputs)."""
    from pathlib import Path

    d = np.load(Path(__file__).parent / "data" / "prereg_frames.npz")
    kw = dict(zip([str(k) for k in d["kwarg_names"]], d[f"f{frame}_kwargs"].tolist()))
    kw["max_iter"] = int(kw["max_iter"])
    args = [torch.from_numpy(d[f"f{frame}_{k}"]).to(cuda)
            for k in ("dyn", "y0", "coord", "nm", "g", "hg", "hy0", "jg", "pd", "x", "xm")]
    trips = int(fused_em_loop(*args, **kw)[1][1])
    assert abs(trips - int(d[f"f{frame}_b1_trips"])) <= 1, (trips, int(d[f"f{frame}_b1_trips"]))


def test_walks_kernel_equals_the_previous_design_bit_for_bit(cuda):
    """Kernel W on chip_smoke.py's five walk cases and their 4·5-walk batch,
    from the inputs saved with the previous design's outputs
    (tests/data/walks_bits.npz): every position and mask bit for bit."""
    from pathlib import Path

    d = np.load(Path(__file__).parent / "data" / "walks_bits.npz")
    cases = sorted({k.rsplit("_", 1)[0] for k in d.files})
    assert len(cases) == 6
    for case in cases:
        args = [torch.from_numpy(d[f"{case}_{k}"]).to(cuda) for k in ("guides", "seglens", "ints")]
        pos, valid = pursuit_walks(*args)
        assert np.array_equal(pos.cpu().numpy().view(np.int32), d[f"{case}_pos"].view(np.int32)), case
        assert np.array_equal(valid.cpu().numpy(), d[f"{case}_valid"]), case


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


# ---------------------------------------------------------------------------
# The single-channel slice: kernel P's one-channel modes (B4 with the floor
# votes, and without a leaf) and kernel F (B10).
# ---------------------------------------------------------------------------

ONE_CHANNEL = {"votes": (PARAMS.downsample_leaf_size, True), "cells": (None, False)}


def _p1_args(intr, occluded, dev, mode, radius=9):
    leaf, votes = ONE_CHANNEL[mode]
    args = _p_args(intr, occluded, dev, radius)[:-1] + (leaf,)
    return args, dict(parity_split=False, with_votes=votes)


@pytest.mark.parametrize("mode", sorted(ONE_CHANNEL))
@pytest.mark.parametrize("intr,occluded", [(LIVE, False), (LIVE, True), (QUARTER, True)])
def test_one_channel_cell_sums_kernel_matches_plain(cuda, mode, intr, occluded):
    """Counts and floor-vote sums equal element for element (integers below
    2^24); the coordinate sums within a few float32 ulps."""
    args, kw = _p1_args(intr, occluded, cuda, mode, radius=9 if intr is LIVE else 3)
    counter = f"cell_sums_{mode}"
    before = _build.launch_counts[counter]
    got = cell_sums(*args, **kw)
    torch.cuda.synchronize()
    assert _build.launch_counts[counter] == before + 1
    ref = cell_sums_plain(*args, **kw)
    assert len(got) == len(ref) == (7 if mode == "votes" else 4)
    for g, r in zip(got[3:], ref[3:]):
        assert torch.equal(g, r)
    assert float(ref[3].sum()) > 0
    for g, r in zip(got[:3], ref[:3]):
        torch.testing.assert_close(g, r, rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("mode", sorted(ONE_CHANNEL))
def test_one_channel_clouds_from_kernel_and_plain_sums(cuda, mode):
    """preprocess_kernel_count_delta 0 and the p95 bound of the JAX audit
    (2e-6 m with votes; 1e-6 m for the cells-only cloud)."""
    from trackdlo_tpu_torch.ops.preprocess import compact_sums

    args, kw = _p1_args(LIVE, True, cuda, mode)
    leaf = args[-1]
    pcs = [compact_sums(s, PARAMS.max_points, leaf, PARAMS.candidate_cap(), False)
           for s in (cell_sums(*args, **kw), cell_sums_plain(*args, **kw))]
    assert int(pcs[0].count) == int(pcs[1].count) > 0
    a = pcs[0].points[pcs[0].mask].cpu().numpy()
    b = pcs[1].points[pcs[1].mask].cpu().numpy()
    d = np.linalg.norm(a[:, None] - b[None], axis=2).min(1)
    assert np.percentile(d, 95) <= (2e-6 if mode == "votes" else 1e-6)


@pytest.mark.parametrize("mode", sorted(ONE_CHANNEL))
def test_batched_one_channel_cell_sums_equal_single_launches(cuda, mode):
    leaf, votes = ONE_CHANNEL[mode]
    rgb, depth, occ = _batch_frames(cuda, 4)
    cell = default_cell_px(PARAMS.downsample_leaf_size, LIVE.fx)
    rest = (LIVE.fx, LIVE.fy, LIVE.cx, LIVE.cy, PARAMS.hsv_lower, PARAMS.hsv_upper,
            PARAMS.multi_color_dlo, cell, leaf)
    kw = dict(parity_split=False, with_votes=votes)
    got = cell_sums(rgb, depth, occ, *rest, **kw)
    for b in range(4):
        for g, o in zip(got, cell_sums(rgb[b], depth[b], occ[b], *rest, **kw)):
            assert torch.equal(g[b], o)


def _f_inputs(dev, config, v_count=M, n_streams=1):
    """One iteration's inputs of kernel F from the port's staging, on the live
    cloud, the iterate a little away from the origin."""
    from trackdlo_tpu_torch.ops.cpd_lle import _TWO_PI

    extra = {"plain": {}, "lle": {"include_lle": True},
             "priors_gate": {"use_priors": True, "alpha": PARAMS.alpha}}[config]
    pc = _batch_cloud(dev, n_streams)
    y = torch.stack([torch.from_numpy(SyntheticRope().nodes(0.01 * b, M).astype(np.float32))
                     for b in range(n_streams)]).to(dev)
    nm = (torch.arange(M, device=dev) < v_count).expand(n_streams, M)
    y = torch.where(nm[..., None], y, 0.0)
    kw = dict(visible_count=torch.full((n_streams,), min(30, v_count - 1), device=dev))
    if config == "priors_gate":
        kw.update(prior_pos=y + 0.004, prior_mask=(torch.arange(M, device=dev) < 12).expand(n_streams, M))
    params = _em_params(**extra, use_fused_mstep=True)
    st = em_staging(pc.points, pc.mask, y, nm, torch.full((n_streams,), 1e-3, device=dev), params, **kw)
    dyn, y0, coord, nmf, g, hg, hy0, jg, pd, x, xm = st.args
    s2 = dyn[:, 0]
    c_base = (_TWO_PI * s2) ** 1.5 * params.mu / (1 - params.mu)
    noise = torch.from_numpy(np.random.default_rng(3).normal(0, 1e-3, (n_streams, M, 3)).astype(np.float32))
    yc = torch.where(nmf[..., None] > 0, y0 + noise.to(dev), 0.0)
    args = (yc, y0, nmf > 0, coord, g, hg, hy0, jg, pd, x, xm > 0, s2, c_base * dyn[:, 1] / dyn[:, 2],
            c_base / dyn[:, 2], dyn[:, 3] > 0, dyn[:, 1])
    return args, {k: st.kwargs[k] for k in ("k_vis", "tau_vis", "lam", "coef_lle", "alpha")}


@pytest.mark.parametrize("config,v_count", [("plain", M), ("lle", M), ("priors_gate", M),
                                            ("priors_gate", 30), ("lle", 3)])
def test_em_iteration_kernel_matches_plain(cuda, config, v_count):
    """One iteration: t within 1e-6 m, inactive rows exactly y0, sigma2 and
    the mean move close (em3_fusedmstep_* of chip_smoke.py)."""
    from trackdlo_tpu_torch.ops.hopper_kernels import fused_em_iteration, fused_em_iteration_plain

    args, kw = _f_inputs(cuda, config, v_count)
    if config == "priors_gate":
        assert bool(args[14].all())
    before = _build.launch_counts["em_iteration"]
    got = fused_em_iteration(*args, **kw)
    torch.cuda.synchronize()
    assert _build.launch_counts["em_iteration"] == before + 1
    ref = fused_em_iteration_plain(*args, **kw)
    nm = args[2]
    assert float((got[0] - ref[0]).abs()[nm].max()) <= 1e-6
    assert torch.equal(got[0][~nm], args[1][~nm])
    torch.testing.assert_close(got[1], ref[1], rtol=0, atol=2e-7)
    torch.testing.assert_close(got[2], ref[2], rtol=1e-5, atol=1e-9)


def test_em_iteration_stream_grid_equals_single_launches(cuda):
    """Four different streams in one launch, one cluster each: bit-equal to
    four single-stream launches."""
    from trackdlo_tpu_torch.ops.hopper_kernels import fused_em_iteration

    args, kw = _f_inputs(cuda, "priors_gate", n_streams=4)
    got = fused_em_iteration(*args, **kw)
    for b in range(4):
        one = fused_em_iteration(*(a[b] for a in args), **kw)
        for g, o in zip(got, one):
            assert torch.equal(g[b], o)


def test_fused_route_launches_equal_iterations(cuda):
    """cpd_lle(use_fused_mstep=True) at the live tolerance: one launch of F
    per iteration; 4 copies through cpd_lle_batched bit-equal to the first
    stream of their staging through F (a lone stream's staging may differ in
    the last bit of its geodesic coordinates: torch scans one row with
    another algorithm than a batch of rows)."""
    from trackdlo_tpu_torch.ops.cpd_lle import (
        EmStaging, cpd_lle, cpd_lle_batched, em_loop_lockstep, fused_iteration,
    )

    pc = _cloud(cuda)
    nodes = torch.from_numpy(SyntheticRope().nodes(0.0, M).astype(np.float32)).to(cuda)
    nm = torch.ones(M, dtype=torch.bool, device=cuda)
    params = _em_params(max_iter=PARAMS.max_iter, tol=PARAMS.tol, use_fused_mstep=True)
    s2, vc = torch.tensor(0.001, device=cuda), torch.tensor(30, device=cuda)
    before = _build.launch_counts["em_iteration"]
    single = cpd_lle(pc.points, pc.mask, nodes, nm, s2, params, visible_count=vc)
    assert _build.launch_counts["em_iteration"] - before == int(single.iterations) > 0
    rep = lambda t: t.unsqueeze(0).expand(4, *t.shape).contiguous()
    batched = cpd_lle_batched(rep(pc.points), rep(pc.mask), rep(nodes), rep(nm), rep(s2), params,
                              visible_count=rep(vc))
    st4 = em_staging(rep(pc.points), rep(pc.mask), rep(nodes), rep(nm), rep(s2), params,
                     visible_count=rep(vc))
    st1 = EmStaging(tuple(a[:1] for a in st4.args), st4.kwargs, st4.n_count[:1], st4.sigma2[:1])
    y1, _, it1, _ = em_loop_lockstep(st1, params, lambda y, s: fused_iteration(st1, y, s, params))
    assert torch.equal(batched.y, y1.expand(4, M, 3))
    assert torch.equal(batched.iterations, it1.expand(4))
    assert float((batched.y - single.y).abs().max()) <= 2e-6  # em10_batched_vs_single_max_m


def _f_staging(dev, m=M, n=2048, gate=True, empty=False, n_streams=1):
    """The staging of kernel F's route (the main pass's configuration) for
    ``m`` nodes against the first ``n`` rows of the live clouds, the gate on
    or off, or a shard with no valid point."""
    pc = _batch_cloud(dev, n_streams)
    x, xm = pc.points[:, :n].contiguous(), pc.mask[:, :n].contiguous()
    if empty:
        xm = torch.zeros_like(xm)
    y = torch.stack([torch.from_numpy(SyntheticRope().nodes(0.01 * b, m).astype(np.float32))
                     for b in range(n_streams)]).to(dev)
    nm = torch.ones((n_streams, m), dtype=torch.bool, device=dev)
    params = _em_params(use_fused_mstep=True)
    vc = torch.full((n_streams,), min(30, m - 1), device=dev) if gate else None
    st = em_staging(x, xm, y, nm, torch.full((n_streams,), 1e-3, device=dev), params, visible_count=vc)
    assert bool((st.args[0][:, 3] > 0).all()) == gate
    return st, params


@pytest.mark.parametrize("gate", [False, True])
def test_fused_route_three_iterations_match_plain(cuda, gate):
    """Three iterations of the route (the c's computed in the launch)
    within 1e-6 m of F's plain version (em3_fusedmstep_*), the same trips,
    one launch an iteration."""
    from trackdlo_tpu_torch.ops.cpd_lle import em_loop_lockstep, fused_iteration
    from trackdlo_tpu_torch.ops.hopper_kernels import fused_em_iteration_plain

    st, params = _f_staging(cuda, gate=gate)
    before = _build.launch_counts["em_iteration"]
    yk, sk, ik, _ = em_loop_lockstep(st, params, lambda y, s: fused_iteration(st, y, s, params))
    assert _build.launch_counts["em_iteration"] - before == 3
    yp, sp, ip, _ = em_loop_lockstep(
        st, params, lambda y, s: fused_iteration(st, y, s, params, fused_em_iteration_plain))
    assert torch.equal(ik, ip)
    assert float((yk - yp).abs().max()) <= 1e-6
    torch.testing.assert_close(sk, sp, rtol=0, atol=2e-7)


@pytest.mark.parametrize("m,n,empty", [(M, 2048, False), (13, 2048, False), (M, 1000, False),
                                       (13, 333, False), (M, 1024, True)])
def test_fused_route_shapes_match_plain(cuda, m, n, empty):
    """One iteration at m = 45 and an odd m, n not a multiple of 256 (a
    cluster whose last CTA holds fewer rows), and a shard with no valid
    point: t within 1e-6 m of the plain version, σ² and the move close."""
    from trackdlo_tpu_torch.ops.cpd_lle import fused_iteration
    from trackdlo_tpu_torch.ops.hopper_kernels import fused_em_iteration_plain

    st, params = _f_staging(cuda, m=m, n=n, empty=empty)
    y0, s2 = st.args[1], st.args[0][:, 0]
    got = fused_iteration(st, y0, s2, params)
    ref = fused_iteration(st, y0, s2, params, fused_em_iteration_plain)
    assert float((got[0] - ref[0]).abs().max()) <= 1e-6
    torch.testing.assert_close(got[1], ref[1], rtol=0, atol=2e-7)
    torch.testing.assert_close(got[2], ref[2], rtol=1e-5, atol=1e-9)
    if empty:
        assert torch.equal(got[1], torch.full_like(got[1], 1e-10))


def _onehot_tie_systems():
    """Systems whose pivot columns tie: equal |A[r, k]| in two unused rows
    (opposite signs), an all-zero column, identity rows (the systems of
    tests/test_torch_fused_mstep.py's tie test)."""
    rng = np.random.default_rng(5)
    m = 12
    a = rng.standard_normal((3, m, m)).astype(np.float32) + 4 * np.eye(m, dtype=np.float32)
    a[0, 1, 0] = a[0, 0, 0] = 2.0
    a[0, 5, 0] = -2.0
    a[1, :, 3] = 0.0
    a[2, 4:7] = 0.0
    a[2, :, 4:7] = 0.0
    a[2, 4:7, 4:7] = np.eye(3, dtype=np.float32)
    a[2, 0, 0] = a[2, 3, 0] = 3.0
    b = rng.standard_normal((3, m, 3)).astype(np.float32)
    b[2, 4:7] = 0.0
    return a, b


def test_em_iteration_solve_on_tie_systems_equals_onehot_plain(cuda):
    """The tie and zero-column systems fed through F's own system: no valid
    point (P1 = PX = 0), λ = lle = 0, α = 1, JG = A, PD = B, G = I and
    Y0 = 0, so T is the solve's W. Bit-equal to the plain one-hot solve."""
    from trackdlo_tpu_torch.ops.hopper_kernels import fused_em_iteration, onehot_gauss_jordan_plain

    a_np, b_np = _onehot_tie_systems()
    bsz, m = a_np.shape[:2]
    a, b = torch.from_numpy(a_np).to(cuda), torch.from_numpy(b_np).to(cuda)
    zeros_mm, zeros_m3 = torch.zeros_like(a), torch.zeros_like(b)
    eye = torch.eye(m, device=cuda).expand(bsz, m, m).contiguous()
    x = torch.rand((bsz, 300, 3), generator=torch.Generator().manual_seed(0)).to(cuda)
    xm = torch.zeros((bsz, 300), dtype=torch.bool, device=cuda)
    nm = torch.ones((bsz, m), dtype=torch.bool, device=cuda)
    coord = torch.arange(m, dtype=torch.float32, device=cuda).expand(bsz, m).contiguous()
    one = torch.ones(bsz, device=cuda)
    t, s2, _ = fused_em_iteration(zeros_m3, zeros_m3, nm, coord, eye, zeros_mm, zeros_m3, a, b, x,
                                  xm, 1e-3 * one, one, one, 0 * one, m * one, lam=0.0,
                                  coef_lle=0.0, alpha=1.0)
    w = onehot_gauss_jordan_plain(a, b)
    assert torch.equal(t, w)
    assert torch.equal(s2, torch.full_like(s2, 1e-10))


def test_fused_route_copies_equal_one_stream(cuda):
    """Four copies of a stream's staging through the route in one launch,
    bit-equal to the stream alone."""
    from trackdlo_tpu_torch.ops.cpd_lle import EmStaging, fused_iteration

    st, params = _f_staging(cuda)
    rep = lambda a: a.expand(4, *a.shape[1:]).contiguous()
    st4 = EmStaging(tuple(rep(a) for a in st.args), st.kwargs, rep(st.n_count), rep(st.sigma2))
    got = fused_iteration(st4, st4.args[1], st4.args[0][:, 0], params)
    one = fused_iteration(st, st.args[1], st.args[0][:, 0], params)
    for g, o in zip(got, one):
        assert torch.equal(g, o.expand_as(g))


def _device_ops(fn, n=5):
    """Device ops per call of ``fn`` in a torch.profiler trace."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_type == torch.autograd.DeviceType.CUDA for e in prof.events()) / n


def test_fused_route_iteration_is_one_device_op(cuda):
    from trackdlo_tpu_torch.ops.cpd_lle import fused_iteration

    st, params = _f_staging(cuda)
    y0, s2 = st.args[1], st.args[0][:, 0]
    assert _device_ops(lambda: fused_iteration(st, y0, s2, params)) == 1


def test_em_iteration_matches_previous_design_outputs(cuda):
    """Kernel F on the saved inputs of tests/data/em_iter_bits.npz (written
    by perf/em_iter_bits.py on the design before the cluster E-step): t
    within 1e-6 m of that design's outputs (the E-step's sums and σ² are
    added in another order)."""
    import sys
    from pathlib import Path

    from trackdlo_tpu_torch.ops.hopper_kernels import fused_em_iteration

    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root / "perf"))
    import em_iter_bits

    for case, (fargs, kw, (t0, s0, d0)) in em_iter_bits.load(root / "tests" / "data" / "em_iter_bits.npz").items():
        t, s2, delta = fused_em_iteration(*(torch.from_numpy(a).to(cuda) for a in fargs), **kw)
        assert np.abs(t.cpu().numpy() - t0).max() <= 1e-6, case
        np.testing.assert_allclose(s2.cpu().numpy(), s0, rtol=0, atol=2e-7, err_msg=case)
        np.testing.assert_allclose(delta.cpu().numpy(), d0, rtol=1e-5, atol=1e-9, err_msg=case)


# ---------------------------------------------------------------------------
# The point-sharded slice: kernel N (B9) and the sharded EM on gloo ranks
# that share the card.
# ---------------------------------------------------------------------------


def _n_inputs(dev, n_streams, n, case):
    """Live nodes against the first n points of the live clouds (streams
    offset 0.01 apart), in the case's layout."""
    pc = _batch_cloud(dev, n_streams)
    x, xm = pc.points[:, :n], pc.mask[:, :n]
    y = torch.stack([torch.from_numpy(SyntheticRope().nodes(0.01 * b, M).astype(np.float32))
                     for b in range(n_streams)]).to(dev)
    nm = torch.ones((n_streams, M), dtype=torch.bool, device=dev)
    if case == "masked_rows":
        nm[:, 30:] = False
        nm[:, 3] = False
    if case == "all_masked_cloud":
        xm = torch.zeros_like(xm)
    if case == "non_contiguous":
        x = torch.cat([x, torch.zeros_like(x)], dim=-1)[..., :3]
        y = torch.cat([y, torch.zeros_like(y)], dim=-1)[..., :3]
        nm = torch.stack([nm, nm], dim=-1)[..., 0]
        assert not (x.is_contiguous() or y.is_contiguous() or nm.is_contiguous())
    return y, nm, x, xm


@pytest.mark.parametrize("case", ["rope", "masked_rows", "all_masked_cloud", "non_contiguous"])
@pytest.mark.parametrize("n_streams,n", [(1, 1024), (4, 2048)])
def test_nearest_kernel_is_bit_equal_to_plain(cuda, n_streams, n, case):
    from trackdlo_tpu_torch.ops.hopper_kernels import nearest_point_sq, nearest_point_sq_plain

    args = _n_inputs(cuda, n_streams, n, case)
    before = _build.launch_counts["nearest"]
    got = nearest_point_sq(*args)
    torch.cuda.synchronize()
    assert _build.launch_counts["nearest"] == before + 1
    ref = nearest_point_sq_plain(*args)
    assert torch.equal(got, ref)
    assert bool((got[~args[1]] == 1e5).all())
    if case == "all_masked_cloud":
        assert bool((got == 1e5).all())
    else:
        assert float(got[args[1]].max()) < 1e5
    one = nearest_point_sq(*(a[0] for a in args))
    assert torch.equal(one, got[0])


@pytest.mark.parametrize("case", ["rope", "masked_rows", "all_masked_cloud"])
@pytest.mark.parametrize("n_streams,n", [(1, 1024), (4, 2048), (2, 5000)])
def test_nearest_kernel_float_masks_equal_bool_masks(cuda, n_streams, n, case):
    """float32 0/1 masks (em_staging's, the route's) read as given: bit-equal
    to the plain version and to the bool masks' result; 5000 rows take
    three tiles of compacted points."""
    from trackdlo_tpu_torch.ops.hopper_kernels import nearest_point_sq, nearest_point_sq_plain

    y, nm, x, xm = _n_inputs(cuda, n_streams, min(n, 2048), case)
    if n > 2048:  # the clouds again, further off
        x = torch.cat([x] + [x + 0.01 * k for k in range(1, -(-n // 2048))], dim=1)[:, :n].contiguous()
        xm = torch.cat([xm] * -(-n // 2048), dim=1)[:, :n].contiguous()
    nmf, xmf = nm.to(torch.float32), xm.to(torch.float32)
    got = nearest_point_sq(y, nmf, x, xmf)
    assert torch.equal(got, nearest_point_sq_plain(y, nmf, x, xmf))
    assert torch.equal(got, nearest_point_sq(y, nm, x, xm))


def test_nearest_kernel_is_one_device_op_with_either_mask(cuda):
    """The wrapper casts nothing: one device op a call with bool masks and
    with float32 masks (the route's)."""
    from trackdlo_tpu_torch.ops.hopper_kernels import nearest_point_sq

    y, nm, x, xm = _n_inputs(cuda, 1, 1024, "rope")
    nmf, xmf = nm.to(torch.float32), xm.to(torch.float32)
    assert _device_ops(lambda: nearest_point_sq(y, nm, x, xm)) == 1
    assert _device_ops(lambda: nearest_point_sq(y, nmf, x, xmf)) == 1


def test_sharded_em_on_gloo_ranks_sharing_the_card(cuda):
    """The main pass's configuration (priors, the gate on) with the live
    cloud split over 2 gloo ranks on cuda:0: y bit-equal across the ranks
    and within 1e-6 m of 3 iterations of the unsharded per-iteration
    route."""
    import torch_shard_workers as workers
    from trackdlo_tpu_torch.ops.cpd_lle import cpd_lle
    from trackdlo_tpu_torch.parallel.launch import run_ranks

    pc = _cloud(cuda)
    nodes = torch.from_numpy(SyntheticRope().nodes(0.0, M).astype(np.float32)).to(cuda)
    nm = torch.ones(M, dtype=torch.bool, device=cuda)
    params = _em_params(use_priors=True, alpha=PARAMS.alpha)
    prior_pos, prior_mask = nodes + 0.004, torch.arange(M, device=cuda) < 12
    pmin = ((nodes[:, None] - pc.points[None]) ** 2).sum(-1).amin(0)
    ref, _ = cpd_lle(pc.points, pc.mask, nodes, nm, torch.tensor(PARAMS.sigma2_init, device=cuda),
                     params, prior_pos, prior_mask, torch.tensor(30, device=cuda),
                     point_min_sq=pmin, return_deltas=True)
    np_ = lambda t: t.cpu().numpy()
    case = dict(x=np_(pc.points), xm=np_(pc.mask), y=np_(nodes), nm=np_(nm),
                sigma2=PARAMS.sigma2_init, prior_pos=np_(prior_pos), prior_mask=np_(prior_mask),
                visible_count=30, point_min_sq=np_(pmin), return_deltas=False,
                params={f: getattr(params, f) for f in params.__dataclass_fields__})
    ranks = run_ranks(workers.cpd_cases, 2, device="cuda:0", timeout_s=120.0, args=([case],))
    a, b = (r[0] for r in ranks)
    assert a["iterations"] == b["iterations"] == 3
    assert np.array_equal(a["y"], b["y"]) and np.array_equal(a["sigma2"], b["sigma2"])
    assert np.abs(a["y"] - np_(ref.y)).max() <= 1e-6


def _quarter_frames(n):
    rope = SyntheticRope()
    out = []
    for i in range(1, n + 1):
        rgb, depth = render_frame(rope, i / 15.0, QUARTER, rope_pixel_radius=3)
        occ = np.ones((QUARTER.height, QUARTER.width), bool)
        if i in (2, 3):
            occ[:, int(0.39 * QUARTER.width):int(0.625 * QUARTER.width)] = False
        out.append((rgb, depth, occ))
    return out


@pytest.mark.parametrize("m", [M, 64, 100])
def test_graph_step_is_bit_equal_to_the_eager_step(cuda, m):
    """``Tracker.step`` (one CUDA graph replayed a frame) against the eager
    step on the card, five frames at a quarter of the live camera: every
    output bit for bit, and the launch counts of the replays those of the
    eager frames: every kernel of the path on every frame (past 48 nodes E's
    wide build, past 64 V's, past 65 W's)."""
    from trackdlo_tpu_torch.models.trackdlo import StepOutputs, Tracker, build_step_fn

    params = live_params(max_points=512, dlo_pixel_width=10, num_of_nodes=m)
    tracker = Tracker(params, QUARTER, device=cuda)
    eager = build_step_fn(params, QUARTER, jit=False, device=cuda)
    frames = _quarter_frames(5)
    s_graph = s_eager = tracker.init_from_nodes(SyntheticRope().nodes(0.0, m))
    tracker.step(s_graph, *frames[0])  # warm-up and capture
    counts = []
    for step in ("graph", "eager"):
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        for rgb, depth, occ in frames:
            if step == "graph":
                s_graph, o_graph = tracker.step(s_graph, rgb, depth, occ)
            else:
                s_eager, o_eager = eager(s_eager, rgb, depth, torch.from_numpy(occ).to(cuda))
        torch.cuda.synchronize()
        counts.append(dict(_build.launch_counts))
    assert counts[0] == counts[1]
    for f in StepOutputs._fields:
        assert torch.equal(getattr(o_graph, f), getattr(o_eager, f)), f
    assert torch.equal(s_graph.y, s_eager.y) and torch.isfinite(s_graph.y).all()
    assert counts[0]["em_loop"] == 10
    assert counts[0]["visibility"] == counts[0]["walks"] == counts[0]["cell_sums"] == 5


def test_graph_step_streams_interleave(cuda):
    """Two states stepped in turns through one compiled step each end where
    it ends stepped alone: every call's outputs are its own copies."""
    from trackdlo_tpu_torch.models.trackdlo import Tracker

    params = live_params(max_points=512, dlo_pixel_width=10)
    tracker = Tracker(params, QUARTER, device=cuda)
    frames = _quarter_frames(4)
    rope = SyntheticRope()
    starts = [tracker.init_from_nodes(rope.nodes(t, M)) for t in (0.0, 0.05)]
    alone = []
    for s in starts:
        outs = []
        for f in frames:
            s, o = tracker.step(s, *f)
            outs.append(o)
        alone.append((s, outs))
    a, b = starts
    outs_a, outs_b = [], []
    for f in frames:
        a, oa = tracker.step(a, *f)
        b, ob = tracker.step(b, *f)
        outs_a.append(oa)
        outs_b.append(ob)
    for (s_alone, o_alone), s_mixed, o_mixed in ((alone[0], a, outs_a), (alone[1], b, outs_b)):
        assert torch.equal(s_alone.y, s_mixed.y) and torch.equal(s_alone.sigma2, s_mixed.sigma2)
        for x, y in zip(o_alone, o_mixed):
            assert torch.equal(x.y, y.y) and torch.equal(x.points, y.points)
    assert not torch.equal(a.y, b.y)


def test_step_with_another_solver_stays_eager(cuda):
    """Every solver's step is one CUDA graph (the per-iteration loop's trips
    decided on the card) but "svd_lstsq": torch.linalg.svd reads its
    convergence status on the host, so that step is built eager."""
    from trackdlo_tpu_torch.models.trackdlo import CompiledStep, Tracker

    for solver in ("lu", "lstsq", "normal_cholesky", "xla_lu"):
        assert isinstance(Tracker(live_params(solver=solver), QUARTER, device=cuda)._step,
                          CompiledStep), solver
    assert not isinstance(Tracker(live_params(solver="svd_lstsq"), QUARTER, device=cuda)._step,
                          CompiledStep)


def _wide_staging(m, cuda, n_streams=None, **extra):
    """A main-pass (or, with extra, another) EM staging of ``m`` nodes along
    the rope on the quarter camera's first frame."""
    from trackdlo_tpu_torch.models.trackdlo import Tracker

    tracker = Tracker(live_params(max_points=512, dlo_pixel_width=10, num_of_nodes=m), QUARTER,
                      device=cuda)
    rope = SyntheticRope()
    state = tracker.init_from_nodes(rope.nodes(0.0, m))
    _, out = tracker.step(state, *_quarter_frames(1)[0])
    p = live_params()
    params = CpdParams(**{**dict(beta=p.beta, lam=p.lam, lle_weight=p.lle_weight, mu=p.mu,
                                 max_iter=10, tol=0.0, include_lle=False, k_vis=p.k_vis,
                                 visibility_threshold=p.visibility_threshold,
                                 use_visibility=True), **extra})
    y = torch.as_tensor(rope.nodes(0.0, m), dtype=torch.float32, device=cuda)
    nm = torch.ones(m, dtype=torch.bool, device=cuda)
    args = (out.points, out.points_mask, y, nm, torch.tensor(0.001, device=cuda))
    if n_streams is not None:
        args = tuple(a.expand(n_streams, *a.shape).contiguous() for a in args)
    vc = torch.tensor(2 * m // 3, device=cuda)
    if n_streams is not None:
        vc = vc.expand(n_streams).contiguous()
    return em_staging(*args, params, visible_count=vc), params, out


@pytest.mark.parametrize("m", [64, 100, 128])
def test_wide_em_loop_matches_plain(cuda, m):
    """Kernel E's 128-node build (G, HG and JG read from global memory,
    [A | I | B] in the E-step's scratch) against its plain version after 10
    iterations with the gate on, at phase 3's em10 bound."""
    st, _, _ = _wide_staging(m, cuda)
    yk, sk = fused_em_loop(*st.args, **st.kwargs)
    yp, sp = fused_em_loop_plain(*st.args, **st.kwargs)
    assert int(sk[1]) == int(sp[1]) == 10
    assert float((yk - yp).abs().max()) <= 2e-6


@pytest.mark.parametrize("m", [129, 256, 512])
def test_unbounded_em_loop_matches_plain(cuda, m):
    """Kernel E's node-unbounded build ([A | I | B] in a global workspace,
    the solve spread over the cluster) against its plain version after 3
    iterations with LLE, at phase 3's em3 bound, with the same trips."""
    st, _, _ = _wide_staging(m, cuda, max_iter=3, include_lle=True)
    yk, sk = fused_em_loop(*st.args, **st.kwargs)
    yp, sp = fused_em_loop_plain(*st.args, **st.kwargs)
    assert int(sk[1]) == int(sp[1]) == 3
    assert float((yk - yp).abs().max()) <= 1e-6


@pytest.mark.parametrize("n", [16385, 65536])
def test_rows_past_16384_match_plain(cuda, n):
    """Kernels E, S and F over a dense cloud of n rows, half of them valid
    (a CTA's rows past 2,048 taken a tile at a time, the sums compensated):
    E and F after 3 iterations with LLE within 1e-6 m of their plain
    versions with the same trips, S within the E-step bound."""
    from trackdlo_tpu_torch.ops.cpd_lle import em_loop_lockstep, estep_scalars, fused_iteration
    from trackdlo_tpu_torch.ops.hopper_kernels import (
        fused_em_iteration_plain, fused_estep_packed_batch, fused_estep_packed_batch_plain,
    )

    rng = np.random.default_rng(n)
    rope = SyntheticRope()
    curve = rope.curve(1 / 15.0)
    x = torch.from_numpy((curve[rng.integers(0, len(curve), n)]
                          + rng.normal(0, 0.002, (n, 3))).astype(np.float32)).to(cuda)
    xm = torch.from_numpy(rng.random(n) < 0.5).to(cuda)
    y = torch.as_tensor(rope.nodes(0.0, M), dtype=torch.float32, device=cuda)
    nm = torch.ones(M, dtype=torch.bool, device=cuda)
    p = live_params()
    base = dict(beta=p.beta, lam=p.lam, lle_weight=p.lle_weight, mu=p.mu, max_iter=3, tol=0.0,
                include_lle=True, k_vis=p.k_vis, visibility_threshold=p.visibility_threshold,
                use_visibility=True)
    st = em_staging(x, xm, y, nm, torch.tensor(0.001, device=cuda), CpdParams(**base),
                    visible_count=torch.tensor(30, device=cuda))
    yk, sk = fused_em_loop(*st.args, **st.kwargs)
    yp, sp = fused_em_loop_plain(*st.args, **st.kwargs)
    assert int(sk[1]) == int(sp[1]) == 3
    assert float((yk - yp).abs().max()) <= 1e-6
    fparams = CpdParams(**base, use_fused_mstep=True)
    fst = em_staging(x[None], xm[None], y[None], nm[None], torch.tensor([0.001], device=cuda),
                     fparams, visible_count=torch.tensor([30], device=cuda))
    yk, _, ik, _ = em_loop_lockstep(fst, fparams, lambda y, s: fused_iteration(fst, y, s, fparams))
    yp, _, ip, _ = em_loop_lockstep(
        fst, fparams, lambda y, s: fused_iteration(fst, y, s, fparams, fused_em_iteration_plain))
    assert torch.equal(ik, ip) and float((yk - yp).abs().max()) <= 1e-6
    scal = estep_scalars(fst.args[0], fst.args[0][:, 0], fparams)
    args = (scal, fst.args[1], fst.args[2], fst.args[3],
            fst.args[3] / fst.args[3].sum(1, keepdim=True), fst.args[9], fst.args[10])
    for two_phase in (True, False):
        got = fused_estep_packed_batch(*args, two_phase=two_phase)
        ref = fused_estep_packed_batch_plain(*args, two_phase=two_phase)
        for g, r in zip(got[:3], ref[:3]):
            assert bool(((g - r).abs() <= 1e-6 + 2e-4 * r.abs()).all())
        assert torch.equal(got[3], ref[3])


@pytest.mark.parametrize("m", [65, 100, 128, 130, 256, 512])
def test_wide_visibility_and_walks_match_plain(cuda, m):
    """Kernel V's two-word node masks and kernel W's four segments a lane
    against their plain versions: indices and masks equal, distances and
    positions at phase 3's bounds."""
    from trackdlo_tpu_torch.ops import priors as tp
    from trackdlo_tpu_torch.ops.kernels import geodesic_coords
    from trackdlo_tpu_torch.ops.visibility import compute_visibility
    from trackdlo_tpu_torch.ops.visibility_kernel import fused_visibility

    _, _, out = _wide_staging(m, cuda)
    y = torch.as_tensor(SyntheticRope().nodes(0.0, m), dtype=torch.float32, device=cuda)
    p = live_params()
    proj = torch.as_tensor(np.array(QUARTER.proj_matrix(), np.float32), device=cuda)
    a = (y, out.points, out.points_mask, proj, geodesic_coords(y), QUARTER.height, QUARTER.width,
         p.visibility_threshold, 10, p.d_vis)
    vk, vp = fused_visibility(*a), compute_visibility(*a)
    for f in ("visible_mask", "extended_mask", "not_self_occluded", "vis_idx", "vis_ext_idx",
              "vis_count", "vis_ext_count"):
        assert torch.equal(getattr(vk, f), getattr(vp, f)), f
    assert float((vk.shortest_node_pt_dists - vp.shortest_node_pt_dists).abs().max()) <= 1e-6
    wi = tp.walk_inputs(y, geodesic_coords(y), y + 0.002, vk.vis_ext_idx, vk.vis_ext_count,
                        vk.vis_idx, vk.vis_count)
    pk, mk = pursuit_walks(wi.guides, wi.seglens, wi.ints, tp._EPS_BETWEEN)
    pp, mp = pursuit_walks_plain(wi.guides, wi.seglens, wi.ints, tp._EPS_BETWEEN)
    assert torch.equal(mk, mp)
    assert float(torch.where(mp[..., None], (pk - pp).abs(), 0.0).max()) <= 5e-6


@pytest.mark.parametrize("m", [64, 128, 129, 256])
def test_wide_batched_kernels_match_plain(cuda, m):
    """Kernels S, G, F and N's wide builds against their plain versions on
    4 streams: S within the E-step bound, G against float64 on SPD systems
    as gj_solve_vs_f64_max, F after 3 iterations, N bit for bit."""
    from trackdlo_tpu_torch.ops.cpd_lle import em_loop_lockstep, estep_scalars, fused_iteration
    from trackdlo_tpu_torch.ops.hopper_kernels import (
        fused_em_iteration_plain, fused_estep_packed_batch, fused_estep_packed_batch_plain,
        gauss_jordan_solve_batched, nearest_point_sq, nearest_point_sq_plain,
    )

    st, params, _ = _wide_staging(m, cuda, n_streams=4)
    s2 = st.args[0][:, 0]
    scal = estep_scalars(st.args[0], s2, params)
    args = (scal, st.args[1], st.args[2], st.args[3], st.args[3] / st.args[3].sum(1, keepdim=True),
            st.args[9], st.args[10])
    for two_phase in (True, False):
        got = fused_estep_packed_batch(*args, two_phase=two_phase)
        ref = fused_estep_packed_batch_plain(*args, two_phase=two_phase)
        for g, r in zip(got[:3], ref[:3]):
            assert bool(((g - r).abs() <= 1e-6 + 2e-4 * r.abs()).all())
        assert torch.equal(got[3], ref[3])
    rng = np.random.default_rng(m)
    a = rng.standard_normal((4, m, m)).astype(np.float32)
    a = a @ a.transpose(0, 2, 1) + m * np.eye(m, dtype=np.float32)
    b = rng.standard_normal((4, m, 3)).astype(np.float32)
    w = gauss_jordan_solve_batched(torch.from_numpy(a).to(cuda), torch.from_numpy(b).to(cuda))
    w64 = np.linalg.solve(a.astype(np.float64), b.astype(np.float64))
    assert np.abs(w.cpu().numpy() - w64).max() <= 2e-8
    fst, fparams, _ = _wide_staging(m, cuda, n_streams=1, max_iter=3, include_lle=True,
                                    use_fused_mstep=True)
    yk, _, ik, _ = em_loop_lockstep(fst, fparams, lambda y, s: fused_iteration(fst, y, s, fparams))
    yp, _, ip, _ = em_loop_lockstep(
        fst, fparams, lambda y, s: fused_iteration(fst, y, s, fparams, fused_em_iteration_plain))
    assert torch.equal(ik, ip) and float((yk - yp).abs().max()) <= 1e-6
    nm = torch.arange(m, device=cuda) < 2 * m // 3
    c = (st.args[1][0], nm, st.args[9][0], st.args[10][0])
    assert torch.equal(nearest_point_sq(*c), nearest_point_sq_plain(*c))


# ---------------------------------------------------------------------------
# Kernel L and the EM loop as a conditional WHILE node of a CUDA graph.
# ---------------------------------------------------------------------------


def test_loop_flag_kernel_matches_plain(cuda):
    from trackdlo_tpu_torch.ops.graph_loop import loop_flag, loop_flag_plain

    rng = np.random.default_rng(0)
    for _ in range(40):
        b = int(rng.integers(1, 80))
        done = torch.from_numpy(rng.random(b) < 0.8).to(cuda)
        it = torch.from_numpy(rng.integers(0, 12, b).astype(np.int32)).to(cuda)
        max_iter = int(rng.integers(0, 12))
        assert int(loop_flag(done, it, max_iter)) == int(loop_flag_plain(done, it, max_iter))


def _graph_loop_staging(cuda, bsz):
    from trackdlo_tpu_torch.models.trackdlo import Tracker

    tracker = Tracker(live_params(max_points=512, dlo_pixel_width=10), QUARTER, device=cuda)
    state = tracker.init_from_nodes(SyntheticRope().nodes(0.0, M))
    _, out = tracker.step(state, *_quarter_frames(1)[0])
    p = live_params()
    params = CpdParams(beta=p.beta, lam=p.lam, lle_weight=p.lle_weight, mu=p.mu,
                       max_iter=p.max_iter, tol=p.tol, include_lle=False, k_vis=p.k_vis,
                       visibility_threshold=p.visibility_threshold, prune_radius=p.prune_radius,
                       use_visibility=True)
    rep = lambda t: t.unsqueeze(0).expand(bsz, *t.shape).contiguous()
    y = rep(state.y) + 0.002 * torch.arange(bsz, device=cuda)[:, None, None]
    st = em_staging(rep(out.points), rep(out.points_mask), y,
                    torch.ones(bsz, M, dtype=torch.bool, device=cuda),
                    torch.full((bsz,), float(state.sigma2), device=cuda), params)
    return st, params


def test_conditional_node_loop_matches_eager_loop(cuda):
    """The lockstep loop of 4 streams (kernels S and G a trip) captured as a
    conditional WHILE node: every replay bit for bit the eager host loop, the
    trips counted on the card."""
    from trackdlo_tpu_torch.ops import graph_loop
    from trackdlo_tpu_torch.ops.cpd_lle import em_loop_lockstep, iteration_route
    from trackdlo_tpu_torch.ops.hopper_kernels import fused_estep_packed_batch

    st, params = _graph_loop_staging(cuda, 4)
    iteration = iteration_route(st, params, fused_estep_packed_batch)
    want = em_loop_lockstep(st, params, iteration)
    graph_loop.warm(cuda)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    loops = graph_loop.GraphLoops(cuda)
    with graph_loop.recording(loops):
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            got = em_loop_lockstep(st, params, iteration)
    loops.captured()
    _build.settle_counts()
    _build.reset_launch_counts()
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    trips = int(want[2].max())
    counts = _build.settle_counts()
    assert trips >= 2 and len(set(want[2].tolist())) >= 2
    assert counts["estep_batch"] == counts["gj_solve"] == 3 * trips
    assert counts["loop_flag"] == 3 * (trips + 1)


def test_batched_graph_matches_eager_over_three_frame_sets(cuda):
    from trackdlo_tpu_torch.models.trackdlo import Tracker, TrackerState
    from trackdlo_tpu_torch.parallel import build_batched_step_fn

    params, bsz = live_params(max_points=512, dlo_pixel_width=10), 4
    graph = build_batched_step_fn(params, QUARTER, cohort_size=2, device=cuda)
    eager = build_batched_step_fn(params, QUARTER, cohort_size=2, device=cuda, jit=False)
    tracker = Tracker(params, QUARTER, device=cuda)
    state = TrackerState(*(torch.stack(f) for f in zip(*(
        tracker.init_from_nodes(SyntheticRope().nodes(0.01 * b, M)) for b in range(bsz)))))
    sg = se = state
    for rgb, depth, occ in _quarter_frames(3):
        frames = [np.stack([a] * bsz) for a in (rgb, depth, occ)]
        sg, og = graph(sg, *frames)
        se, oe = eager(se, *frames)
        for a, b in zip((*sg, *og), (*se, *oe)):
            assert torch.equal(a, b)


# -- the span recorder's device stamps (utils/profiling.py, csrc/stamp.cu) --


@pytest.fixture
def recorder():
    """The span recorder, off and empty before and after the test."""
    from trackdlo_tpu_torch.utils import profiling

    profiling.disable()
    profiling.drain()
    yield profiling
    profiling.disable()
    profiling.drain()


LAYERS = ("preprocess", "visibility", "em.pre", "priors", "em.main")
# Spans inside a layer's: kernel X's, inside the preprocessing's.
NESTED = {"preprocess.split_cells": "preprocess"}


def _stamped_trackers(recorder, cuda, frames):
    """Two trackers of the quarter camera, the first captured with the
    recorder off, the second with it on; each stepped through ``frames``
    from one start, the launch counts of its replays (after the capture)
    and its states and outputs kept."""
    from trackdlo_tpu_torch.models.trackdlo import Tracker

    params = live_params(max_points=512, dlo_pixel_width=10)
    start = SyntheticRope().nodes(0.0, M)
    runs = []
    for on in (False, True):
        (recorder.enable if on else recorder.disable)()
        tracker = Tracker(params, QUARTER, device=cuda)
        state = tracker.init_from_nodes(start)
        tracker.step(state, *frames[0])  # capture
        recorder.enable()
        recorder.drain()
        _build.reset_launch_counts()
        got = []
        for f in frames:
            state, out = tracker.step(state, *f)
            got.append((state, out))
        counts = dict(_build.settle_counts())
        counts["stamps"] = sum(int(r.header[0]) for r in recorder._recorder.rings.values())
        runs.append((tracker, got, counts, recorder.drain()))
    return runs


def test_graph_captured_with_tracing_off_has_no_stamp_node(cuda, recorder):
    """Replays of a graph captured while the recorder was off take no stamp
    (the device buffer's cursor stays 0 with the recorder on) and launch
    what a stamped graph launches, the eager step's kernels a frame."""
    frames = _quarter_frames(4)
    (off, _, counts_off, drained_off), (on, _, counts_on, drained_on) = \
        _stamped_trackers(recorder, cuda, frames)
    assert not off._step.stamped and on._step.stamped
    assert counts_off.pop("stamps") == 0 and drained_off.device == []
    # the replay's, the 5 layers' and kernel X's pairs
    assert counts_on.pop("stamps") == 14 * len(frames)
    assert len({s.call for s in drained_on.device}) == len(frames)
    assert counts_off == counts_on
    assert counts_off["em_loop"] == 2 * len(frames) and counts_off["cell_sums"] == len(frames)


def test_stamped_graph_is_bit_equal_to_the_unstamped_one(cuda, recorder):
    frames = _quarter_frames(5)
    (_, got_off, _, _), (_, got_on, _, _) = _stamped_trackers(recorder, cuda, frames)
    for (s_off, o_off), (s_on, o_on) in zip(got_off, got_on):
        for a, b in zip((*s_off, *o_off), (*s_on, *o_on)):
            assert torch.equal(a, b)


def _batched_runs(recorder, cuda, n_sets=2, bsz=16, cohort=8):
    """The b16/c8 batched step at the quarter camera, captured with the
    recorder off and with it on: each one's states and outputs over
    ``n_sets`` frame sets, the loops' trips (kernel L's tally) and what the
    recorder drained."""
    from trackdlo_tpu_torch.models.trackdlo import Tracker, TrackerState
    from trackdlo_tpu_torch.parallel import build_batched_step_fn

    params = live_params(max_points=512, dlo_pixel_width=10)
    tracker = Tracker(params, QUARTER, device=cuda)
    start = TrackerState(*(torch.stack(f) for f in zip(*(
        tracker.init_from_nodes(SyntheticRope().nodes(0.01 * b, M)) for b in range(bsz)))))
    sets = [[np.stack([a] * bsz) for a in f] for f in _quarter_frames(n_sets + 1)]
    runs = []
    for on in (False, True):
        (recorder.enable if on else recorder.disable)()
        step = build_batched_step_fn(params, QUARTER, cohort_size=cohort, device=cuda)
        state, _ = step(start, *sets[0])  # capture
        recorder.enable()
        recorder.drain()
        _build.reset_launch_counts()
        got = []
        for s in sets[1:]:
            state, out = step(state, *s)
            got.append((state, out))
        counts = dict(_build.settle_counts())
        runs.append((got, counts, recorder.drain()))
    return runs


def test_stamped_batched_graph_is_bit_equal_and_times_its_loops(cuda, recorder):
    """b16/c8: the stamped graph's outputs are the unstamped one's bit for
    bit, with the same launches; each cohort's EM spans (em.pre + em.main)
    take device time, so em.device_ms over kernel L's trips is positive."""
    (got_off, counts_off, _), (got_on, counts_on, drained) = _batched_runs(recorder, cuda)
    for (s_off, o_off), (s_on, o_on) in zip(got_off, got_on):
        for a, b in zip((*s_off, *o_off), (*s_on, *o_on)):
            assert torch.equal(a, b)
    assert counts_off == counts_on
    assert drained.lost == 0
    calls = sorted({s.call for s in drained.device})
    assert len(calls) == len(got_on)
    for call in calls:
        spans = [s for s in drained.device if s.call == call]
        assert sorted((s.name, s.cohort) for s in spans) == sorted(
            [("replay", None)] + [(n, c) for n in LAYERS + tuple(NESTED) for c in (0, 1)])
    em_ms = sum(s.end_ns - s.start_ns for s in drained.device if s.name.startswith("em.")) / 1e6
    trips = counts_on["loop_flag"] - 2 * 2 * len(got_on)  # less one opening launch a loop
    assert trips > 0 and em_ms / len(calls) / trips > 0


def test_stamps_are_ordered_and_the_layers_cover_the_replay(cuda, recorder):
    """Within each replay the layers follow one another in the step's order,
    inside the replay's span; together they cover 80-100% of it. Kernel X's
    span lies inside the preprocessing's."""
    frames = _quarter_frames(5)
    (_, _, _, _), (_, _, _, drained) = _stamped_trackers(recorder, cuda, frames)
    calib = next(iter(drained.calibration.values()))
    assert calib["error_ns"] > 0 and calib["timer_step_ns"] > 0
    for call in sorted({s.call for s in drained.device}):
        spans = {s.name: s for s in drained.device if s.call == call}
        assert sorted(spans) == sorted(("replay",) + LAYERS + tuple(NESTED))
        for inner, outer in NESTED.items():
            assert spans[outer].start_ns <= spans[inner].start_ns <= spans[inner].end_ns \
                <= spans[outer].end_ns
        replay, layers = spans["replay"], [spans[n] for n in LAYERS]
        assert replay.start_ns <= layers[0].start_ns
        for a, b in zip(layers, layers[1:]):
            assert a.start_ns <= a.end_ns <= b.start_ns
        assert layers[-1].end_ns <= replay.end_ns
        covered = sum(s.end_ns - s.start_ns for s in layers)
        assert 0.8 * (replay.end_ns - replay.start_ns) <= covered <= replay.end_ns - replay.start_ns


def test_preprocess_span_brackets_kernels_p_and_c_under_the_profiler(cuda, recorder):
    """The preprocess device span, placed on the host clock, starts no
    later than kernel P's trace event and ends no earlier than kernel C's,
    within the calibration's error and the timer's step. The recorder's
    host clock is moved onto the trace's by each call's replay: the offset
    between the replay span's start and the trace's own event of the same
    stamp (the replay's first stamp kernel). The profiler's alignment of its
    device events with its host events drifts (by up to 40 µs a call in a
    process's first profiles), so one offset for the whole trace, taken
    from the host annotations, would measure that drift and not the
    recorder."""
    from torch.profiler import ProfilerActivity, profile

    from trackdlo_tpu_torch.models.trackdlo import Tracker

    params = live_params(max_points=512, dlo_pixel_width=10)
    frames = _quarter_frames(6)
    recorder.enable()
    tracker = Tracker(params, QUARTER, device=cuda)
    state = tracker.init_from_nodes(SyntheticRope().nodes(0.0, M))
    state, _ = tracker.step(state, *frames[0])
    torch.cuda.synchronize()
    recorder.drain()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for f in frames[1:]:
            state, out = tracker.step(state, *f)
        out.y.cpu()
    drained = recorder.drain()
    calls = len(frames) - 1
    gpu = torch.autograd.DeviceType.CUDA
    kernel = lambda name: sorted((e.time_range.start, e.time_range.end)  # noqa: E731
                                 for e in prof.events() if e.device_type == gpu
                                 and re.search(rf"\b{name}\b", e.name))
    p_events, c_events, stamps = (kernel(k) for k in ("cell_sums_kernel", "compact_kernel",
                                                      "stamp_kernel"))
    spans = lambda name: sorted((s.start_ns / 1e3, s.end_ns / 1e3)  # noqa: E731
                                for s in drained.device if s.name == name)
    replays, pre = spans("replay"), spans("preprocess")
    per_call = 2 * len(drained.device) // calls  # two stamps a device span
    assert len(stamps) == per_call * calls
    assert len(p_events) == len(c_events) == len(pre) == len(replays) == calls
    calib = next(iter(drained.calibration.values()))
    tol = (calib["error_ns"] + calib["timer_step_ns"]) / 1e3
    for i, ((s, e), p, c) in enumerate(zip(pre, p_events, c_events)):
        shift = replays[i][0] - stamps[per_call * i][0]
        assert s - shift <= p[0] + tol and e - shift >= c[1] - tol, (s - shift - p[0],
                                                                     c[1] - e + shift, tol)


# -- the graph step's stage-in: persistent pinned host buffers (models/trackdlo.py) --


def _staged_step(kind, cuda):
    """A graph path of the quarter camera: the step, its start state and
    frames ``k`` → the arrays of call ``k`` (numpy, as callers hand them
    over; each stream of a batched set at another frame)."""
    from trackdlo_tpu_torch.models.trackdlo import Tracker, TrackerState
    from trackdlo_tpu_torch.parallel import build_batched_step_fn

    params = live_params(max_points=512, dlo_pixel_width=10)
    tracker = Tracker(params, QUARTER, device=cuda)
    frames = _quarter_frames(8)
    rope = SyntheticRope()
    if kind == "single":
        return tracker.step, tracker.init_from_nodes(rope.nodes(0.0, M)), lambda k: frames[k]
    if kind == "points":
        clouds = [np.asarray(rope.nodes(0.03 * k, 400), np.float32) for k in range(8)]
        return (tracker.step_from_points, tracker.init_from_nodes(rope.nodes(0.0, M)),
                lambda k: (clouds[k],))
    step = build_batched_step_fn(params, QUARTER, cohort_size=2, device=cuda)
    start = TrackerState(*(torch.stack(f) for f in zip(*(
        tracker.init_from_nodes(rope.nodes(0.01 * b, M)) for b in range(4)))))
    return step, start, lambda k: tuple(np.stack([frames[(k + b) % 8][i] for b in range(4)])
                                        for i in range(3))


def _on_card(arrays, cuda):
    """The same arrays as tensors on the card (u16 depth as its int16 bits)."""
    return tuple(torch.from_numpy(a.view(np.int16) if a.dtype == np.uint16 else a).to(cuda)
                 for a in arrays)


@pytest.mark.parametrize("kind", ["single", "batched"])
def test_numpy_frames_through_the_staging_buffers_equal_frames_on_the_card(cuda, kind):
    """A graph step fed numpy frames (written into its pinned host buffers)
    against the same step fed the same frames as tensors on the card, over
    4 calls: every state and output bit for bit."""
    runs = []
    for on_card in (False, True):
        step, state, frames = _staged_step(kind, cuda)
        got = []
        for k in range(4):
            f = _on_card(frames(k), cuda) if on_card else frames(k)
            state, out = step(state, *f)
            got.append((*state, *out))
        runs.append(got)
    for a, b in zip(*runs):
        for x, y in zip(a, b, strict=True):
            assert torch.equal(x, y)


@pytest.mark.parametrize("kind", ["single", "batched"])
def test_back_to_back_calls_wait_for_the_staging_buffers(cuda, kind):
    """Calls made back to back with other frames, no host read between them
    (each call's writes into the host buffers may find the last call's
    copies out of them not yet run), end where the same calls with a
    synchronisation after each end: the reuse event holds each write back."""
    runs = []
    for sync in (True, False):
        step, state, frames = _staged_step(kind, cuda)
        state, _ = step(state, *frames(0))  # capture
        torch.cuda.synchronize()
        got = []
        for k in range(1, 6):
            state, out = step(state, *frames(k))
            got.append((*state, *out))
            if sync:
                torch.cuda.synchronize()
        torch.cuda.synchronize()
        runs.append(got)
    for a, b in zip(*runs):
        for x, y in zip(a, b, strict=True):
            assert torch.equal(x, y)


@pytest.mark.parametrize("kind", ["single", "batched", "points"])
def test_graph_paths_stage_the_frames_and_pin_nothing(cuda, recorder, kind):
    """After the warm-up, a graph path pins nothing afresh (``pinned_bytes``
    0): its ``staged_bytes`` are the bytes of the arrays handed over (a
    points step: its padded cloud and mask)."""
    step, state, frames = _staged_step(kind, cuda)
    state, _ = step(state, *frames(0))  # warm-up and capture
    torch.cuda.synchronize()
    recorder.enable()
    recorder.drain()
    for k in range(1, 4):
        state, out = step(state, *frames(k))
        out.y.cpu()
    counters = recorder.drain().counters
    if kind == "points":
        handed = 3 * 512 * (3 * 4 + 1)  # (max_points, 3) float32 and (max_points,) bool
    else:
        handed = sum(a.nbytes for k in range(1, 4) for a in frames(k))
    assert counters.get("pinned_bytes", 0) == 0
    assert counters["staged_bytes"] == handed
    assert counters.get("staging_waits", 0) >= 0  # counted; its value is the host's timing


# The exact route (the step's parity preprocessing): kernel P in exact mode,
# kernel C and kernel X against their plain versions on the same frames.

EXACT_CASES = {
    # name: (camera, params, depth noise mm, dropout, streams, box over the rope)
    "eval_720p_noisy": (LIVE, "eval", 2.0, 0.05, 1, True),
    "eval_720p_noisy_b2": (LIVE, "eval", 2.0, 0.05, 2, False),
    "live_quarter_clean": (QUARTER, "live", 0.0, 0.0, 1, False),
}


def _exact_frames(name):
    from trackdlo_tpu_torch.config import eval_params

    intr, which, noise, dropout, streams, box = EXACT_CASES[name]
    params = eval_params() if which == "eval" else PARAMS
    frames = []
    for b in range(streams):
        rgb, depth = render_frame(SyntheticRope(), 0.3 + 0.4 * b, intr,
                                  rope_pixel_radius=9 if intr is LIVE else 3,
                                  depth_noise_mm=noise, seed=11 + b, markers=12,
                                  dropout_frac=dropout)
        occ = np.ones((intr.height, intr.width), bool)
        if box:
            occ[200:520, 300:700] = False
        frames.append((rgb, depth, occ))
    cell = default_cell_px(params.downsample_leaf_size, intr.fx)
    stacked = [np.stack(a) if streams > 1 else a[0] for a in zip(*frames)]
    return intr, params, cell, stacked


def _exact_args(intr, params, cell, stacked, dev):
    rgb, depth, occ = stacked
    return (torch.from_numpy(rgb).to(dev), torch.from_numpy(depth.view(np.int16)).to(dev),
            torch.from_numpy(occ).to(dev), intr.fx, intr.fy, intr.cx, intr.cy, params.hsv_lower,
            params.hsv_upper, params.multi_color_dlo, cell, params.downsample_leaf_size)


@pytest.mark.parametrize("name", sorted(EXACT_CASES))
def test_exact_route_kernels_match_plain(cuda, name):
    """Kernel P's exact mode: the counts bit-equal, the sums within a few
    ulps, the same split channel-cells and pixels without depth as the plain
    version. Kernel X: on the clean frame it leaves kernel C's rows as they
    are and counts no work; on the noisy ones the cloud after the snap has
    the plain route's voxels, each centroid within 1e-6 m (X sums a voxel's
    pixels in another order)."""
    from trackdlo_tpu_torch.ops.preprocess import (
        compact_sums,
        exact_frame,
        preprocess_frame,
        split_groups,
    )

    intr, params, cell, stacked = _exact_frames(name)
    leaf, cap = params.downsample_leaf_size, params.candidate_cap()
    args = _exact_args(intr, params, cell, stacked, cuda)
    cpu_args = _exact_args(intr, params, cell, stacked, "cpu")
    got = cell_sums(*args, exact=True)
    torch.cuda.synchronize()
    ref = cell_sums_plain(*cpu_args, exact=True)
    assert torch.equal(got[3].cpu(), ref[3]) and float(ref[3].sum()) > 0
    for g, r in zip(got[:3], ref[:3]):
        torch.testing.assert_close(g.cpu(), r, rtol=2e-6, atol=2e-6)
    assert torch.equal(got[4].counts.sum(-2).cpu(), ref[4].counts.sum(-2))
    marked = ref[4].mask != 0
    assert torch.equal(got[4].mask.cpu()[marked], ref[4].mask[marked])
    noisy = EXACT_CASES[name][2] > 0
    assert bool(marked.any()) == noisy and bool((ref[4].counts[..., 1] > 0).any()) == noisy

    _build.settle_counts()
    before = _build.launch_counts["split_cells.frames"]
    rows = compact_occupied_channels(*(t.reshape(-1, t.shape[-1]) for t in got[:4]), cap // 8,
                                     True)
    kept = [t.clone() for t in rows]
    split_groups(exact_frame(args, got), *rows)
    torch.cuda.synchronize()
    frames_worked = _build.settle_counts()["split_cells.frames"] - before
    streams = EXACT_CASES[name][4]
    if not noisy:
        assert frames_worked == 0
        assert all(torch.equal(a, b) for a, b in zip(rows, kept))
    else:
        assert frames_worked == streams
        pc = compact_sums(got, params.max_points, leaf, cap, True, exact_frame(args, got))
        want = preprocess_frame(*cpu_args[:11], params.max_points, leaf, cap, exact=True)
        for b in range(streams):
            pick = (lambda t: t[b]) if streams > 1 else (lambda t: t)  # noqa: E731
            g = pick(pc.points)[pick(pc.mask)].cpu().double()
            w = pick(want.points)[pick(want.mask)].double()
            assert len(g) == len(w) > 500
            d = torch.cdist(g, w)
            assert float(d.min(1).values.max()) <= 1e-6 and float(d.min(0).values.max()) <= 1e-6


def test_exact_route_graph_step_is_bit_equal_to_eager_and_counts(cuda, recorder):
    """``Tracker.step`` at the evaluation preset on noisy quarter frames with
    dropout and a box over the head: the graph (kernel X inside it) bit for
    bit the eager step; captured with the recorder on, the device counters
    read the pixels without depth, the split cells and one occlusion state
    a frame."""
    from trackdlo_tpu_torch.config import eval_params
    from trackdlo_tpu_torch.models.trackdlo import StepOutputs, Tracker, build_step_fn

    params = eval_params(max_points=1024)
    frames = []
    for i in range(6):
        rgb, depth = render_frame(SyntheticRope(), i / 30.0, QUARTER, rope_pixel_radius=3,
                                  depth_noise_mm=2.0, seed=i, markers=12, dropout_frac=0.05)
        occ = np.ones((QUARTER.height, QUARTER.width), bool)
        occ[:, : QUARTER.width // 2] = i < 2  # the head half boxed from frame 2
        frames.append((rgb, depth, occ))
    recorder.enable()
    tracker = Tracker(params, QUARTER, device=cuda)
    eager = build_step_fn(params, QUARTER, jit=False, device=cuda)
    nodes = SyntheticRope().nodes(-1 / 30.0, params.num_of_nodes)
    s_graph = s_eager = tracker.init_from_nodes(nodes)
    s_graph, _ = tracker.step(s_graph, *frames[0])  # warm-up and capture
    s_eager, _ = eager(s_eager, frames[0][0], frames[0][1], torch.from_numpy(frames[0][2]).to(cuda))
    torch.cuda.synchronize()
    recorder.drain()
    for rgb, depth, occ in frames[1:]:
        s_graph, o_graph = tracker.step(s_graph, rgb, depth, occ)
        s_eager, o_eager = eager(s_eager, rgb, depth, torch.from_numpy(occ).to(cuda))
        for f in StepOutputs._fields:
            assert torch.equal(getattr(o_graph, f), getattr(o_eager, f)), f
    counters = recorder.drain().counters
    assert counters["dropout_points"] > 0 and counters["split_cells"] > 0
    states = {k: v for k, v in counters.items() if k.startswith("occlusion_states.")}
    assert sum(states.values()) == len(frames) - 1
