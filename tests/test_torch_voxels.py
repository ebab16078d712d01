"""The parity preprocessing's exact route (the step's) against the float64
oracle: PCL's VoxelGrid of the masked cloud at any depth noise, with masked
pixels without depth at the origin.

The route is kernel P's plain version in exact mode (split channel-cells
left at zero and marked, pixels without depth counted), kernel C's plain
version, kernel X's plain version (``split_groups_plain``: the marked
channel-cells summed voxel by voxel, one candidate at the origin) and the
voxel snap. The torch reference (``oracle/voxel_grid_torch.py``) and the
NumPy oracle (``oracle/preprocess.py``) compute the same grid in float64.

Bounds: the voxel count equal, and every centroid within 1e-6 m of the
oracle's (each point's distance to its nearest oracle point, both ways).
The route's float32 centroids sit ~1e-7 m from float64 at these depths.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

from trackdlo_tpu_torch.config import CameraIntrinsics, eval_params, live_params
from trackdlo_tpu_torch.io.sequence import SyntheticRope, render_frame
from trackdlo_tpu_torch.ops import preprocess as pre
from trackdlo_tpu_torch.oracle import preprocess as oracle
from trackdlo_tpu_torch.oracle import voxel_grid_torch

TOL_M = 1e-6
QUARTER = CameraIntrinsics(fx=918.359130859375 / 4, fy=916.265869140625 / 4,
                           cx=645.8908081054688 / 4, cy=354.02392578125 / 4,
                           width=320, height=180)
EIGHTH = CameraIntrinsics(fx=918.359130859375 / 8, fy=916.265869140625 / 8,
                          cx=645.8908081054688 / 8, cy=354.02392578125 / 8, width=160, height=90)
SMALL = CameraIntrinsics(fx=120.0, fy=120.0, cx=80.0, cy=60.0, width=160, height=120)
# name: (camera, params, cell_px or None for the leaf's, rope radius px). A
# 4 px cell at an eighth of the D435 spans 23 mm at the rope, ~3 voxels of
# the 8 mm leaf: x and y split channel-cells without any noise. (SMALL's
# round focal length puts many noise-free pixels on voxel boundaries, where
# the float32 floors and the oracle's float64 ones part by design.)
SETUPS = {
    "eval_quarter": (QUARTER, eval_params(), None, 3),
    "live_eighth_cell4": (EIGHTH, live_params(max_points=1024), 4, 3),
}


def _setup(name):
    intr, params, cell_px, radius = SETUPS[name]
    cell = cell_px or pre.default_cell_px(params.downsample_leaf_size, intr.fx)
    return intr, params, cell, radius


def _args(intr, params, cell, rgb, depth, occ):
    return (torch.from_numpy(rgb), torch.from_numpy(depth.view(np.int16)), torch.from_numpy(occ),
            intr.fx, intr.fy, intr.cx, intr.cy, params.hsv_lower, params.hsv_upper,
            params.multi_color_dlo, cell)


def _route(intr, params, cell, rgb, depth, occ, exact=True):
    pc = pre.preprocess_frame(*_args(intr, params, cell, rgb, depth, occ), params.max_points,
                              voxel_leaf=params.downsample_leaf_size,
                              candidate_cap=params.candidate_cap(), exact=exact)
    return pc.points.numpy()[pc.mask.numpy()].astype(np.float64)


def _oracle(intr, params, rgb, depth, occ):
    return oracle.preprocess_frame(rgb, depth, params, intr, occ)


def _torch_reference(intr, params, cell, rgb, depth, occ):
    a = _args(intr, params, cell, rgb, depth, occ)
    return voxel_grid_torch.preprocess_frame(*a[:10], params.downsample_leaf_size).numpy()


def _far(a, b):
    """Points of ``a`` farther than TOL_M from every point of ``b``."""
    if len(a) == 0 or len(b) == 0:
        return len(a)
    return int((np.linalg.norm(a[:, None] - b[None], axis=2).min(1) > TOL_M).sum())


def _frame(intr, radius, noise_mm, dropout, t=0.4, seed=5, band=None):
    rgb, depth = render_frame(SyntheticRope(), t, intr, rope_pixel_radius=radius,
                              depth_noise_mm=noise_mm, seed=seed, markers=12,
                              dropout_frac=dropout)
    occ = np.ones((intr.height, intr.width), bool)
    if band is not None:
        occ[:, int(band[0] * intr.width):int(band[1] * intr.width)] = False
    return rgb, depth, occ


@pytest.mark.parametrize("name", sorted(SETUPS))
@pytest.mark.parametrize("noise_mm,dropout", [(0.0, 0.0), (0.5, 0.0), (2.0, 0.05)])
def test_exact_route_and_torch_reference_match_the_oracle(name, noise_mm, dropout):
    intr, params, cell, radius = _setup(name)
    for t, band in ((0.4, None), (1.1, (0.3, 0.55))):
        rgb, depth, occ = _frame(intr, radius, noise_mm, dropout, t=t, band=band)
        want = _oracle(intr, params, rgb, depth, occ)
        for got in (_route(intr, params, cell, rgb, depth, occ),
                    _torch_reference(intr, params, cell, rgb, depth, occ)):
            assert len(got) == len(want) > 50
            assert _far(got, want) == 0 and _far(want, got) == 0


TWO_VOXEL_CELL = (60, 80)  # (v0, u0): a 2x2 cell at SMALL's principal point


def _two_voxel_cell():
    """One 2x2 cell of rope pixels at SMALL's principal point (one x and y
    voxel), its rows 16 mm apart in depth at the 8 mm leaf: z voxels k and
    k+2, one parity, one cell."""
    intr, params = SMALL, live_params(max_points=256)
    rgb = np.full((intr.height, intr.width, 3), 120, np.uint8)
    depth = np.zeros((intr.height, intr.width), np.uint16)
    v0, u0 = TWO_VOXEL_CELL
    rgb[v0:v0 + 2, u0:u0 + 2] = (30, 60, 200)
    depth[v0:v0 + 2, u0:u0 + 2] = np.array([640, 656], np.uint16)[:, None]
    return intr, params, 2, rgb, depth, np.ones(depth.shape, bool)


def test_cell_spanning_voxels_k_and_k_plus_2_keeps_both():
    """The JAX package's parity route merges the two voxels of one parity
    into one candidate and keeps one voxel; the exact route keeps both, at
    the oracle's centroids."""
    intr, params, cell, rgb, depth, occ = _two_voxel_cell()
    want = _oracle(intr, params, rgb, depth, occ)
    assert len(want) == 2 and np.ptp(want[:, 2]) == pytest.approx(0.016, abs=1e-6)
    got = _route(intr, params, cell, rgb, depth, occ)
    assert len(got) == 2 and _far(got, want) == 0 and _far(want, got) == 0
    assert len(_route(intr, params, cell, rgb, depth, occ, exact=False)) == 1


def test_split_channel_cell_is_left_at_zero_and_marked():
    intr, params, cell, rgb, depth, occ = _two_voxel_cell()
    a = _args(intr, params, cell, rgb, depth, occ)
    legacy = pre.cell_sums_plain(*a, params.downsample_leaf_size)
    got = pre.cell_sums_plain(*a, params.downsample_leaf_size, exact=True)
    split = got[4]
    v0, u0 = TWO_VOXEL_CELL
    c0 = (v0 // cell) * -(-intr.width // cell) + u0 // cell
    assert int(split.mask[c0]) != 0 and int(split.mask.sum()) == int(split.mask[c0])
    chans = [c for c in range(8) if (int(split.mask[c0]) >> c) & 1]
    assert int(split.counts[0, 0]) == len(chans) and int(split.counts[0, 1]) == 0
    for c in chans:
        assert float(legacy[3][c, c0]) > 0
        assert all(float(q[c, c0]) == 0.0 for q in got[:4])
    keep = torch.ones_like(got[3], dtype=torch.bool)
    keep[chans, c0] = False
    for q, r in zip(got[:4], legacy):
        assert torch.equal(q[keep], r[keep])


def test_masked_pixels_without_depth_land_at_the_origin():
    """Dropout on rope pixels: the oracle keeps one voxel at the origin;
    the exact route gives it too (one candidate, however many pixels),
    the JAX package's route drops it."""
    intr, params, cell, radius = _setup("eval_quarter")
    rgb, depth, occ = _frame(intr, radius, 0.0, 0.05)
    want = _oracle(intr, params, rgb, depth, occ)
    at_origin = np.all(want == 0.0, axis=1)
    assert at_origin.sum() == 1
    got = _route(intr, params, cell, rgb, depth, occ)
    assert len(got) == len(want) and np.all(got == 0.0, axis=1).sum() == 1
    assert _far(got, want) == 0
    sums = pre.cell_sums_plain(*_args(intr, params, cell, rgb, depth, occ),
                               params.downsample_leaf_size, exact=True)
    masked = pre.segment_mask(torch.from_numpy(rgb), params.hsv_lower, params.hsv_upper,
                              params.multi_color_dlo).numpy() & occ
    assert int(sums[4].counts[0, 1]) == int((masked & (depth == 0)).sum()) > 0
    legacy = _route(intr, params, cell, rgb, depth, occ, exact=False)
    assert not np.all(legacy == 0.0, axis=1).any()


def test_clean_frames_keep_the_jax_routes_bits():
    """Where no channel-cell spans two voxels and no masked pixel lacks
    depth, the exact route's cloud is the JAX package's route's, bit for
    bit: kernel X adds nothing."""
    intr, params, cell, radius = _setup("eval_quarter")
    rgb, depth, occ = _frame(intr, radius, 0.0, 0.0)
    a = _args(intr, params, cell, rgb, depth, occ)
    sums = pre.cell_sums_plain(*a, params.downsample_leaf_size, exact=True)
    assert int(sums[4].counts.sum()) == 0
    leaf, cap = params.downsample_leaf_size, params.candidate_cap()
    got = pre.preprocess_frame(*a, params.max_points, leaf, cap, exact=True)
    ref = pre.preprocess_frame(*a, params.max_points, leaf, cap, exact=False)
    assert torch.equal(got.points, ref.points) and torch.equal(got.mask, ref.mask)


def test_groups_follow_the_packed_cells_and_respect_the_row_capacity():
    """Kernel X's plain version appends a channel's groups after its row's
    packed cells and the origin after channel 0's, and drops what passes
    ``cap_per``."""
    intr, params, cell, radius = _setup("eval_quarter")
    rgb, depth, occ = _frame(intr, radius, 2.0, 0.05)
    a = _args(intr, params, cell, rgb, depth, occ)
    leaf = params.downsample_leaf_size
    sums = pre.cell_sums_plain(*a, leaf, exact=True)
    frame = pre.exact_frame(a + (leaf,), sums)
    for cap_per in (256, 8):
        pts, cnt, valid = pre.compact_occupied_channels_plain(*sums[:4], cap_per, True)
        p2, c2, v2 = pre.split_groups_plain(frame, pts, cnt, valid)
        before, after = valid.sum(-1), v2.sum(-1)
        assert torch.equal(p2[valid], pts[valid]) and torch.equal(c2[valid], cnt[valid])
        assert (after >= before).all() and (after <= cap_per).all()
        for row in range(8):  # every row a prefix of valid slots
            assert v2[row, :int(after[row])].all() and not v2[row, int(after[row]):].any()
        origin = (p2 == 0).all(-1) & v2
        if cap_per == 256:
            assert int((after - before).sum()) > 8
            assert int(origin.sum()) == 1 and bool(origin[0, int(after[0]) - 1])
            assert float(c2[0, int(after[0]) - 1]) == float(sums[4].counts[0, 1])
        else:
            assert (after == cap_per).all()


def test_batched_exact_route_is_each_stream_alone():
    intr, params, cell, radius = _setup("live_eighth_cell4")
    frames = [_frame(intr, radius, 2.0, 0.05, t=t, seed=s) for t, s in ((0.2, 1), (0.9, 2))]
    stack = [np.stack(x) for x in zip(*frames)]
    leaf, cap = params.downsample_leaf_size, params.candidate_cap()
    both = pre.preprocess_frame(*_args(intr, params, cell, *stack), params.max_points, leaf, cap,
                                exact=True)
    for b, f in enumerate(frames):
        one = pre.preprocess_frame(*_args(intr, params, cell, *f), params.max_points, leaf, cap,
                                   exact=True)
        assert torch.equal(both.points[b], one.points) and torch.equal(both.mask[b], one.mask)


def test_torch_reference_imports_only_torch():
    """The torch reference imports no module of the port's, of JAX's or of
    the JAX package's, and turns TF32 off once it is imported."""
    import ast

    path = Path(voxel_grid_torch.__file__)
    tree = ast.parse(path.read_text())
    names = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    assert names == {"__future__", "torch"}
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
