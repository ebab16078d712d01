"""The port's parity-split preprocessing (cell_sums_plain, kernel P's plain
version, then the sort compaction, kernel C's plain version, and the voxel
snap) against the JAX package's XLA preprocess_frame(parity_split=True) and
its Pallas cell-sums and one-hot compaction kernels run in interpret mode.

Bounds: the cloud's point count equal (count_delta 0), and the 95th
percentile of each port point's distance to the nearest JAX point within
1e-6 m; the per-pixel parity channels bit-equal."""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trackdlo_tpu.config import CameraIntrinsics, live_params
from trackdlo_tpu.io.sequence import SyntheticRope, render_frame
from trackdlo_tpu_torch.ops import preprocess as tpre
from trackdlo_tpu_torch.ops.preprocess_kernel import cell_sums, parity_grid_shape

jpre = importlib.import_module("trackdlo_tpu.ops.preprocess")
jker = importlib.import_module("trackdlo_tpu.ops.preprocess_kernel")

LIVE = CameraIntrinsics()
QUARTER = CameraIntrinsics(fx=LIVE.fx / 4, fy=LIVE.fy / 4, cx=LIVE.cx / 4, cy=LIVE.cy / 4,
                           width=LIVE.width // 4, height=LIVE.height // 4)
SMALL = CameraIntrinsics(fx=120.0, fy=120.0, cx=80.0, cy=60.0, width=160, height=120)

# name: (intrinsics, max_points, cell_px or None for the leaf-derived size,
#        rope radius px, occluded column band as fractions of the width)
CASES = {
    "small_overflow": (SMALL, 256, 4, 3, None),
    "quarter": (QUARTER, 512, None, 3, None),
    "quarter_occluded": (QUARTER, 512, None, 3, (0.39, 0.625)),
    "live_720p": (LIVE, 4096, None, 9, (0.39, 0.625)),
}
P95_TOL_M = 1e-6


def _frame(name, t=1 / 15.0):
    intr, max_points, cell_px, radius, band = CASES[name]
    params = live_params(max_points=max_points, downsample_cell_px=cell_px)
    cell = cell_px or tpre.default_cell_px(params.downsample_leaf_size, intr.fx)
    rgb, depth = render_frame(SyntheticRope(), t, intr, rope_pixel_radius=radius)
    occ = np.ones((intr.height, intr.width), bool)
    if band is not None:
        occ[:, int(band[0] * intr.width):int(band[1] * intr.width)] = False
    return intr, params, cell, rgb, depth, occ


def _common(intr, params, cell):
    return (intr.fx, intr.fy, intr.cx, intr.cy, params.hsv_lower, params.hsv_upper,
            params.multi_color_dlo, cell)


def _torch_frame(rgb, depth, occ):
    return torch.from_numpy(rgb), torch.from_numpy(depth.view(np.int16)), torch.from_numpy(occ)


def _cloud(pc):
    pts = pc.points.numpy() if isinstance(pc.points, torch.Tensor) else np.asarray(pc.points)
    msk = pc.mask.numpy() if isinstance(pc.mask, torch.Tensor) else np.asarray(pc.mask)
    return pts[msk]


def _p95(a, b):
    if len(a) == 0:
        return 0.0
    d = np.linalg.norm(a[:, None] - b[None], axis=2).min(1)
    return float(np.percentile(d, 95))


@pytest.mark.parametrize("name", sorted(CASES))
def test_preprocess_matches_jax_xla(name):
    intr, params, cell, rgb, depth, occ = _frame(name)
    leaf, cap = params.downsample_leaf_size, params.candidate_cap()
    got = tpre.preprocess_frame(*_torch_frame(rgb, depth, occ), *_common(intr, params, cell),
                                params.max_points, voxel_leaf=leaf, candidate_cap=cap)
    ref = jpre.preprocess_frame(jnp.asarray(rgb), jnp.asarray(depth), jnp.asarray(occ),
                                *_common(intr, params, cell), params.max_points,
                                voxel_leaf=leaf, candidate_cap=cap, parity_split=True)
    assert int(got.count) == int(ref.count) > 0
    a, b = _cloud(got), _cloud(ref)
    assert _p95(a, b) <= P95_TOL_M
    assert _p95(b, a) <= P95_TOL_M


@pytest.mark.parametrize("name", ["small_overflow", "quarter_occluded"])
def test_cell_sums_match_interpreted_kernel(name):
    intr, params, cell, rgb, depth, occ = _frame(name)
    leaf = params.downsample_leaf_size
    got = tpre.cell_sums_plain(*_torch_frame(rgb, depth, occ), *_common(intr, params, cell), leaf)
    ref = jker.cell_sums_pallas(jnp.asarray(rgb), jnp.asarray(depth), jnp.asarray(occ),
                                *_common(intr, params, cell), interpret=True,
                                parity_split=True, voxel_leaf=leaf, channel_grids=True)
    # The kernel's grids are padded to (8, 128) tiles; the port's are not.
    rows_pad, cols_pad, n_rows, n_cols = jker.parity_grid_shape(intr.height, intr.width, cell)
    assert parity_grid_shape(intr.height, intr.width, cell) == (n_rows, n_cols)
    trim = lambda a: np.asarray(a).reshape(8, rows_pad, cols_pad)[:, :n_rows, :n_cols].reshape(8, -1)
    ref = [trim(r) for r in ref]
    np.testing.assert_array_equal(got[3].numpy(), ref[3])  # counts: count_delta 0
    for g, r in zip(got[:3], ref[:3]):
        # Sums of up to cell_px² coordinates below 1 m, added in another
        # order: a few float32 ulps of the sum.
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=2e-6)
    # The same compaction from either grid gives the same cloud.
    a = tpre.compact_parity_channels(*got, params.max_points, leaf, params.candidate_cap(),
                                     inputs_are_sums=True)
    b = tpre.compact_parity_channels(*(torch.from_numpy(r) for r in ref), params.max_points, leaf,
                                     params.candidate_cap(), inputs_are_sums=True)
    assert int(a.count) == int(b.count)
    assert _p95(_cloud(a), _cloud(b)) <= P95_TOL_M


@pytest.mark.parametrize("name,cap_per", [("small_overflow", None), ("quarter_occluded", None),
                                          ("quarter_occluded", 8)])
def test_compaction_matches_interpreted_onehot_kernel(name, cap_per):
    """Kernel C's plain version against the one-hot Pallas compaction in
    interpret mode, on the same kept cells: every output bit-equal (each
    valid slot is a copy of one cell; later slots are zero and invalid).
    ``cap_per=8`` leaves kept cells beyond the slots."""
    intr, params, cell, rgb, depth, occ = _frame(name)
    sums = tpre.cell_sums_plain(*_torch_frame(rgb, depth, occ), *_common(intr, params, cell),
                                params.downsample_leaf_size)
    cap_per = cap_per or params.candidate_cap() // 8
    kept = tpre.kept_cells(sums[3], cap_per)
    got = tpre.compact_channels_plain(*sums, kept, cap_per)
    ref = jker.compact_onehot_pallas(*(jnp.asarray(a.numpy()) for a in (*sums, kept)), cap_per,
                                     interpret=True)
    assert int(got[2].sum()) > 0
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_kept_cells_thin_an_overflow_evenly():
    counts = torch.zeros((2, 40))
    counts[0, ::2] = 1.0  # 20 occupied cells for 8 slots
    counts[1, :5] = 3.0  # 5 occupied cells: all kept
    kept = tpre.kept_cells(counts, 8)
    assert int(kept[0].sum()) == 8 and torch.equal(kept[1], counts[1] > 0)
    gaps = torch.diff(torch.nonzero(kept[0])[:, 0])
    assert int(gaps.min()) >= 4 and int(gaps.max()) <= 6


def test_parity_bits_match_jax_for_every_u16_depth():
    """All 65536 depths at the 8 mm leaf, over a spread of pixel columns and
    rows: the bit-pinned floors agree with JAX bit for bit, and z with the
    integer floor."""
    params = live_params()
    depth = np.arange(65536, dtype=np.float32)
    rng = np.random.default_rng(0)
    us = rng.integers(0, LIVE.width, depth.shape).astype(np.float32)
    vs = rng.integers(0, LIVE.height, depth.shape).astype(np.float32)
    args = (LIVE.fx, LIVE.fy, LIVE.cx, LIVE.cy, params.downsample_leaf_size)
    got = tpre.voxel_parity_bits(torch.from_numpy(us), torch.from_numpy(vs), torch.from_numpy(depth), *args)
    ref = jpre.voxel_parity_bits(jnp.asarray(us), jnp.asarray(vs), jnp.asarray(depth), *args)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    np.testing.assert_array_equal(got[2].numpy(), (np.arange(65536) // 8) & 1)


@pytest.mark.parametrize("multi_color", [False, True])
def test_segment_mask_matches_jax(multi_color):
    rng = np.random.default_rng(1)
    rgb = rng.integers(0, 256, (64, 96, 3), dtype=np.uint8)
    rgb[:8] = (30, 60, 200)  # the rope's blue
    params = live_params()
    got = tpre.segment_mask(torch.from_numpy(rgb), params.hsv_lower, params.hsv_upper, multi_color)
    ref = jpre.segment_mask(jnp.asarray(rgb), params.hsv_lower, params.hsv_upper, multi_color)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert bool(got.any())


def test_only_the_parity_voxel_path_is_ported():
    """Once only the parity path was ported and the others raised; now every
    path runs, case for case: ``voxel_leaf=None`` gives the cells-only cloud
    and ``Tracker`` steps with ``parity_split=False`` (held against JAX in
    tests/test_torch_coarse.py)."""
    intr, params, cell, rgb, depth, occ = _frame("small_overflow")
    pc = tpre.preprocess_frame(*_torch_frame(rgb, depth, occ), *_common(intr, params, cell),
                               params.max_points, voxel_leaf=None)
    assert pc.points.shape == (params.max_points, 3) and int(pc.count) > 0
    from trackdlo_tpu_torch.models.trackdlo import Tracker

    coarse = dataclasses.replace(params, parity_split=False)
    state, out = Tracker(coarse, intr, device="cpu").step(
        Tracker(params, intr, device="cpu").init_from_nodes(SyntheticRope().nodes(0.0, params.M)),
        rgb, depth,
    )
    assert int(out.n_points) > 0 and bool(torch.isfinite(state.y).all())


def test_wrapper_takes_plain_version_on_cpu():
    intr, params, cell, rgb, depth, occ = _frame("small_overflow")
    args = (*_torch_frame(rgb, depth, occ), *_common(intr, params, cell), params.downsample_leaf_size)
    sums = cell_sums(*args)
    for a, b in zip(sums, tpre.cell_sums_plain(*args)):
        assert torch.equal(a, b)
    cap_per = params.candidate_cap() // 8
    kept = tpre.kept_cells(sums[3], cap_per)
    for a, b in zip(tpre.compact_channels(*sums, kept, cap_per),
                    tpre.compact_channels_plain(*sums, kept, cap_per)):
        assert torch.equal(a, b)


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("name,cap_per", [("small_overflow", 8), ("quarter_occluded", 16),
                                          ("quarter_occluded", 256)])
def test_occupied_compaction_matches_jax(name, cap_per, monkeypatch):
    """Kernel C's derived mode in plain tensor ops (kept_cells, the
    packed-key sort, the centroid division) against the JAX package on the
    same raw sums: compact_parity_channels(use_onehot_compact=True,
    inputs_are_sums=True) with no voxel leaf, whose thinning feeds the
    one-hot Pallas compaction (interpreted) and whose output is the divided
    slots. The kept cells, the compaction's counts and valid flags and the
    centroids bit-equal; the first two cases thin an overflow."""
    intr, params, cell, rgb, depth, occ = _frame(name)
    sums = tpre.cell_sums_plain(*_torch_frame(rgb, depth, occ), *_common(intr, params, cell),
                                params.downsample_leaf_size)
    got = tpre.compact_occupied_channels_plain(*sums, cap_per, inputs_are_sums=True)
    seen = {}
    real = jker.compact_onehot_pallas

    def spy(xs, ys, zs, counts, kept, cap, **kw):
        out = real(xs, ys, zs, counts, kept, cap, **kw)
        seen.update(kept=np.asarray(kept), cnt=np.asarray(out[1]), valid=np.asarray(out[2]))
        return out

    monkeypatch.setattr(jker, "compact_onehot_pallas", spy)
    ref = jpre.compact_parity_channels(*(jnp.asarray(s.numpy()) for s in sums), 8 * cap_per, None, 0,
                                       use_onehot_compact=True, inputs_are_sums=True)
    thinned = int((sums[3] > 0).sum(1).max()) > cap_per
    assert thinned == (cap_per < 256)
    np.testing.assert_array_equal(tpre.kept_cells(sums[3], cap_per).numpy(), seen["kept"])
    np.testing.assert_array_equal(_bits(got[1]), _bits(seen["cnt"]))
    np.testing.assert_array_equal(got[2].numpy(), seen["valid"])
    np.testing.assert_array_equal(_bits(got[0].reshape(-1, 3)), _bits(ref.points))
    np.testing.assert_array_equal(got[2].reshape(-1).numpy(), np.asarray(ref.mask))
    assert int(got[2].sum()) == min(int(ref.count), 8 * cap_per) > 0


def test_card_route_runs_no_op_between_p_and_c(monkeypatch):
    """The parity preprocessing's card route (preprocess_for_step on meta
    tensors, the launches faked): between kernel P's launch and kernel C's
    only views of P's outputs and C's output allocations run, no operation
    with device work; C takes the derived mode (no kept flags) with the
    centroid division."""
    import ctypes

    from torch.utils._python_dispatch import TorchDispatchMode

    from trackdlo_tpu_torch import _build
    from trackdlo_tpu_torch.config import CameraIntrinsics as TCam, live_params as t_live
    from trackdlo_tpu_torch.models.trackdlo import preprocess_for_step

    ops, launches = [], []

    class Log(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ops.append(func)
            return func(*args, **(kwargs or {}))

    class Stop(Exception):
        pass

    class Lib:
        def trackdlo_cell_sums_grid(self, h, w, cell_px, mode, out):
            grid = (ctypes.c_int * 2).from_address(out)
            grid[0], grid[1] = 32, -(-(-(-w // cell_px)) // 32) * -(-h // cell_px)
            return 0

        def trackdlo_cell_sums(self, *args):
            launches.append(("P", len(ops), args))
            return 0

        def trackdlo_compact(self, *args):
            launches.append(("C", len(ops), args))
            raise Stop  # the snap after C needs real tensors

    monkeypatch.setattr(_build, "require_cuda", lambda *a, **k: torch.device("meta"))
    monkeypatch.setattr(_build, "lib", lambda: Lib())
    monkeypatch.setattr(_build, "stream_ptr", lambda dev: 0)
    monkeypatch.setattr(_build, "launch_counts", dict(_build.launch_counts))
    params, intr = t_live(), TCam()
    h, w = intr.height, intr.width
    frame = (torch.empty((h, w, 3), dtype=torch.uint8, device="meta"),
             torch.empty((h, w), dtype=torch.int16, device="meta"),
             torch.empty((h, w), dtype=torch.bool, device="meta"))
    cell = tpre.default_cell_px(params.downsample_leaf_size, intr.fx)
    with Log(), pytest.raises(Stop):
        preprocess_for_step(*frame, params=params, intr=intr, cell_px=cell)
    assert [k for k, _, _ in launches] == ["P", "C"]
    between = ops[launches[0][1]:launches[1][1]]
    assert between and all(f.is_view or f.overloadpacket.__name__ == "empty" for f in between), between
    c_args = launches[1][2]
    assert c_args[4] is None and c_args[8] == 1  # kept derived in the launch; divide
    assert _build.launch_counts["cell_sums"] == 1 and _build.launch_counts["compact"] == 0


@pytest.mark.parametrize("cap_per", [256, 16])
def test_occupied_compaction_wrapper_takes_plain_version_on_cpu(cap_per):
    intr, params, cell, rgb, depth, occ = _frame("quarter_occluded")
    sums = cell_sums(*_torch_frame(rgb, depth, occ), *_common(intr, params, cell),
                     params.downsample_leaf_size)
    for div in (False, True):
        got = tpre.compact_occupied_channels(*sums, cap_per, div)
        ref = tpre.compact_occupied_channels_plain(*sums, cap_per, div)
        kept = tpre.compact_channels_plain(*sums, tpre.kept_cells(sums[3], cap_per), cap_per)
        for a, b, k in zip(got, ref, kept):
            assert torch.equal(a, b)
        assert torch.equal(got[1], kept[1]) and torch.equal(got[2], kept[2])
        if not div:
            assert torch.equal(got[0], kept[0])
