"""The port's single-channel preprocessing (the coarse two-stage path,
``parity_split=False``, and the cells-only path, ``exact_voxels=False``)
against the JAX package, on the CPU where kernel P's wrapper takes its plain
version:

- the plain single-channel pooling against JAX ``preprocess_frame`` and its
  Pallas ``cell_sums_pallas`` run in interpret mode: counts and vote sums
  bit-equal, centroids within 1e-6 m at the 95th percentile;
- ``pack_vote_keys``, ``voxel_snap`` (both key branches) and single-channel
  ``compact_cells`` bit-equal to JAX on the same seeded inputs, including
  the overflow cases of tests/test_pipeline.py;
- ``Tracker``, the batched step and ``MultiTracker`` with the coarse
  profiles against the JAX Tracker and the port's own single stream."""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trackdlo_tpu.config import CameraIntrinsics, live_params
from trackdlo_tpu.io.sequence import SyntheticRope, render_frame
from trackdlo_tpu_torch.convert import state_from_numpy
from trackdlo_tpu_torch.models.multi import MultiTracker
from trackdlo_tpu_torch.models.trackdlo import Tracker
from trackdlo_tpu_torch.ops import preprocess as tpre
from trackdlo_tpu_torch.ops.preprocess_kernel import cell_sums
from trackdlo_tpu_torch.parallel import build_batched_step_fn, replicate_state

jpre = importlib.import_module("trackdlo_tpu.ops.preprocess")
jker = importlib.import_module("trackdlo_tpu.ops.preprocess_kernel")

LIVE = CameraIntrinsics()
QUARTER = CameraIntrinsics(fx=LIVE.fx / 4, fy=LIVE.fy / 4, cx=LIVE.cx / 4, cy=LIVE.cy / 4,
                           width=LIVE.width // 4, height=LIVE.height // 4)
SMALL = CameraIntrinsics(fx=120.0, fy=120.0, cx=80.0, cy=60.0, width=160, height=120)
# The small camera of tests/test_torch_tracker.py: the painter's line width
# scales with the rope's image (40 px live).
SMALL_PARAMS = live_params(max_points=256, downsample_cell_px=4, dlo_pixel_width=5)
PROFILES = {"coarse": {"parity_split": False}, "cells": {"exact_voxels": False}}
# name: (intrinsics, max_points, cell_px or None for the leaf-derived size,
#        rope radius px, occluded column band as fractions of the width)
CASES = {
    "small": (SMALL, 256, 4, 3, None),
    "quarter_occluded": (QUARTER, 512, None, 3, (0.39, 0.625)),
}
P95_TOL_M = 1e-6
# Per frame from one state: the open-loop step bound of test_torch_tracker.py.
STEP_TOL_M = 5e-4
B = 3


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
@pytest.mark.parametrize("with_votes", [True, False])
def test_single_channel_sums_match_interpreted_kernel(name, with_votes):
    """Counts and floor-vote sums bit-equal to the Pallas kernel's; the
    centroids of the occupied cells within 1e-6 m at the 95th percentile."""
    intr, params, cell, rgb, depth, occ = _frame(name)
    leaf = params.downsample_leaf_size if with_votes else None
    got = tpre.cell_sums_plain(*_torch_frame(rgb, depth, occ), *_common(intr, params, cell), leaf,
                               parity_split=False, with_votes=with_votes)
    assert len(got) == (7 if with_votes else 4)
    ref = jker.cell_sums_pallas(jnp.asarray(rgb), jnp.asarray(depth), jnp.asarray(occ),
                                *_common(intr, params, cell), interpret=True, parity_split=False,
                                voxel_leaf=leaf, with_votes=with_votes)
    cells, counts = np.asarray(ref[0]), np.asarray(ref[1])
    np.testing.assert_array_equal(got[3].numpy(), counts)
    occupied = counts > 0
    assert occupied.sum() > 0
    if with_votes:
        np.testing.assert_array_equal(torch.stack(got[4:], -1).numpy(), np.asarray(ref[2]))
    cent = torch.stack(got[:3], -1).numpy() / np.maximum(counts, 1.0)[:, None]
    d = np.linalg.norm(cent[occupied] - cells[occupied], axis=1)
    assert np.percentile(d, 95) <= P95_TOL_M


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("profile", ["coarse", "cells"])
def test_preprocess_matches_jax_xla(name, profile):
    intr, params, cell, rgb, depth, occ = _frame(name)
    leaf = params.downsample_leaf_size if profile == "coarse" else None
    cap = params.candidate_cap()
    got = tpre.preprocess_frame(*_torch_frame(rgb, depth, occ), *_common(intr, params, cell),
                                params.max_points, voxel_leaf=leaf, candidate_cap=cap,
                                parity_split=False)
    ref = jpre.preprocess_frame(jnp.asarray(rgb), jnp.asarray(depth), jnp.asarray(occ),
                                *_common(intr, params, cell), params.max_points, voxel_leaf=leaf,
                                candidate_cap=cap, parity_split=False)
    assert got.points.shape == ref.points.shape
    assert int(got.count) == int(ref.count) > 0
    a, b = _cloud(got), _cloud(ref)
    assert _p95(a, b) <= P95_TOL_M
    assert _p95(b, a) <= P95_TOL_M


def test_pack_vote_keys_match_jax():
    rng = np.random.default_rng(0)
    n = 500
    counts = rng.integers(0, 122, n).astype(np.float32)
    counts[rng.random(n) < 0.4] = 0.0
    # Vote sums of pixels spread over two neighbouring voxels per axis.
    base = rng.integers(-90, 90, (n, 3))
    frac = rng.random((n, 3))
    key_sums = np.floor((base + frac) * counts[:, None]).astype(np.float32)
    valid = counts > 0
    got = tpre.pack_vote_keys(torch.from_numpy(key_sums), torch.from_numpy(counts),
                              torch.from_numpy(valid))
    ref = jpre.pack_vote_keys(jnp.asarray(key_sums), jnp.asarray(counts), jnp.asarray(valid))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _candidates(seed, c=400, dup=True):
    """Candidate centroids on a rope-like arc, a third of them on voxels
    shared with another, weights 0 (invalid) or pixel counts."""
    rng = np.random.default_rng(seed)
    s = rng.random(c)
    pts = np.stack([0.3 * s - 0.15, 0.05 * np.sin(6 * s), 0.65 + 0.02 * s], 1)
    if dup:
        pts[1::3] = pts[0::3][: len(pts[1::3])] + rng.normal(0, 0.001, (len(pts[1::3]), 3))
    w = rng.integers(1, 60, c).astype(np.float32)
    w[rng.random(c) < 0.25] = 0.0
    return pts.astype(np.float32), w


@pytest.mark.parametrize("branch", ["vote_keys", "floor_keys"])
def test_voxel_snap_matches_jax(branch):
    pts, w = _candidates(1)
    leaf = 0.008
    keys = None
    if branch == "vote_keys":
        votes = np.floor(pts / leaf + np.random.default_rng(2).random(pts.shape) * 0.2)
        keys = tpre.pack_vote_keys(torch.from_numpy((votes * 3).astype(np.float32)),
                                   torch.full((len(w),), 3.0), torch.from_numpy(w > 0))
    got = tpre.voxel_snap(torch.from_numpy(pts), torch.from_numpy(w), leaf, keys)
    ref = jpre.voxel_snap(jnp.asarray(pts), jnp.asarray(w), leaf,
                          None if keys is None else jnp.asarray(keys.numpy()))
    assert 0 < int(got[1].sum()) < int((w > 0).sum())  # some candidates merged
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))


def _line_cells(n, axis, n_cells=1024):
    cells = np.zeros((n_cells, 3), np.float32)
    counts = np.zeros(n_cells, np.float32)
    cells[:n, axis] = np.arange(n) * 0.010
    counts[:n] = 1.0
    return cells, counts


# name: (cells, counts, max_points, voxel leaf, candidate cap, with vote sums)
def _compaction_case(name):
    if name == "voxel_overflow":  # tests/test_pipeline.py: 600 voxels for 256 slots
        return (*_line_cells(600, 0), 256, 0.008, 1024, False)
    if name == "no_overflow_identity":
        return (*_line_cells(100, 0), 256, 0.008, 1024, False)
    if name == "cell_overflow_no_voxel":  # even-stride thinning of the cells
        return (*_line_cells(600, 1), 256, None, 1024, False)
    if name == "cells_fit_no_voxel":
        return (*_line_cells(100, 1), 256, None, 1024, False)
    if name == "fewer_cells_than_cap":  # the pad to the static cap
        cells, counts = _line_cells(60, 0, n_cells=300)
        return cells, counts, 256, 0.008, 1024, True
    if name == "candidate_cap_binds":  # more occupied cells than candidates
        cells, counts = _line_cells(700, 0)
        return cells, counts, 512, 0.008, 512, True
    pts, w = _candidates(3, c=900)  # "rope_votes"
    return pts, w, 256, 0.008, 2048, True


@pytest.mark.parametrize("name", ["voxel_overflow", "no_overflow_identity", "cell_overflow_no_voxel",
                                  "cells_fit_no_voxel", "fewer_cells_than_cap",
                                  "candidate_cap_binds", "rope_votes"])
def test_compact_cells_match_jax(name):
    cells, counts, max_points, leaf, cap, votes = _compaction_case(name)
    key_sums = None
    if votes:
        v = np.floor(cells / 0.008 + np.random.default_rng(4).random(cells.shape) * 0.3)
        key_sums = (v * counts[:, None]).astype(np.float32)
    t = lambda a: None if a is None else torch.from_numpy(a)
    got = tpre.compact_cells(*(t(cells[:, k].copy()) for k in range(3)), t(counts), max_points, leaf,
                             candidate_cap=cap, key_sums=t(key_sums))
    ref = jpre.compact_cells(jnp.asarray(cells), jnp.asarray(counts), max_points, leaf,
                             candidate_cap=cap, n_channels=1,
                             key_sums=None if key_sums is None else jnp.asarray(key_sums))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
    np.testing.assert_array_equal(got.points.numpy(), np.asarray(ref.points))
    assert int(got.count) == int(ref.count) > 0
    # Raw sums divided after the pack give the same cloud.
    sums = cells * np.maximum(counts, 1.0)[:, None]
    again = tpre.compact_cells(*(t(sums[:, k].copy()) for k in range(3)), t(counts), max_points,
                               leaf, candidate_cap=cap, key_sums=t(key_sums), inputs_are_sums=True)
    assert int(again.count) == int(got.count)
    np.testing.assert_allclose(again.points.numpy(), got.points.numpy(), rtol=0, atol=2e-7)


def test_batched_compaction_is_row_local():
    """Three streams' cells in one call: each stream's cloud bit-equal to its
    own call (the vote-key minimum and the thinning are per stream)."""
    rows = [_compaction_case(n) for n in ("voxel_overflow", "no_overflow_identity", "rope_votes")]
    n = 900
    stack = lambda k: torch.stack([torch.from_numpy(np.resize(r[k], (n,) + r[k].shape[1:])) for r in rows])
    cells, counts = stack(0), stack(1)
    ks = torch.floor(cells / 0.008) * counts[..., None]
    got = tpre.compact_cells(cells[..., 0], cells[..., 1], cells[..., 2], counts, 256, 0.008,
                             candidate_cap=1024, key_sums=ks)
    for b in range(3):
        one = tpre.compact_cells(cells[b, :, 0], cells[b, :, 1], cells[b, :, 2], counts[b], 256,
                                 0.008, candidate_cap=1024, key_sums=ks[b])
        assert torch.equal(got.points[b], one.points) and torch.equal(got.mask[b], one.mask)


def test_wrapper_takes_plain_version_on_cpu():
    intr, params, cell, rgb, depth, occ = _frame("small")
    for leaf, votes in ((params.downsample_leaf_size, True), (None, False)):
        args = (*_torch_frame(rgb, depth, occ), *_common(intr, params, cell), leaf)
        got = cell_sums(*args, parity_split=False, with_votes=votes)
        ref = tpre.cell_sums_plain(*args, parity_split=False, with_votes=votes)
        assert len(got) == len(ref) and all(torch.equal(a, b) for a, b in zip(got, ref))
    with pytest.raises(ValueError):
        cell_sums(*args, parity_split=False, with_votes=True)  # votes need a leaf


@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_step_matches_jax_frame_by_frame(profile):
    """Five frames, two of them occluded, each from the JAX state: the
    cloud's size and the occlusion state equal, y within the open-loop step
    bound."""
    from trackdlo_tpu.models.trackdlo import Tracker as JaxTracker

    params = dataclasses.replace(SMALL_PARAMS, **PROFILES[profile])
    rope = SyntheticRope()
    jt = JaxTracker(params, SMALL)
    tt = Tracker(params, SMALL, device="cpu")
    js = jt.init_from_nodes(rope.nodes(0.0, params.M))
    states = set()
    for i in range(1, 6):
        rgb, depth = render_frame(rope, i / 15.0, SMALL, rope_pixel_radius=3)
        occ = None
        if i in (2, 3):
            occ = np.ones((SMALL.height, SMALL.width), np.uint8)
            occ[:, int(0.39 * SMALL.width):int(0.625 * SMALL.width)] = 0
        ts = state_from_numpy(np.asarray(js.y), np.asarray(js.sigma2), np.asarray(js.geodesic_coord),
                              device="cpu")
        js, jo = jt.step(js, rgb, depth, occ)
        ts, to = tt.step(ts, rgb, depth, occ)
        assert int(to.n_points) == int(jo.n_points)
        assert int(to.occlusion_state) == int(jo.occlusion_state)
        assert np.abs(ts.y.numpy() - np.asarray(js.y)).max() <= STEP_TOL_M
        states.add(int(to.occlusion_state))
    assert len(states) >= 2


def _batch_frames(n):
    rope = SyntheticRope()
    fr = [render_frame(rope, 1 / 15.0 + 0.01 * b, SMALL, rope_pixel_radius=3) for b in range(n)]
    occ = np.ones((n, SMALL.height, SMALL.width), bool)
    occ[1, :, 62:100] = False
    return np.stack([f[0] for f in fr]), np.stack([f[1] for f in fr]), occ


def test_batched_coarse_step_matches_jax_and_single_clouds():
    from trackdlo_tpu.models.trackdlo import init_state as jax_init
    from trackdlo_tpu.parallel import build_batched_step_fn as jax_batched
    from trackdlo_tpu.parallel import replicate_state as jax_replicate

    params = dataclasses.replace(SMALL_PARAMS, parity_split=False)
    rgb, depth, occ = _batch_frames(B)
    tracker = Tracker(params, SMALL, device="cpu")
    s0 = tracker.init_from_nodes(SyntheticRope().nodes(0.0, params.M))
    ts, to = build_batched_step_fn(params, SMALL, device="cpu")(replicate_state(s0, B), rgb, depth, occ)
    js = jax_replicate(jax_init(SyntheticRope().nodes(0.0, params.M), params), B)
    js, jo = jax_batched(params, SMALL)(js, jnp.asarray(rgb), jnp.asarray(depth), jnp.asarray(occ))
    np.testing.assert_array_equal(to.n_points.numpy(), np.asarray(jo.n_points))
    np.testing.assert_array_equal(to.occlusion_state.numpy(), np.asarray(jo.occlusion_state))
    assert np.abs(ts.y.numpy() - np.asarray(js.y)).max() <= STEP_TOL_M
    for b in range(B):
        _, out = tracker.step(s0, rgb[b], depth[b], occ[b])
        assert torch.equal(out.points, to.points[b]) and torch.equal(out.points_mask, to.points_mask[b])


@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_cohorts_and_multitracker_take_the_profile(profile):
    """Cohorts of one and of B, and MultiTracker, with each single-channel
    profile: a cohort of one is the single step, bit for bit."""
    params = dataclasses.replace(SMALL_PARAMS, **PROFILES[profile])
    rgb, depth, occ = _batch_frames(2)
    tracker = Tracker(params, SMALL, device="cpu")
    s0 = tracker.init_from_nodes(SyntheticRope().nodes(0.0, params.M))
    ones, _ = build_batched_step_fn(params, SMALL, cohort_size=1, device="cpu")(
        replicate_state(s0, 2), rgb, depth, occ)
    mt = MultiTracker(params, SMALL, device="cpu")
    for b in range(2):
        mt.add_stream(f"cam{b}", init_nodes=SyntheticRope().nodes(0.0, params.M))
    outs = mt.step_all({f"cam{b}": (rgb[b], depth[b]) for b in range(2)},
                       {f"cam{b}": occ[b] for b in range(2)})
    for b in range(2):
        single, out = tracker.step(s0, rgb[b], depth[b], occ[b])
        assert torch.equal(single.y, ones.y[b])
        np.testing.assert_array_equal(mt.nodes(f"cam{b}"), single.y.numpy())
        assert int(outs[f"cam{b}"].n_points) == int(out.n_points) > 0
