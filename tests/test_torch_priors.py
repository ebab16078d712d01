"""The port's correspondence priors (occlusion dispatch, and the four
pursuit walks through kernel W's plain version) against the JAX package's
correspondence_priors: its vmapped XLA walk and its Pallas walk kernel run
in interpret mode.

Bounds: occlusion codes and prior masks equal; prior positions within
5e-6 m (the walks chain up to 44 sphere-segment intersections, each a
float32 quadratic root)."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trackdlo_tpu.io.sequence import SyntheticRope
from trackdlo_tpu_torch.ops import priors as tp
from trackdlo_tpu_torch.ops.hopper_kernels import pursuit_walks, pursuit_walks_plain
from trackdlo_tpu_torch.ops.kernels import geodesic_coords

jp = importlib.import_module("trackdlo_tpu.ops.priors")

M = 45
TOL_M = 5e-6

# name: (extended-visible nodes, raw-visible nodes or None for the same,
#        expected occlusion state)
CASES = {
    "all_visible": (range(M), None, tp.ALL_VISIBLE),
    "mid_occluded": ([*range(0, 15), *range(30, M)], None, tp.MID_SECTION_OCCLUDED),
    "tail_occluded": (range(0, 35), None, tp.TAIL_OCCLUDED),
    "head_occluded": (range(10, M), None, tp.HEAD_OCCLUDED),
    "both_ends_occluded": (range(10, 35), None, tp.BOTH_ENDS_OCCLUDED),
    "both_ends_gap_filled": (range(8, 30), [*range(8, 14), *range(17, 30)], tp.BOTH_ENDS_OCCLUDED),
    "both_ends_two_runs": ([*range(5, 15), *range(20, 33)], None, tp.BOTH_ENDS_OCCLUDED),
    "single_node": ([20], None, tp.BOTH_ENDS_OCCLUDED),
    "no_visible_nodes": ([], None, tp.NO_VISIBLE_NODES),
}


def _packed(nodes):
    nodes = list(nodes)
    idx = np.full(M, M - 1, np.int32)
    idx[: len(nodes)] = nodes
    return idx, np.int32(len(nodes))


def _case(name):
    ext, raw, state = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    rope = SyntheticRope()
    y = rope.nodes(0.0, M).astype(np.float32)
    coord = geodesic_coords(torch.from_numpy(y)).numpy()
    ext_idx, ext_count = _packed(ext)
    vis_idx, vis_count = _packed(ext if raw is None else raw)
    moved = rope.nodes(1 / 15.0, M) + rng.normal(0, 0.001, (M, 3))
    guides = np.zeros((M, 3), np.float32)
    guides[:ext_count] = moved[ext_idx[:ext_count]]
    return (y, coord, guides, ext_idx, ext_count, vis_idx, vis_count), state


def _torch_args(args, device="cpu"):
    y, coord, guides, ext_idx, ext_count, vis_idx, vis_count = args
    d = lambda a: torch.as_tensor(a).to(device)
    return (d(y), d(coord), d(guides), d(ext_idx.astype(np.int64)), d(np.int64(ext_count)),
            d(vis_idx.astype(np.int64)), d(np.int64(vis_count)))


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_jax_priors(name):
    args, state = _case(name)
    got = tp.correspondence_priors(*_torch_args(args))
    assert int(got.state) == state
    jargs = [jnp.asarray(a) for a in args]
    for kw in ({}, {"use_pallas": True, "interpret": True}):
        ref = jp.correspondence_priors(*jargs, **kw)
        assert int(ref.state) == int(got.state)
        assert int(ref.alignment_idx) == int(got.alignment_idx)
        mask = got.prior_mask.numpy()
        np.testing.assert_array_equal(mask, np.asarray(ref.prior_mask))
        err = np.abs(got.prior_pos.numpy() - np.asarray(ref.prior_pos))[mask]
        assert err.size == 0 or err.max() <= TOL_M, err.max()
    if state == tp.NO_VISIBLE_NODES:
        assert not bool(got.prior_mask.any())
    else:
        assert bool(got.prior_mask.any())


def test_single_walk_matches_jax_pursuit_walk():
    args, _ = _case("head_occluded")
    y, coord, guides, ext_idx, ext_count = args[:5]
    seg = np.abs(np.diff(coord)).astype(np.float32)
    scal = (0, 30, 30, 0, int(ext_count))
    got = tp.pursuit_walk(torch.from_numpy(guides), torch.from_numpy(seg),
                          *(torch.tensor(v) for v in scal))
    ref = jp.pursuit_walk(jnp.asarray(guides), jnp.asarray(seg), *(jnp.int32(v) for v in scal))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    assert np.abs(got.pos.numpy() - np.asarray(ref.pos))[got.valid.numpy()].max() <= TOL_M


def test_wrapper_takes_plain_version_on_cpu():
    args, _ = _case("both_ends_occluded")
    wi = tp.walk_inputs(*_torch_args(args))
    a = pursuit_walks(wi.guides, wi.seglens, wi.ints)
    b = pursuit_walks_plain(wi.guides, wi.seglens, wi.ints)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
