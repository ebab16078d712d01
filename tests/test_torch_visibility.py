"""The port's visibility pass (compute_visibility, kernel V's plain version)
against the JAX package's compute_visibility and its Pallas kernel
fused_visibility run in interpret mode, at the live camera and M=45.

Bounds: index lists, masks and counts equal; distances and per-point minima
within 1e-6 m (float32 square roots of the same squared distances)."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trackdlo_tpu.config import CameraIntrinsics, live_params
from trackdlo_tpu.io.sequence import SyntheticRope
from trackdlo_tpu_torch.ops.kernels import geodesic_coords
from trackdlo_tpu_torch.ops.visibility import compute_visibility, pack_indices
from trackdlo_tpu_torch.ops.visibility_kernel import fused_visibility, fused_visibility_plain

jv = importlib.import_module("trackdlo_tpu.ops.visibility")
jvk = importlib.import_module("trackdlo_tpu.ops.visibility_kernel")

M = 45
N_CAP = 256
PARAMS = live_params()
INTR = CameraIntrinsics()
TOL_M = 1e-6
MASKS = ("visible_mask", "extended_mask", "not_self_occluded")
INDICES = ("vis_idx", "vis_ext_idx", "vis_count", "vis_ext_count")


def _cloud_along(curve, rng, n_valid, keep=None):
    pick = rng.integers(0, len(curve), n_valid)
    pts = curve[pick] + rng.normal(0, 0.002, (n_valid, 3))
    if keep is not None:
        pts = pts[keep(pts)]
    x = np.zeros((N_CAP, 3), np.float32)
    x[: len(pts)] = pts
    return x, np.arange(N_CAP) < len(pts)


def _self_occluding_chain():
    """A chain that runs left to right at 0.75 m, then back over the same
    image row at 0.6 m: the near half covers the far half in the image."""
    n_far = 22
    xs_far = np.linspace(-0.2, 0.2, n_far)
    xs_near = np.linspace(0.2, -0.2, M - n_far) * 0.6 / 0.75
    far = np.stack([xs_far, np.zeros(n_far), np.full(n_far, 0.75)], 1)
    near = np.stack([xs_near, np.zeros(M - n_far), np.full(M - n_far, 0.6)], 1)
    return np.concatenate([far, near]).astype(np.float32), near


def _case(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    rope = SyntheticRope()
    y = rope.nodes(0.0, M).astype(np.float32)
    curve = rope.curve(1 / 15.0)
    if name == "rope":
        x, xm = _cloud_along(curve, rng, 220)
    elif name == "rope_occluded_middle":
        x, xm = _cloud_along(curve, rng, 220, keep=lambda p: np.abs(p[:, 0]) > 0.08)
    elif name == "self_occluding":
        y, near = _self_occluding_chain()
        fine = np.linspace(near[0], near[-1], 400)
        x, xm = _cloud_along(fine, rng, 200)
    elif name == "empty_cloud":
        x, xm = np.zeros((N_CAP, 3), np.float32), np.zeros(N_CAP, bool)
    elif name == "far_cloud":
        x, xm = np.full((N_CAP, 3), 5.0, np.float32), np.ones(N_CAP, bool)
    else:
        raise KeyError(name)
    coord = geodesic_coords(torch.from_numpy(y)).numpy()
    return y, x, xm, coord


CASES = ("rope", "rope_occluded_middle", "self_occluding", "empty_cloud", "far_cloud")
SCALARS = (INTR.height, INTR.width, PARAMS.visibility_threshold, PARAMS.dlo_pixel_width, PARAMS.d_vis)


def _proj():
    return np.array(INTR.proj_matrix(), np.float32)


def _assert_same(got, ref):
    """``got`` a VisibilityOut of tensors, ``ref`` of arrays or tensors."""
    arr = lambda v: v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    for f in MASKS + INDICES:
        np.testing.assert_array_equal(arr(getattr(got, f)), arr(getattr(ref, f)), err_msg=f)
    # With no point (or node) in range each implementation returns its own
    # sentinel (the JAX kernel's differs from its XLA twin's); clamped at 1
    # they compare as "far": every consumer thresholds far below that.
    for f in ("shortest_node_pt_dists", "point_min_sq_all", "point_min_sq_ext"):
        a = np.minimum(arr(getattr(got, f)), 1.0)
        b = np.minimum(arr(getattr(ref, f)), 1.0)
        assert np.abs(a - b).max() <= TOL_M, f


@pytest.mark.parametrize("name", CASES)
def test_matches_jax_visibility_and_interpreted_kernel(name):
    y, x, xm, coord = _case(name)
    t = torch.from_numpy
    got = compute_visibility(t(y), t(x), t(xm), t(_proj()), t(coord), *SCALARS)
    jargs = (jnp.asarray(y), jnp.asarray(x), jnp.asarray(xm), jnp.asarray(_proj()), jnp.asarray(coord))
    _assert_same(got, jv.compute_visibility(*jargs, *SCALARS))
    _assert_same(got, jvk.fused_visibility(*jargs, *SCALARS, interpret=True))
    if name == "self_occluding":
        assert not bool(got.not_self_occluded[:22].any())
        assert bool(got.not_self_occluded[22:].all())
    if name in ("empty_cloud", "far_cloud"):
        # Nothing visible: both packed lists are all the m-1 sentinel.
        assert int(got.vis_count) == int(got.vis_ext_count) == 0
        assert bool((got.vis_idx == M - 1).all()) and bool((got.vis_ext_idx == M - 1).all())


def test_pack_indices_prefix_and_sentinel():
    mask = torch.zeros(M, dtype=torch.bool)
    mask[[0, 3, 7, 44]] = True
    idx, count = pack_indices(mask)
    assert int(count) == 4
    assert idx.tolist() == [0, 3, 7, 44] + [M - 1] * (M - 4)


def test_wrapper_takes_plain_version_on_cpu():
    y, x, xm, coord = _case("rope")
    t = torch.from_numpy
    args = (t(y), t(x), t(xm), t(_proj()), t(coord), *SCALARS)
    _assert_same(fused_visibility(*args), fused_visibility_plain(*args))
