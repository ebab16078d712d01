"""The TrackDLO tracker on PyTorch: RGB-D frame → tracked node chain.

Counterpart of trackdlo_tpu/models/trackdlo.py. Per frame, ``Tracker.step``
runs: preprocessing (kernel P, compaction with kernel C, voxel snap) → visibility
(kernel V) → pre-registration EM over the extended-visible guide nodes
(kernel E) → occlusion dispatch and prior walks (kernel W) → main EM
(kernel E). Every stage stays on the tracker's device; nothing is read back
to the host inside a step. The same stages run over a leading stream axis in
the batched step (:mod:`trackdlo_tpu_torch.parallel`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from trackdlo_tpu_torch.config import CameraIntrinsics, TrackerParams
from trackdlo_tpu_torch.device import resolve_device, set_full_fp32
from trackdlo_tpu_torch.ops.cpd_lle import CpdParams, cpd_lle, cpd_lle_batched
from trackdlo_tpu_torch.ops.kernels import geodesic_coords
from trackdlo_tpu_torch.ops.preprocess import PointCloud, compact_sums, default_cell_px
from trackdlo_tpu_torch.ops.preprocess_kernel import cell_sums
from trackdlo_tpu_torch.ops.priors import correspondence_priors
from trackdlo_tpu_torch.ops.visibility_kernel import fused_visibility


class TrackerState(NamedTuple):
    y: torch.Tensor  # (M, 3) node positions
    sigma2: torch.Tensor  # () GMM variance
    geodesic_coord: torch.Tensor  # (M,) rest arc-length coordinates


class StepOutputs(NamedTuple):
    y: torch.Tensor
    sigma2: torch.Tensor
    guide_nodes: torch.Tensor  # (M, 3) prefix-packed pre-registered guides
    guide_count: torch.Tensor
    prior_pos: torch.Tensor  # (M, 3)
    prior_mask: torch.Tensor  # (M,)
    occlusion_state: torch.Tensor  # code, see ops.priors
    visible_mask: torch.Tensor  # (M,)
    extended_mask: torch.Tensor  # (M,)
    not_self_occluded: torch.Tensor  # (M,)
    points: torch.Tensor  # (N_cap, 3) downsampled cloud
    points_mask: torch.Tensor
    n_points: torch.Tensor
    converged: torch.Tensor
    iterations: torch.Tensor
    guide_iterations: torch.Tensor  # the pre-registration pass's EM iterations


def init_state(init_nodes, params: TrackerParams, device=None) -> TrackerState:
    """State from initial nodes: rest arc lengths and the initial σ², on
    ``device`` (the CUDA card unless the caller names the CPU)."""
    y = torch.tensor(np.asarray(init_nodes, np.float32), device=resolve_device(device))
    return TrackerState(
        y=y,
        sigma2=torch.tensor(params.sigma2_init, dtype=torch.float32, device=y.device),
        geodesic_coord=geodesic_coords(y),
    )


def host_to_device(a, device: torch.device) -> torch.Tensor:
    """A frame (numpy or tensor) on ``device``; u16 depth travels as its
    bits in int16 (the kernels read them as u16), through pinned memory to
    a CUDA device."""
    if isinstance(a, torch.Tensor):
        return a.to(device, non_blocking=True)
    arr = np.ascontiguousarray(a)
    if arr.dtype == np.uint16:
        arr = arr.view(np.int16)
    t = torch.from_numpy(arr)
    if device.type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    return t


def preprocess_for_step(rgb, depth, occlusion_mask, *, params: TrackerParams,
                        intr: CameraIntrinsics, cell_px: int) -> PointCloud:
    """Kernel P's raw cell sums, then the compaction, in the JAX package's
    three branches:

    - parity split (the default profile): kernel C's channel compaction,
      divide-after-pack and the channel-batched voxel snap;
    - coarse two-stage (``parity_split=False``): one channel with the floor
      votes, the sort compaction and the vote-keyed snap;
    - cells only (``exact_voxels=False``): one channel, the sort compaction
      with even-stride thinning, no snap.

    Frames with a leading stream axis give a batched cloud: kernel P runs
    once for the B frames, and every later step is row-local."""
    voxel_leaf = params.downsample_leaf_size if params.exact_voxels else None
    parity = params.parity_split and voxel_leaf is not None
    sums = cell_sums(
        rgb, depth, occlusion_mask, intr.fx, intr.fy, intr.cx, intr.cy,
        params.hsv_lower, params.hsv_upper, params.multi_color_dlo, cell_px, voxel_leaf,
        parity_split=parity, with_votes=not parity and voxel_leaf is not None,
    )
    return compact_sums(sums, params.max_points, voxel_leaf, params.candidate_cap(), parity)


def _track_from_points(state: TrackerState, pc: PointCloud, proj: torch.Tensor, *,
                       params: TrackerParams, intr: CameraIntrinsics):
    """Visibility → pre-registration → priors → main EM on a prepared cloud;
    a state and cloud with a leading stream axis run every stage batched
    (the EM passes through :func:`cpd_lle_batched`)."""
    m = params.num_of_nodes
    dev = state.y.device
    lead = state.y.shape[:-2]
    em = cpd_lle_batched if lead else cpd_lle
    vis = fused_visibility(
        state.y, pc.points, pc.mask, proj, state.geodesic_coord,
        intr.height, intr.width, params.visibility_threshold,
        params.dlo_pixel_width, params.d_vis,
    )
    iota = torch.arange(m, device=dev)
    guide_node_mask = iota < vis.vis_ext_count[..., None]
    picked = state.y.gather(-2, vis.vis_ext_idx[..., None].expand(*lead, m, 3))
    guide0 = torch.where(guide_node_mask[..., None], picked, 0.0)
    pre = em(
        pc.points, pc.mask, guide0, guide_node_mask, state.sigma2,
        CpdParams(
            beta=params.beta_pre_proc, lam=params.lambda_pre_proc,
            lle_weight=params.lle_weight, mu=params.mu, max_iter=params.max_iter,
            tol=params.tol, include_lle=True, prune_radius=params.prune_radius,
            visibility_threshold=params.visibility_threshold, solver=params.solver,
        ),
        point_min_sq=vis.point_min_sq_ext,
    )
    guide_nodes = pre.y
    priors = correspondence_priors(
        state.y, state.geodesic_coord, guide_nodes, vis.vis_ext_idx,
        vis.vis_ext_count, vis.vis_idx, vis.vis_count,
    )
    main = em(
        pc.points, pc.mask, state.y, torch.ones((*lead, m), dtype=torch.bool, device=dev),
        state.sigma2,
        CpdParams(
            beta=params.beta, lam=params.lam, lle_weight=params.lle_weight,
            mu=params.mu, max_iter=params.max_iter, tol=params.tol,
            include_lle=False, alpha=params.alpha, k_vis=params.k_vis,
            visibility_threshold=params.visibility_threshold,
            prune_radius=params.prune_radius, use_priors=True,
            use_visibility=True, solver=params.solver,
        ),
        prior_pos=priors.prior_pos,
        prior_mask=priors.prior_mask,
        visible_count=vis.vis_ext_count,
        point_min_sq=vis.point_min_sq_all,
    )
    new_state = TrackerState(y=main.y, sigma2=main.sigma2, geodesic_coord=state.geodesic_coord)
    outputs = StepOutputs(
        y=main.y,
        sigma2=main.sigma2,
        guide_nodes=guide_nodes,
        guide_count=vis.vis_ext_count,
        prior_pos=priors.prior_pos,
        prior_mask=priors.prior_mask,
        occlusion_state=priors.state,
        visible_mask=vis.visible_mask,
        extended_mask=vis.extended_mask,
        not_self_occluded=vis.not_self_occluded,
        points=pc.points,
        points_mask=pc.mask,
        n_points=pc.count,
        converged=main.converged,
        iterations=main.iterations,
        guide_iterations=pre.iterations,
    )
    return new_state, outputs


class Tracker:
    """Tracking API on one device.

    Usage::

        tracker = Tracker(live_params(), CameraIntrinsics(), device="cuda")
        state = tracker.init_from_frame(rgb, depth)     # or init_from_nodes
        for rgb, depth in frames:
            state, out = tracker.step(state, rgb, depth)

    ``device="cuda"`` without a GPU raises; it never falls back to the CPU.
    On a CUDA device every former TPU kernel of the step runs as a
    hand-written CUDA kernel; on the CPU the plain versions run."""

    def __init__(self, params: TrackerParams, intrinsics: CameraIntrinsics, device=None):
        self.params = params
        self.intrinsics = intrinsics
        self.device = resolve_device(device)
        set_full_fp32()
        self.cell_px = params.downsample_cell_px or default_cell_px(
            params.downsample_leaf_size, intrinsics.fx
        )
        self._proj = torch.as_tensor(
            np.array(intrinsics.proj_matrix(), np.float32), device=self.device
        )
        self._full_occ = None

    def init_from_nodes(self, nodes) -> TrackerState:
        nodes = np.asarray(nodes, np.float32)
        if nodes.shape != (self.params.num_of_nodes, 3):
            raise ValueError(f"expected ({self.params.num_of_nodes}, 3) nodes, got {nodes.shape}")
        return init_state(nodes, self.params, self.device)

    def init_from_frame(self, rgb, depth) -> TrackerState:
        """First-frame initialisation through the skeleton + spline fit
        (falling back to cold-start registration)."""
        from trackdlo_tpu_torch.dlo_init import initialize_nodes

        nodes = initialize_nodes(np.asarray(rgb), np.asarray(depth), self.params, self.intrinsics)
        return self.init_from_nodes(nodes)

    def step(self, state: TrackerState, rgb, depth, occlusion_mask=None):
        """One tracking update: rgb (H, W, 3) u8, depth (H, W) u16 mm, an
        optional occlusion mask (nonzero = keep)."""
        h, w = self.intrinsics.height, self.intrinsics.width
        rgb_shape, depth_shape = tuple(np.shape(rgb)), tuple(np.shape(depth))
        if rgb_shape != (h, w, 3):
            raise ValueError(f"rgb must be ({h}, {w}, 3) u8 for these intrinsics, got {rgb_shape}")
        if depth_shape != (h, w):
            raise ValueError(f"depth must be ({h}, {w}) u16 millimetres, got {depth_shape}")
        y_shape = tuple(np.shape(state.y))
        if y_shape != (self.params.num_of_nodes, 3):
            raise ValueError(f"state.y must be ({self.params.num_of_nodes}, 3), got {y_shape}")
        if occlusion_mask is None:
            if self._full_occ is None:
                self._full_occ = torch.ones((h, w), dtype=torch.bool, device=self.device)
            occ = self._full_occ
        else:
            occ = host_to_device(occlusion_mask, self.device) != 0
            if occ.ndim == 3:
                occ = occ.any(dim=-1)
        pc = preprocess_for_step(
            host_to_device(rgb, self.device), host_to_device(depth, self.device), occ.contiguous(),
            params=self.params, intr=self.intrinsics, cell_px=self.cell_px,
        )
        return _track_from_points(state, pc, self._proj, params=self.params, intr=self.intrinsics)

    def step_from_points(self, state: TrackerState, points):
        """One update from a caller-supplied (N, 3) cloud, skipping the RGB-D
        preprocessing; points beyond ``params.max_points`` are dropped."""
        cap = self.params.max_points
        pts = np.zeros((cap, 3), np.float32)
        msk = np.zeros((cap,), bool)
        arr = np.asarray(points, np.float32)[:cap]
        pts[: len(arr)] = arr
        msk[: len(arr)] = True
        pts_t = torch.from_numpy(pts).to(self.device)
        msk_t = torch.from_numpy(msk).to(self.device)
        pc = PointCloud(points=pts_t, mask=msk_t, count=msk_t.to(torch.int64).sum())
        return _track_from_points(state, pc, self._proj, params=self.params, intr=self.intrinsics)
