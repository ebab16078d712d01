"""Node visibility as dense masked tensor ops (the plain version of kernel V).

Counterpart of trackdlo_tpu/ops/visibility.py: per-node nearest-cloud
distance, painter's-algorithm self-occlusion in closed form (a node is
occluded iff an edge drawn before its first adjacent edge covers its pixel),
geodesic gap fill and prefix-packed index lists, plus the per-point minima
the EM prune consumes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from trackdlo_tpu_torch.ops.kernels import pairwise_sq_dists

_SENTINEL = 1e10


class VisibilityOut(NamedTuple):
    visible_mask: torch.Tensor  # (M,) proximity ∧ not self-occluded
    extended_mask: torch.Tensor  # (M,) after the geodesic gap fill
    not_self_occluded: torch.Tensor  # (M,)
    shortest_node_pt_dists: torch.Tensor  # (M,)
    vis_idx: torch.Tensor  # (M,) int64 prefix-packed visible indices
    vis_count: torch.Tensor
    vis_ext_idx: torch.Tensor  # (M,) int64 prefix-packed extended indices
    vis_ext_count: torch.Tensor
    point_min_sq_all: torch.Tensor  # (N,) min sq distance over all nodes
    point_min_sq_ext: torch.Tensor  # (N,) ... over the extended nodes


def pack_indices(mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Prefix-pack the indices where ``mask`` is True (ascending); empty
    slots hold m-1."""
    m = mask.shape[0]
    iota = torch.arange(m, device=mask.device)
    packed = torch.sort(torch.where(mask, iota, m)).values
    return packed.clamp(0, m - 1), mask.to(torch.int64).sum()


def project_pixels(y: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
    """Integer pixel coordinates of nodes: an IEEE divide then truncation
    toward zero, with pz == 0 guarded."""
    px = y[:, 0] * proj[0, 0] + y[:, 1] * proj[0, 1] + y[:, 2] * proj[0, 2] + proj[0, 3]
    py = y[:, 0] * proj[1, 0] + y[:, 1] * proj[1, 1] + y[:, 2] * proj[1, 2] + proj[1, 3]
    pz = y[:, 0] * proj[2, 0] + y[:, 1] * proj[2, 1] + y[:, 2] * proj[2, 2] + proj[2, 3]
    pz = torch.where(pz == 0, torch.ones_like(pz), pz)
    return torch.stack([(px / pz).to(torch.int32), (py / pz).to(torch.int32)], dim=1)


def compute_visibility(
    y: torch.Tensor,
    x: torch.Tensor,
    x_mask: torch.Tensor,
    proj: torch.Tensor,
    geodesic_coord: torch.Tensor,
    img_rows: int,
    img_cols: int,
    visibility_threshold: float,
    dlo_pixel_width: int,
    d_vis: float,
) -> VisibilityOut:
    """Visibility of the chain ``y`` (M, 3) against the cloud ``x`` (N, 3).
    With a leading stream axis on y, x, x_mask and geodesic_coord, every
    output gains it (one stream at a time; ``proj`` is shared)."""
    if y.ndim == 3:
        per = [compute_visibility(y[i], x[i], x_mask[i], proj, geodesic_coord[i], img_rows,
                                  img_cols, visibility_threshold, dlo_pixel_width, d_vis)
               for i in range(y.shape[0])]
        return VisibilityOut(*(torch.stack(f) for f in zip(*per)))
    m = y.shape[0]
    dev, dt = y.device, y.dtype
    iota = torch.arange(m, device=dev)

    sq = torch.where(x_mask[None, :], pairwise_sq_dists(y, x), _SENTINEL)
    shortest = torch.sqrt(sq.amin(dim=1))

    # Edge draw order: ascending midpoint camera distance (squared: same
    # order), ties by index.
    mid = (y[:-1] + y[1:]) / 2.0
    edge_d2 = mid[:, 0] * mid[:, 0] + mid[:, 1] * mid[:, 1] + mid[:, 2] * mid[:, 2]
    order = torch.sort(edge_d2, stable=True).indices
    rank = torch.empty_like(order)
    rank[order] = torch.arange(m - 1, device=dev)

    pix = project_pixels(y, proj).to(dt)
    pr_u = pix[:, 0].clamp(0, img_cols - 1)
    pr_v = pix[:, 1].clamp(0, img_rows - 1)
    ax, ay = pix[:-1, 0], pix[:-1, 1]
    abx, aby = pix[1:, 0] - ax, pix[1:, 1] - ay
    apx = pr_u[:, None] - ax[None, :]
    apy = pr_v[:, None] - ay[None, :]
    denom = torch.clamp_min(abx * abx + aby * aby, 1e-12)
    t = torch.clamp((apx * abx[None, :] + apy * aby[None, :]) / denom[None, :], 0.0, 1.0)
    dx = pr_u[:, None] - (ax[None, :] + t * abx[None, :])
    dy = pr_v[:, None] - (ay[None, :] + t * aby[None, :])
    covers = torch.sqrt(dx * dx + dy * dy) <= dlo_pixel_width / 2.0  # (M, M-1)

    big = torch.full((1,), 1 << 30, dtype=rank.dtype, device=dev)
    check_rank = torch.minimum(torch.cat([big, rank]), torch.cat([rank, big]))
    covered = (covers & (rank[None, :] < check_rank[:, None])).any(dim=1)
    not_self_occluded = ~covered
    visible = not_self_occluded & (shortest <= visibility_threshold)

    prev_vis = torch.cummax(torch.where(visible, iota, -1), dim=0).values
    next_vis = torch.flip(
        torch.cummin(torch.flip(torch.where(visible, iota, 2 * m), [0]), dim=0).values, [0]
    )
    has_both = (prev_vis >= 0) & (next_vis < m)
    gap = torch.abs(geodesic_coord[next_vis.clamp(0, m - 1)] - geodesic_coord[prev_vis.clamp(0, m - 1)])
    extended = visible | (has_both & (gap <= d_vis))

    vis_idx, vis_count = pack_indices(visible)
    ext_idx, ext_count = pack_indices(extended)
    return VisibilityOut(
        visible_mask=visible,
        extended_mask=extended,
        not_self_occluded=not_self_occluded,
        shortest_node_pt_dists=shortest,
        vis_idx=vis_idx,
        vis_count=vis_count,
        vis_ext_idx=ext_idx,
        vis_ext_count=ext_count,
        point_min_sq_all=sq.amin(dim=0),
        point_min_sq_ext=torch.where(extended[:, None], sq, _SENTINEL).amin(dim=0),
    )
