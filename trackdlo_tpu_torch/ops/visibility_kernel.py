"""The visibility kernel (kernel V, csrc/visibility.cu).

Counterpart of trackdlo_tpu/ops/visibility_kernel.py. Same outputs as
:func:`trackdlo_tpu_torch.ops.visibility.compute_visibility`, its plain
version, which the wrapper takes for tensors on the CPU.
"""

from __future__ import annotations

import torch

from trackdlo_tpu_torch import _build
from trackdlo_tpu_torch.ops.visibility import VisibilityOut, compute_visibility

fused_visibility_plain = compute_visibility


def fused_visibility(
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
    """The whole visibility pass in one launch (one CTA per stream). A
    leading stream axis on y, x, x_mask and geodesic_coord puts B streams in
    that launch; every output then gains it."""
    if y.device.type == "cpu":
        return compute_visibility(
            y, x, x_mask, proj, geodesic_coord, img_rows, img_cols,
            visibility_threshold, dlo_pixel_width, d_vis,
        )
    dev = _build.require_cuda(
        "fused_visibility",
        dict(y=y, x=x, x_mask=x_mask, proj=proj, geodesic_coord=geodesic_coord),
        dict(x_mask=torch.bool),
    )
    lead = y.shape[:-2]
    m, n = y.shape[-2], x.shape[-2]
    if not 2 <= m <= 64:
        raise ValueError(f"fused_visibility: m={m} outside [2, 64]")
    if (len(lead) > 1 or tuple(x.shape) != (*lead, n, 3) or tuple(x_mask.shape) != (*lead, n)
            or tuple(geodesic_coord.shape) != (*lead, m)):
        raise ValueError("fused_visibility: y/x/x_mask/geodesic_coord shapes do not match")
    u8 = dict(dtype=torch.uint8, device=dev)
    visible = torch.empty((*lead, m), **u8)
    extended = torch.empty((*lead, m), **u8)
    not_occ = torch.empty((*lead, m), **u8)
    shortest = torch.empty((*lead, m), dtype=torch.float32, device=dev)
    vis_idx = torch.empty((*lead, m), dtype=torch.int32, device=dev)
    ext_idx = torch.empty((*lead, m), dtype=torch.int32, device=dev)
    counts = torch.empty((*lead, 2), dtype=torch.int32, device=dev)
    pmin_all = torch.empty((*lead, n), dtype=torch.float32, device=dev)
    pmin_ext = torch.empty((*lead, n), dtype=torch.float32, device=dev)
    code = _build.lib().trackdlo_visibility(
        y.data_ptr(), x.data_ptr(), x_mask.data_ptr(), proj.data_ptr(),
        geodesic_coord.data_ptr(), lead[0] if lead else 1, m, n, int(img_rows), int(img_cols),
        float(visibility_threshold), float(dlo_pixel_width) / 2.0, float(d_vis),
        visible.data_ptr(), extended.data_ptr(), not_occ.data_ptr(),
        shortest.data_ptr(), vis_idx.data_ptr(), ext_idx.data_ptr(),
        counts.data_ptr(), pmin_all.data_ptr(), pmin_ext.data_ptr(),
        _build.stream_ptr(dev),
    )
    _build.check(code, "trackdlo_visibility")
    _build.count_launch("visibility")
    counts = counts.to(torch.int64)
    return VisibilityOut(
        visible_mask=visible.bool(),
        extended_mask=extended.bool(),
        not_self_occluded=not_occ.bool(),
        shortest_node_pt_dists=shortest,
        vis_idx=vis_idx.to(torch.int64),
        vis_count=counts[..., 0],
        vis_ext_idx=ext_idx.to(torch.int64),
        vis_ext_count=counts[..., 1],
        point_min_sq_all=pmin_all,
        point_min_sq_ext=pmin_ext,
    )
