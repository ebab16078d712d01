"""The visibility kernel (kernel V, csrc/visibility.cu).

Counterpart of trackdlo_tpu/ops/visibility_kernel.py. Same outputs as
:func:`trackdlo_tpu_torch.ops.visibility.compute_visibility`, its plain
version, which the wrapper takes for tensors on the CPU.
"""

from __future__ import annotations

import math

import torch

from trackdlo_tpu_torch import _build
from trackdlo_tpu_torch.ops.hopper_kernels import check_nodes
from trackdlo_tpu_torch.ops.visibility import VisibilityOut, compute_visibility

fused_visibility_plain = compute_visibility

# The outputs in the one buffer the kernel writes, widest first so every
# field is aligned: (name, dtype, trailing shape as a function of m and n).
_LAYOUT = (
    ("vis_idx", torch.int64, lambda m, n: (m,)),
    ("vis_ext_idx", torch.int64, lambda m, n: (m,)),
    ("counts", torch.int64, lambda m, n: (2,)),
    ("shortest_node_pt_dists", torch.float32, lambda m, n: (m,)),
    ("point_min_sq_all", torch.float32, lambda m, n: (n,)),
    ("point_min_sq_ext", torch.float32, lambda m, n: (n,)),
    ("visible_mask", torch.bool, lambda m, n: (m,)),
    ("extended_mask", torch.bool, lambda m, n: (m,)),
    ("not_self_occluded", torch.bool, lambda m, n: (m,)),
)


def alloc_visibility_out(lead: tuple, m: int, n: int, device) -> tuple[VisibilityOut, dict]:
    """One allocation for every output of kernel V, viewed as the
    :class:`VisibilityOut` fields (each with the leading stream axes
    ``lead``; the counts are the two columns of one int64 (..., 2) field).
    Returns the outputs and each field's view, the pointers the kernel
    writes through."""
    sizes = [math.prod(lead) * math.prod(shape(m, n)) * dt.itemsize for _, dt, shape in _LAYOUT]
    buf = torch.empty(sum(sizes), dtype=torch.uint8, device=device)
    views = {name: part.view(dt).view(*lead, *shape(m, n))
             for (name, dt, shape), part in zip(_LAYOUT, buf.split(sizes))}
    counts = views.pop("counts")
    out = VisibilityOut(vis_count=counts[..., 0], vis_ext_count=counts[..., 1], **views)
    return out, dict(views, counts=counts)


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
    that launch; every output then gains it. The kernel writes every output
    in its final dtype into one allocation (:func:`alloc_visibility_out`):
    no cast follows the launch."""
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
    check_nodes("fused_visibility", "visibility", m, lo=2)
    if (len(lead) > 1 or tuple(x.shape) != (*lead, n, 3) or tuple(x_mask.shape) != (*lead, n)
            or tuple(geodesic_coord.shape) != (*lead, m)):
        raise ValueError("fused_visibility: y/x/x_mask/geodesic_coord shapes do not match")
    out, v = alloc_visibility_out(lead, m, n, dev)
    code = _build.lib().trackdlo_visibility(
        y.data_ptr(), x.data_ptr(), x_mask.data_ptr(), proj.data_ptr(),
        geodesic_coord.data_ptr(), lead[0] if lead else 1, m, n, int(img_rows), int(img_cols),
        float(visibility_threshold), float(dlo_pixel_width) / 2.0, float(d_vis),
        v["visible_mask"].data_ptr(), v["extended_mask"].data_ptr(),
        v["not_self_occluded"].data_ptr(), v["shortest_node_pt_dists"].data_ptr(),
        v["vis_idx"].data_ptr(), v["vis_ext_idx"].data_ptr(), v["counts"].data_ptr(),
        v["point_min_sq_all"].data_ptr(), v["point_min_sq_ext"].data_ptr(),
        _build.stream_ptr(dev),
    )
    _build.check(code, "trackdlo_visibility")
    _build.count_launch("visibility")
    return out
