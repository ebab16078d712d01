"""The frame → cell-sums kernel (kernel P, csrc/cell_sums.cu).

Counterpart of trackdlo_tpu/ops/preprocess_kernel.py, parity channel-grid
variant only. Its plain version is
:func:`trackdlo_tpu_torch.ops.preprocess.cell_sums_plain`, which the wrapper
takes for tensors on the CPU.
"""

from __future__ import annotations

import torch

from trackdlo_tpu_torch import _build
from trackdlo_tpu_torch.ops.preprocess import cell_sums_plain, floor_key_constants, hsv_bands

# The HSV bands per (bands, device): a fresh host-to-device copy from pageable
# memory each frame would block the host.
_bands_cache: dict = {}


def parity_grid_shape(h: int, w: int, cell_px: int) -> tuple[int, int]:
    """(n_rows, n_cols) of the cell grid that :func:`cell_sums` flattens in
    raster order into its (8, n_rows·n_cols) outputs (no padding)."""
    return -(-h // cell_px), -(-w // cell_px)


def _bands_tensor(hsv_lower, hsv_upper, multi_color_dlo, device) -> torch.Tensor:
    key = (tuple(hsv_lower), tuple(hsv_upper), bool(multi_color_dlo), str(device))
    if key not in _bands_cache:
        rows = [list(lo) + list(hi) for lo, hi in hsv_bands(hsv_lower, hsv_upper, multi_color_dlo)]
        _bands_cache[key] = torch.tensor(rows, dtype=torch.float32, device=device).reshape(-1)
    return _bands_cache[key]


def cell_sums(rgb, depth, occlusion_mask, fx, fy, cx, cy, hsv_lower, hsv_upper,
              multi_color_dlo, cell_px, voxel_leaf):
    """(Σx, Σy, Σz, count) per (parity channel, image cell), four
    (8, n_rows·n_cols) float32 tensors in raster order (channel bx·4+by·2+bz).

    ``rgb`` (H, W, 3) uint8, ``depth`` (H, W) u16 millimetres (uint16, or
    the same bits as int16), ``occlusion_mask`` (H, W) bool. With a leading
    stream axis ((B, H, W, 3), …) the B frames take one launch and each
    output is (B, 8, n_rows·n_cols)."""
    if depth.device.type == "cpu":
        return cell_sums_plain(
            rgb, depth, occlusion_mask, fx, fy, cx, cy, hsv_lower, hsv_upper,
            multi_color_dlo, cell_px, voxel_leaf,
        )
    dev = _build.require_cuda(
        "cell_sums", dict(rgb=rgb, depth=depth, occlusion_mask=occlusion_mask),
        dict(rgb=torch.uint8, depth=depth.dtype, occlusion_mask=torch.bool),
    )
    if depth.dtype not in (torch.int16, torch.uint16):
        raise ValueError(f"cell_sums: depth must be u16 bits, got {depth.dtype}")
    lead = depth.shape[:-2]
    if len(lead) > 1:
        raise ValueError(f"cell_sums: depth must be (H, W) or (B, H, W), got {tuple(depth.shape)}")
    n_streams = lead[0] if lead else 1
    h, w = depth.shape[-2:]
    if tuple(rgb.shape) != (*lead, h, w, 3) or tuple(occlusion_mask.shape) != (*lead, h, w):
        raise ValueError("cell_sums: rgb/occlusion_mask shapes do not match depth")
    n_rows, n_cols = parity_grid_shape(h, w, cell_px)
    bands = _bands_tensor(hsv_lower, hsv_upper, multi_color_dlo, dev)
    k = floor_key_constants(fx, fy, voxel_leaf)
    out = torch.empty((4, *lead, 8, n_rows * n_cols), dtype=torch.float32, device=dev)
    code = _build.lib().trackdlo_cell_sums(
        rgb.data_ptr(), depth.data_ptr(), occlusion_mask.data_ptr(), n_streams, h, w, int(cell_px),
        bands.data_ptr(), bands.numel() // 6, float(fx), float(fy), float(cx), float(cy),
        k["kx"], k["ky"], k["k_zq"], k["kz"], int(k["z_from_mm"]),
        out.data_ptr(), _build.stream_ptr(dev),
    )
    _build.check(code, "trackdlo_cell_sums")
    _build.count_launch("cell_sums")
    return out[0], out[1], out[2], out[3]
