"""The frame → cell-sums kernel (kernel P, csrc/cell_sums.cu).

Counterpart of trackdlo_tpu/ops/preprocess_kernel.py in its three modes: the
parity channel grids, one channel with the voxel floor votes (``with_votes``)
and one channel with no leaf. Its plain version is
:func:`trackdlo_tpu_torch.ops.preprocess.cell_sums_plain`, which the wrapper
takes for tensors on the CPU.
"""

from __future__ import annotations

import torch

from trackdlo_tpu_torch import _build
from trackdlo_tpu_torch.ops.preprocess import (
    cell_sums_mode,
    cell_sums_plain,
    floor_key_constants,
    hsv_bands,
)

# The HSV bands per (bands, device): a fresh host-to-device copy from pageable
# memory each frame would block the host.
_bands_cache: dict = {}
# The floor chain's float32 constants per (fx, fy, leaf).
_floor_cache: dict = {}
# Per mode: the kernel's mode number, its outputs per stream and cell
# channel, and the launch counter it adds to.
_MODES = {"parity": (0, 4, "cell_sums"), "cells": (1, 4, "cell_sums_cells"),
          "votes": (2, 7, "cell_sums_votes")}


def parity_grid_shape(h: int, w: int, cell_px: int) -> tuple[int, int]:
    """(n_rows, n_cols) of the cell grid that :func:`cell_sums` flattens in
    raster order into its (…, n_rows·n_cols) outputs (no padding)."""
    return -(-h // cell_px), -(-w // cell_px)


def _bands_tensor(hsv_lower, hsv_upper, multi_color_dlo, device) -> torch.Tensor:
    key = (tuple(hsv_lower), tuple(hsv_upper), bool(multi_color_dlo), str(device))
    if key not in _bands_cache:
        rows = [list(lo) + list(hi) for lo, hi in hsv_bands(hsv_lower, hsv_upper, multi_color_dlo)]
        _bands_cache[key] = torch.tensor(rows, dtype=torch.float32, device=device).reshape(-1)
    return _bands_cache[key]


def cell_sums(rgb, depth, occlusion_mask, fx, fy, cx, cy, hsv_lower, hsv_upper,
              multi_color_dlo, cell_px, voxel_leaf, parity_split: bool = True,
              with_votes: bool = False):
    """Raw per-cell sums of one frame (kernel P).

    Parity mode (default): (Σx, Σy, Σz, count) per (parity channel, image
    cell), four (8, n_rows·n_cols) float32 tensors in raster order (channel
    bx·4+by·2+bz). ``parity_split=False``: four (n_rows·n_cols,) tensors of
    one channel, and with ``with_votes`` three more, the sums of the
    per-pixel voxel floors over ``voxel_leaf`` (``voxel_leaf=None`` computes
    no floors).

    ``rgb`` (H, W, 3) uint8, ``depth`` (H, W) u16 millimetres (uint16, or
    the same bits as int16), ``occlusion_mask`` (H, W) bool. With a leading
    stream axis ((B, H, W, 3), …) the B frames take one launch and each
    output gains a leading B."""
    mode = cell_sums_mode(parity_split, voxel_leaf, with_votes)
    if depth.device.type == "cpu":
        return cell_sums_plain(
            rgb, depth, occlusion_mask, fx, fy, cx, cy, hsv_lower, hsv_upper,
            multi_color_dlo, cell_px, voxel_leaf, parity_split, with_votes,
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
    key = (float(fx), float(fy), voxel_leaf)
    if key not in _floor_cache:
        _floor_cache[key] = (floor_key_constants(fx, fy, voxel_leaf) if voxel_leaf is not None
                             else dict(kx=0.0, ky=0.0, k_zq=0.0, kz=0.0, z_from_mm=False))
    k = _floor_cache[key]
    code_mode, n_out, counter = _MODES[mode]
    channels = (8,) if mode == "parity" else ()
    out = torch.empty((n_out, *lead, *channels, n_rows * n_cols), dtype=torch.float32, device=dev)
    code = _build.lib().trackdlo_cell_sums(
        rgb.data_ptr(), depth.data_ptr(), occlusion_mask.data_ptr(), n_streams, h, w, int(cell_px),
        bands.data_ptr(), bands.numel() // 6, float(fx), float(fy), float(cx), float(cy),
        k["kx"], k["ky"], k["k_zq"], k["kz"], int(k["z_from_mm"]), code_mode,
        out.data_ptr(), _build.stream_ptr(dev),
    )
    _build.check(code, "trackdlo_cell_sums")
    _build.count_launch(counter)
    return tuple(out.unbind(0))
