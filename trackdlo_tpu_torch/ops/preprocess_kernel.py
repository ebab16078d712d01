"""The frame → cell-sums kernel (kernel P, csrc/cell_sums.cu), and kernel X
(csrc/split_cells.cu), which reads the frame again on the exact route.

Counterpart of trackdlo_tpu/ops/preprocess_kernel.py in its three modes: the
parity channel grids, one channel with the voxel floor votes (``with_votes``)
and one channel with no leaf. Its plain version is
:func:`trackdlo_tpu_torch.ops.preprocess.cell_sums_plain`, which the wrapper
takes for tensors on the CPU. Kernel X (no TPU counterpart) is
:func:`split_cells`; its plain version
:func:`~trackdlo_tpu_torch.ops.preprocess.split_groups_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from trackdlo_tpu_torch import _build
from trackdlo_tpu_torch.ops.preprocess import (
    ExactFrame,
    SplitCells,
    cell_sums_mode,
    cell_sums_plain,
    exact_leaf_mm,
    floor_key_constants,
    hsv_bands,
)
from trackdlo_tpu_torch.utils import profiling

# The HSV bands per (bands, device): a fresh host-to-device copy from pageable
# memory each frame would block the host.
_bands_cache: dict = {}
# The floor chain's float32 constants per (fx, fy, leaf).
_floor_cache: dict = {}
# Per mode: the kernel's mode number, its outputs per stream and cell
# channel, and the launch counter it adds to.
_MODES = {"parity": (0, 4, "cell_sums"), "cells": (1, 4, "cell_sums_cells"),
          "votes": (2, 7, "cell_sums_votes")}
# Kernel P's (cells a strip, blocks a stream) per (h, w, cell_px, mode).
_grid_cache: dict = {}
# Kernel X's work tally on each card, settled into _build's counters.
_split_work: dict = {}


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


def strip_grid(h: int, w: int, cell_px: int, mode: str) -> tuple[int, int]:
    """Kernel P's strip: (cells a block takes along a cell row, blocks a
    stream), the layout of :class:`SplitCells`' ``counts``."""
    key = (h, w, int(cell_px), mode)
    if key not in _grid_cache:
        out = (ctypes.c_int * 2)()
        _build.check(_build.lib().trackdlo_cell_sums_grid(h, w, int(cell_px), _MODES[mode][0],
                                                          ctypes.addressof(out)),
                     "trackdlo_cell_sums_grid")
        if out[0] <= 0:
            raise ValueError(f"cell_sums: a cell of {cell_px} px does not fit a block")
        _grid_cache[key] = (out[0], out[1])
    return _grid_cache[key]


def _floor_constants(fx, fy, voxel_leaf) -> dict:
    key = (float(fx), float(fy), voxel_leaf)
    if key not in _floor_cache:
        _floor_cache[key] = (floor_key_constants(fx, fy, voxel_leaf) if voxel_leaf is not None
                             else dict(kx=0.0, ky=0.0, k_zq=0.0, kz=0.0, z_from_mm=False))
    return _floor_cache[key]


def cell_sums(rgb, depth, occlusion_mask, fx, fy, cx, cy, hsv_lower, hsv_upper,
              multi_color_dlo, cell_px, voxel_leaf, parity_split: bool = True,
              with_votes: bool = False, exact: bool = False):
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
    output gains a leading B.

    ``exact`` (parity mode): the exact route of :func:`cell_sums_plain`, a
    fifth output :class:`SplitCells` (``mask`` holds the bytes of the
    blocks that found a split channel-cell; kernel X reads no other). With
    the span recorder on, a graph's launch adds the masked pixels without
    depth and the cells with a split channel to its device counters."""
    mode = cell_sums_mode(parity_split, voxel_leaf, with_votes)
    exact = exact and mode == "parity"
    if depth.device.type == "cpu":
        return cell_sums_plain(
            rgb, depth, occlusion_mask, fx, fy, cx, cy, hsv_lower, hsv_upper,
            multi_color_dlo, cell_px, voxel_leaf, parity_split, with_votes, exact,
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
    k = _floor_constants(fx, fy, voxel_leaf)
    code_mode, n_out, counter = _MODES[mode]
    channels = (8,) if mode == "parity" else ()
    out = torch.empty((n_out, *lead, *channels, n_rows * n_cols), dtype=torch.float32, device=dev)
    split, tally = None, None
    if exact:
        split = SplitCells(
            torch.empty((*lead, n_rows * n_cols), dtype=torch.uint8, device=dev),
            torch.empty((*lead, strip_grid(h, w, cell_px, mode)[1], 2), dtype=torch.int32,
                        device=dev))
        tally = profiling.device_counters(dev)
    code = _build.lib().trackdlo_cell_sums(
        rgb.data_ptr(), depth.data_ptr(), occlusion_mask.data_ptr(), n_streams, h, w, int(cell_px),
        bands.data_ptr(), bands.numel() // 6, float(fx), float(fy), float(cx), float(cy),
        k["kx"], k["ky"], k["k_zq"], k["kz"], int(k["z_from_mm"]), code_mode,
        out.data_ptr(), int(exact), None if split is None else split.mask.data_ptr(),
        None if split is None else split.counts.data_ptr(),
        None if tally is None else tally.data_ptr(), _build.stream_ptr(dev),
    )
    _build.check(code, "trackdlo_cell_sums")
    _build.count_launch(counter)
    return tuple(out.unbind(0)) + ((split,) if exact else ())


class _SplitWork:
    """Kernel X's device tally on one card, settled into _build's counters."""

    def __init__(self, device: torch.device):
        self.device = device

    def settle(self) -> dict:
        out = torch.empty(len(_build.SPLIT_WORK), dtype=torch.int64, device=self.device)
        _build.check(_build.lib().trackdlo_split_cells_work(out.data_ptr(), 1,
                                                            _build.stream_ptr(self.device)),
                     "trackdlo_split_cells_work")
        return dict(zip(_build.SPLIT_WORK, out.tolist()))


def check_key_range(frame: ExactFrame, w: int) -> None:
    """Kernel X packs a pixel's three voxel floors in 21 bits each: raise
    where a u16 depth could reach past that at this camera and leaf."""
    leaf = frame.voxel_leaf
    reach_x = max(frame.cx, w - 1 - frame.cx) / frame.fx * 65.535 / leaf
    reach_y = max(frame.cy, frame.depth.shape[-2] - 1 - frame.cy) / frame.fy * 65.535 / leaf
    leaf_mm = exact_leaf_mm(leaf)
    reach_z = 65535 / leaf_mm if leaf_mm is not None else 65.535 / leaf
    if max(reach_x, reach_y, reach_z) >= (1 << 20) - 2:
        raise ValueError(f"split_cells: a {leaf} m leaf takes voxel floors past 2^20")


def split_cells(frame: ExactFrame, pts, cnt, valid):
    """Kernel X in place on kernel C's rows ``pts`` (B·8, cap_per, 3),
    ``cnt`` and ``valid`` (B·8, cap_per): what
    :func:`~trackdlo_tpu_torch.ops.preprocess.split_groups_plain` returns,
    bit for bit in every slot but the groups' sums, which it adds in another
    order (a lane's pixels, then a warp tree). Exits at once where kernel P
    found no split channel-cell and no masked pixel without depth."""
    rgb, depth, occ = frame.rgb, frame.depth, frame.occlusion_mask
    dev = _build.require_cuda(
        "split_cells", dict(rgb=rgb, depth=depth, occlusion_mask=occ, pts=pts, cnt=cnt,
                            valid=valid, mask=frame.split.mask, counts=frame.split.counts),
        dict(rgb=torch.uint8, depth=depth.dtype, occlusion_mask=torch.bool, pts=torch.float32,
             cnt=torch.float32, valid=torch.bool, mask=torch.uint8, counts=torch.int32))
    h, w = depth.shape[-2:]
    n_streams = depth.shape[0] if depth.ndim == 3 else 1
    cap_per = pts.shape[-2]
    if tuple(pts.shape) != (n_streams * 8, cap_per, 3) or tuple(cnt.shape) != pts.shape[:2] \
            or tuple(valid.shape) != pts.shape[:2]:
        raise ValueError("split_cells: pts/cnt/valid must be (B·8, cap_per[, 3])")
    check_key_range(frame, w)
    tile, n_blocks = strip_grid(h, w, frame.cell_px, "parity")
    bands = _bands_tensor(frame.hsv_lower, frame.hsv_upper, frame.multi_color_dlo, dev)
    k = _floor_constants(frame.fx, frame.fy, frame.voxel_leaf)
    list_cap = 8 * cap_per
    scratch_i = torch.empty((n_streams, n_blocks + 3 * list_cap), dtype=torch.int32, device=dev)
    scratch_f = torch.empty((n_streams, list_cap * 16), dtype=torch.float32, device=dev)
    code = _build.lib().trackdlo_split_cells(
        rgb.data_ptr(), depth.data_ptr(), occ.data_ptr(), n_streams, h, w, int(frame.cell_px),
        bands.data_ptr(), bands.numel() // 6, float(frame.fx), float(frame.fy), float(frame.cx),
        float(frame.cy), k["kx"], k["ky"], k["k_zq"], k["kz"], int(k["z_from_mm"]), tile,
        frame.split.mask.data_ptr(), frame.split.counts.data_ptr(), pts.data_ptr(),
        cnt.data_ptr(), valid.data_ptr(), cap_per, list_cap, scratch_i.data_ptr(),
        scratch_f.data_ptr(), _build.stream_ptr(dev),
    )
    _build.check(code, "trackdlo_split_cells")
    _build.count_launch("split_cells")
    index = torch.cuda._get_device_index(dev, optional=True)
    if index not in _split_work:
        _split_work[index] = _SplitWork(torch.device("cuda", index))
        _build.register_device_counter(_split_work[index])
    return pts, cnt, valid
