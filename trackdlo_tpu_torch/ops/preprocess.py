"""Per-frame preprocessing: mask → deproject → cell pooling → compaction →
voxel snap.

Counterpart of trackdlo_tpu/ops/preprocess.py. :func:`cell_sums_plain` is
the plain version of kernel P (the pooling of ``preprocess_frame``) in its
three modes: the parity split (the shipped profile), one channel with the
voxel floor votes (the coarse two-stage path, ``parity_split=False``) and
one channel with no leaf (``exact_voxels=False``). The single-channel modes
end in :func:`compact_cells`: a stable ``torch.sort`` of the occupied cells
then gathers (the JAX package's ``lax.sort``), the vote keys of
:func:`pack_vote_keys` riding along, and :func:`voxel_snap`. After the
parity pooling:

- :func:`compact_occupied_channels` runs kernel C (csrc/compact.cu, the
  counterpart of the one-hot compaction kernel) in its derived mode: one
  launch picks the kept cells by the even-stride overflow thinning of
  :func:`kept_cells`, packs them and divides the centroids (packed slots
  are exact copies of cells, so the quotient commutes with the pack); its
  plain version, taken for CPU tensors, is that composition, with the
  packed-key sort back end for the pack (``torch.sort(stable=True)`` then
  gathers; torch has no multi-operand sort). :func:`compact_channels`
  packs explicit kept cells with the same kernel;
- the voxel snap pins knife-edge voxel indices to the channel parity and sums
  each sorted, contiguous segment in order (``torch.segment_reduce``), never
  with float atomics.

Under a stream batch (the batched step) the cell sums carry a leading stream
axis, the B·8 channel rows compact in one launch of kernel C and snap
together (every step is row-local), and the cap thins each stream alone.

The parity split keeps PCL's VoxelGrid only while each channel's pixels in
an image cell share one voxel. Depth noise (a millimetre or more at a 5 mm
leaf) or a cell wider than the leaf puts voxels k and k+2 of one parity in
one cell, and the JAX package's route merges them. The exact route
(``exact=True``, the step's) repairs that and keeps masked zero-depth
pixels as points at the origin, as the reference does: kernel P leaves a
split channel-cell's sums at zero and marks it (:class:`SplitCells`), and
counts the masked pixels without depth; after kernel C, kernel X
(csrc/split_cells.cu; :func:`split_groups`, plain version
:func:`split_groups_plain`) sums each marked channel-cell's pixels voxel by
voxel and appends those groups, and one candidate at the origin weighing
the pixels without depth, to their channels' candidates, which the snap
merges like any other. On a frame with neither, X reads kernel P's block
counts and exits.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from trackdlo_tpu_torch import _build
from trackdlo_tpu_torch.utils import profiling

_CNT_BITS = 14
_INT32_MAX = 2**31 - 1
_MULTI_COLOR_BANDS = (
    ((90, 90, 60), (130, 255, 255)),
    ((130, 60, 50), (255, 255, 255)),
    ((0, 60, 50), (10, 255, 255)),
    ((15, 100, 80), (40, 255, 255)),
)


class PointCloud(NamedTuple):
    points: torch.Tensor  # (N_cap, 3)
    mask: torch.Tensor  # (N_cap,)
    count: torch.Tensor  # ()


class SplitCells(NamedTuple):
    """Kernel P's exact-route outputs beside the parity sums: ``mask``
    (..., n_cells) uint8, bit c set where channel c's pixels in the cell
    span more than one voxel (its sums are left at zero); ``counts``
    (..., n_blocks, 2) int32, each block of kernel P's split channel-cells
    and masked pixels without depth (the plain version is one block)."""

    mask: torch.Tensor
    counts: torch.Tensor


class ExactFrame(NamedTuple):
    """What kernel X reads again of a frame: the frame(s) as kernel P
    took them, P's :class:`SplitCells` and P's constants."""

    rgb: torch.Tensor
    depth: torch.Tensor
    occlusion_mask: torch.Tensor
    split: SplitCells
    fx: float
    fy: float
    cx: float
    cy: float
    hsv_lower: tuple
    hsv_upper: tuple
    multi_color_dlo: bool
    cell_px: int
    voxel_leaf: float


def exact_leaf_mm(voxel_leaf: float) -> int | None:
    """The leaf size in integer millimetres, or None if not integral."""
    leaf_mm = voxel_leaf * 1000.0
    leaf_mm_i = int(round(leaf_mm))
    if leaf_mm_i > 0 and abs(leaf_mm - leaf_mm_i) < 1e-6:
        return leaf_mm_i
    return None


def floor_key_constants(fx: float, fy: float, voxel_leaf: float) -> dict:
    """The float32 constants of the bit-pinned floor chain, computed on the
    host exactly as the JAX package does (np.float32 of a float64 value)."""
    leaf_mm = exact_leaf_mm(voxel_leaf)
    return dict(
        kx=float(np.float32(1.0 / (fx * voxel_leaf))),
        ky=float(np.float32(1.0 / (fy * voxel_leaf))),
        k_zq=float(np.float32(0.001)),
        kz=float(np.float32(1.0 / leaf_mm if leaf_mm is not None else 1.0 / voxel_leaf)),
        z_from_mm=leaf_mm is not None,
    )


def voxel_floor_keys(us, vs, depth_f32, fx, fy, cx, cy, voxel_leaf):
    """Per-pixel voxel floor indices as integer-valued float32, bit-pinned:
    z in the integer-mm domain, x and y through multiply-only chains."""
    k = floor_key_constants(fx, fy, voxel_leaf)
    cxf = float(np.float32(cx))
    cyf = float(np.float32(cy))
    zq = depth_f32 * k["k_zq"]
    fkx = torch.floor(((us - cxf) * zq) * k["kx"])
    fky = torch.floor(((vs - cyf) * zq) * k["ky"])
    fkz = torch.floor((depth_f32 if k["z_from_mm"] else zq) * k["kz"])
    return fkx, fky, fkz


def voxel_parity_bits(us, vs, depth_f32, fx, fy, cx, cy, voxel_leaf):
    return tuple(
        fk.to(torch.int32) & 1
        for fk in voxel_floor_keys(us, vs, depth_f32, fx, fy, cx, cy, voxel_leaf)
    )


def rgb_to_hsv_cv(rgb: torch.Tensor) -> torch.Tensor:
    """OpenCV-convention HSV (H in [0, 180), S and V in [0, 255]) as float32
    from u8 RGB (..., 3): the counterpart of the JAX package's
    ``rgb_to_hsv_cv``, a float re-derivation of ``cv2.cvtColor(...,
    COLOR_RGB2HSV)`` in its operation order. No step calls it: the mask is
    the division-free :func:`hsv_in_range`."""
    rgbf = rgb.to(torch.float32)
    r, g, b = rgbf[..., 0], rgbf[..., 1], rgbf[..., 2]
    v = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    delta = v - mn
    delta_safe = torch.where(delta == 0, 1.0, delta)
    s = torch.where(v > 0, delta * 255.0 / torch.where(v == 0, 1.0, v), 0.0)
    h = torch.where(
        v == r,
        60.0 * (g - b) / delta_safe,
        torch.where(v == g, 120.0 + 60.0 * (b - r) / delta_safe,
                    240.0 + 60.0 * (r - g) / delta_safe),
    )
    h = torch.where(delta == 0, 0.0, h)
    h = torch.where(h < 0, h + 360.0, h) / 2.0
    return torch.stack([h, s, v], dim=-1)


def hsv_in_range(r, g, b, lower, upper):
    """Division-free HSV in-range test: products of u8-valued floats stay
    below 2^24, so every comparison is the exact rational predicate."""
    lo_h, lo_s, lo_v = (float(v) for v in lower)
    hi_h, hi_s, hi_v = (float(v) for v in upper)
    v = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    d = v - mn
    s_test = (255.0 * d >= lo_s * v) & (255.0 * d <= hi_s * v)
    s_ok = (s_test | (v <= 0)) if lo_s <= 0.0 else (s_test & (v > 0))
    hn = torch.where(
        v == r, 60.0 * (g - b),
        torch.where(v == g, 120.0 * d + 60.0 * (b - r), 240.0 * d + 60.0 * (r - g)),
    )
    hn = torch.where(hn < 0, hn + 360.0 * d, hn)
    h_test = (hn >= 2.0 * lo_h * d) & (hn <= 2.0 * hi_h * d)
    h_ok = (h_test | (d <= 0)) if lo_h <= 0.0 else (h_test & (d > 0))
    return h_ok & s_ok & (v >= lo_v) & (v <= hi_v)


def hsv_bands(hsv_lower, hsv_upper, multi_color_dlo: bool) -> tuple:
    """The (lower, upper) bands a pixel may fall in (any one keeps it)."""
    if multi_color_dlo:
        return _MULTI_COLOR_BANDS
    return ((tuple(hsv_lower), tuple(hsv_upper)),)


def segment_mask(rgb, hsv_lower, hsv_upper, multi_color_dlo: bool):
    rgbf = rgb.to(torch.float32)
    r, g, b = rgbf[..., 0], rgbf[..., 1], rgbf[..., 2]
    mask = None
    for lo, hi in hsv_bands(hsv_lower, hsv_upper, multi_color_dlo):
        band = hsv_in_range(r, g, b, lo, hi)
        mask = band if mask is None else mask | band
    return mask


def depth_mm_f32(depth: torch.Tensor) -> torch.Tensor:
    """u16 millimetres (held as uint16 or as the same bits in int16) → f32."""
    return (depth.view(torch.int16).to(torch.int32) & 0xFFFF).to(torch.float32)


def cell_sums_mode(parity_split: bool, voxel_leaf, with_votes: bool) -> str:
    """Kernel P's mode: ``"parity"`` (8 channels), ``"votes"`` (one channel
    with the voxel floor votes) or ``"cells"`` (one channel, no leaf)."""
    if parity_split:
        if voxel_leaf is None or with_votes:
            raise ValueError("the parity split needs a voxel leaf and takes no votes")
        return "parity"
    if with_votes:
        if voxel_leaf is None:
            raise ValueError("the floor votes need a voxel leaf")
        return "votes"
    return "cells"


def cell_sums_plain(rgb, depth, occlusion_mask, fx, fy, cx, cy, hsv_lower,
                    hsv_upper, multi_color_dlo, cell_px, voxel_leaf,
                    parity_split: bool = True, with_votes: bool = False, exact: bool = False):
    """Kernel P's plain version, the pooling of the JAX ``preprocess_frame``.

    Parity mode: raw (Σx, Σy, Σz, count) per (parity channel, image cell),
    four (8, n_rows·n_cols) float32 tensors in raster order, channel index
    bx·4 + by·2 + bz. With ``parity_split=False``: (Σx, Σy, Σz, count) per
    cell, four (n_rows·n_cols,) tensors, and with ``with_votes`` three more,
    the sums of the per-pixel voxel floors (Σfkx, Σfky, Σfkz): integers, so
    exact in any order. Frames with a leading stream axis (B, H, W) give a
    leading B on every output, one stream at a time.

    ``exact`` (parity mode; the step's route): a channel-cell whose pixels
    span more than one voxel keeps zero sums, and a fifth output,
    :class:`SplitCells`, marks it and counts the masked pixels with no
    depth (the reference's points at the origin) for :func:`split_groups`."""
    mode = cell_sums_mode(parity_split, voxel_leaf, with_votes)
    exact = exact and mode == "parity"
    if depth.ndim == 3:
        per = [cell_sums_plain(rgb[i], depth[i], occlusion_mask[i], fx, fy, cx, cy, hsv_lower,
                               hsv_upper, multi_color_dlo, cell_px, voxel_leaf, parity_split,
                               with_votes, exact)
               for i in range(depth.shape[0])]
        out = tuple(torch.stack(q) for q in zip(*(p[:4] if exact else p for p in per)))
        if exact:
            out += (SplitCells(*(torch.stack(q) for q in zip(*(p[4] for p in per)))),)
        return out
    h, w = depth.shape
    dev = depth.device
    dmm = depth_mm_f32(depth)
    mask = segment_mask(rgb, hsv_lower, hsv_upper, multi_color_dlo) & occlusion_mask
    no_depth = (mask & (dmm == 0)).sum() if exact else None
    mask = mask & (dmm > 0)
    z = dmm / 1000.0
    us = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    vs = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    px = (us - cx) * z / fx
    py = (vs - cy) * z / fy
    n_rows, n_cols = -(-h // cell_px), -(-w // cell_px)
    ph, pw = n_rows * cell_px - h, n_cols * cell_px - w

    def pool(img):
        img = torch.nn.functional.pad(img, (0, pw, 0, ph))
        return img.reshape(n_rows, cell_px, n_cols, cell_px).sum(dim=(1, 3)).reshape(-1)

    if mode != "parity":
        wgt = mask.to(torch.float32)
        quantities = [px, py, z, torch.ones_like(z)]
        if mode == "votes":
            quantities += voxel_floor_keys(us, vs, dmm, fx, fy, cx, cy, voxel_leaf)
        return tuple(pool(q * wgt) for q in quantities)
    bx, by, bz = voxel_parity_bits(us, vs, dmm, fx, fy, cx, cy, voxel_leaf)
    ch = bx * 4 + by * 2 + bz
    out = torch.empty((4, 8, n_rows * n_cols), dtype=torch.float32, device=dev)
    for c in range(8):
        wgt = (mask & (ch == c)).to(torch.float32)
        out[0, c] = pool(px * wgt)
        out[1, c] = pool(py * wgt)
        out[2, c] = pool(z * wgt)
        out[3, c] = pool(wgt)
    if not exact:
        return out[0], out[1], out[2], out[3]
    split = _split_channel_cells(mask, ch, voxel_floor_keys(us, vs, dmm, fx, fy, cx, cy, voxel_leaf),
                                 cell_px, n_cols, n_rows * n_cols)
    out = torch.where(split, 0.0, out)
    bits = (split.to(torch.int32) << torch.arange(8, dtype=torch.int32, device=dev)[:, None]).sum(0)
    counts = torch.stack([split.sum(), no_depth]).to(torch.int32).reshape(1, 2)
    return out[0], out[1], out[2], out[3], SplitCells(bits.to(torch.uint8), counts)


def _cell_index(h: int, w: int, cell_px: int, n_cols: int, device) -> torch.Tensor:
    """Each pixel's image cell in raster order, (h, w) int64."""
    rows = torch.arange(h, device=device)[:, None] // cell_px
    return rows * n_cols + torch.arange(w, device=device)[None, :] // cell_px


def _split_channel_cells(mask, ch, keys, cell_px, n_cols, n_cells) -> torch.Tensor:
    """(8, n_cells) bool: the (parity channel, cell) pairs whose masked
    pixels carry more than one voxel index, from each axis' least and
    greatest floor over them."""
    h, w = mask.shape
    slot = (ch.to(torch.int64) * n_cells + _cell_index(h, w, cell_px, n_cols, mask.device))[mask]
    split = torch.zeros(8 * n_cells, dtype=torch.bool, device=mask.device)
    for k in keys:
        k = k.to(torch.int32).expand(h, w)[mask]
        lo = torch.zeros_like(split, dtype=torch.int32).scatter_reduce(0, slot, k, "amin",
                                                                       include_self=False)
        hi = torch.zeros_like(split, dtype=torch.int32).scatter_reduce(0, slot, k, "amax",
                                                                       include_self=False)
        split |= lo != hi
    return split.reshape(8, n_cells)


def split_groups_plain(frame: ExactFrame, pts, cnt, valid):
    """Kernel X's plain version: the masked pixels of each split
    channel-cell of ``frame.split`` summed voxel by voxel, each voxel's
    centroid and count appended to its channel's row of kernel C's output
    (``pts`` (B·8, cap_per, 3), ``cnt`` and ``valid`` (B·8, cap_per)) after
    the row's packed cells: a channel's groups in ascending cell order, a
    cell's in ascending voxel (x, then y, then z). After channel 0's groups,
    one candidate at the origin whose count is the masked pixels without
    depth, where there are any. Groups past a row's ``cap_per`` slots are
    dropped. Returns new tensors; reads nothing on the host (the selections
    are index tensors)."""
    rgb, depth, occ = frame.rgb, frame.depth, frame.occlusion_mask
    if depth.ndim == 2:
        rgb, depth, occ = rgb[None], depth[None], occ[None]
    n_streams = depth.shape[0]
    cap_per = pts.shape[-2]
    n_cols = -(-depth.shape[-1] // frame.cell_px)
    bits = frame.split.mask.reshape(n_streams, -1)
    pts, cnt, valid = (a.reshape(n_streams, 8 * cap_per, *a.shape[2:]) for a in (pts, cnt, valid))
    out = [_split_groups_stream(rgb[b], depth[b], occ[b], bits[b], frame, n_cols, pts[b], cnt[b],
                                valid[b]) for b in range(n_streams)]
    return tuple(torch.stack(q).reshape(n_streams * 8, cap_per, *q[0].shape[1:])
                 for q in zip(*out))


def split_groups(frame: ExactFrame, pts, cnt, valid):
    """Kernel X (csrc/split_cells.cu; ``ops.preprocess_kernel.split_cells``)
    on kernel C's rows in place for CUDA tensors; for CPU tensors its plain
    version, :func:`split_groups_plain`."""
    if pts.device.type == "cpu":
        return split_groups_plain(frame, pts, cnt, valid)
    from trackdlo_tpu_torch.ops.preprocess_kernel import split_cells

    return split_cells(frame, pts, cnt, valid)


def _split_groups_stream(rgb, depth, occ, bits, frame: ExactFrame, n_cols, pts, cnt, valid):
    """:func:`split_groups_plain` for one stream: rows (8·cap_per, ...)."""
    dev = depth.device
    cap_per = pts.shape[0] // 8
    dmm = depth_mm_f32(depth)
    mask = segment_mask(rgb, frame.hsv_lower, frame.hsv_upper, frame.multi_color_dlo) & occ
    no_depth = (mask & (dmm == 0)).sum()
    vi, ui = torch.nonzero(mask & (dmm > 0), as_tuple=True)  # raster order
    d = dmm[vi, ui]
    us, vs = ui.to(torch.float32), vi.to(torch.float32)
    keys = [k.to(torch.int32) for k in voxel_floor_keys(us, vs, d, frame.fx, frame.fy, frame.cx,
                                                        frame.cy, frame.voxel_leaf)]
    ch = (keys[0] & 1) * 4 + (keys[1] & 1) * 2 + (keys[2] & 1)
    cell = (vi // frame.cell_px) * n_cols + ui // frame.cell_px
    sel = ((bits[cell].to(torch.int32) >> ch) & 1) == 1
    z = d[sel] / 1000.0
    vals = torch.stack([(us[sel] - frame.cx) * z / frame.fx, (vs[sel] - frame.cy) * z / frame.fy,
                        z, torch.ones_like(z)], dim=-1)
    fields = torch.stack([ch, cell.to(torch.int32), *keys], dim=-1)[sel]
    # Ordered by (channel, cell, kx, ky, kz), in raster order within a
    # voxel: stable sorts, least significant first.
    order = torch.arange(len(fields), device=dev)
    for col in (4, 3, 2, 1, 0):
        order = order[torch.sort(fields[order, col], stable=True).indices]
    fields, vals = fields[order], vals[order]
    new = torch.ones(len(fields), dtype=torch.bool, device=dev)
    new[1:] = (fields[1:] != fields[:-1]).any(-1)
    gid = torch.cumsum(new.to(torch.int64), 0) - 1
    first = torch.nonzero(new).reshape(-1)
    sums = torch.zeros((len(first) + 1, 4), dtype=torch.float32, device=dev).index_add_(0, gid, vals)
    g_ch = torch.cat([fields[first, 0].to(torch.int64), torch.zeros(1, dtype=torch.int64,
                                                                     device=dev)])
    per_ch = torch.zeros(8, dtype=torch.int64, device=dev).index_add_(
        0, g_ch[:-1], torch.ones_like(g_ch[:-1]))
    rank = torch.arange(len(g_ch), device=dev) - (torch.cumsum(per_ch, 0) - per_ch)[g_ch]
    slot = valid.reshape(8, cap_per).sum(-1)[g_ch] + rank
    # The origin's candidate rides in the last group, after channel 0's.
    slot[-1] = valid[:cap_per].sum() + per_ch[0]
    sums[-1, 3] = no_depth.to(torch.float32)
    ok = (sums[:, 3] > 0) & (slot < cap_per)
    dest = torch.where(ok, g_ch * cap_per + slot, 8 * cap_per)
    centroid = sums[:, :3] / torch.clamp_min(sums[:, 3:], 1.0)
    spare = lambda a, v: torch.cat([a, torch.full((1, *a.shape[1:]), v, dtype=a.dtype,  # noqa: E731
                                                  device=dev)])
    pts = spare(pts, 0.0).index_put_((dest,), centroid)[:-1]
    cnt = spare(cnt, 0.0).index_put_((dest,), sums[:, 3])[:-1]
    valid = spare(valid, False).index_put_((dest,), ok)[:-1]
    return pts, cnt, valid


def kept_cells(counts, cap_per):
    """The occupied cells to compact, (C, n_per) bool. Where a channel has
    more occupied cells than ``cap_per`` slots, an even stride of them, so an
    overflow thins density instead of cutting off a band of the image."""
    vch = counts > 0
    if counts.shape[1] <= cap_per:
        return vch
    vi = vch.to(torch.int64)
    n_eff = torch.clamp_min(vi.sum(dim=1, keepdim=True), cap_per)
    rank = torch.cumsum(vi, dim=1) - vi
    return vch & ((rank + 1) * cap_per // n_eff > rank * cap_per // n_eff)


def compact_channels_plain(xs, ys, zs, counts, kept, cap_per):
    """Kernel C's plain version, the packed-key sort: each channel's kept
    cells packed into its first ``cap_per`` slots in ascending cell order,
    later slots zero and invalid. The count rides the low 14 bits of the
    packed key, so one int32 sort orders every operand."""
    c_ch, n_per = counts.shape
    assert n_per < (1 << (31 - _CNT_BITS)), "cell grid too large for packed keys"
    idx = torch.arange(n_per, dtype=torch.int32, device=counts.device)[None, :]
    keys = (torch.where(kept, idx, n_per) << _CNT_BITS) | torch.clamp_max(
        counts, float((1 << _CNT_BITS) - 1)
    ).to(torch.int32)
    if n_per < cap_per:
        pad = torch.full((c_ch, cap_per - n_per), n_per << _CNT_BITS, dtype=torch.int32, device=counts.device)
        keys = torch.cat([keys, pad], dim=1)
        xs, ys, zs = (torch.nn.functional.pad(a, (0, cap_per - n_per)) for a in (xs, ys, zs))
    key_s, order = torch.sort(keys, dim=1, stable=True)
    kk = key_s[:, :cap_per]
    o = order[:, :cap_per]
    valid = (kk >> _CNT_BITS) < n_per
    cnt = torch.where(valid, (kk & ((1 << _CNT_BITS) - 1)).to(torch.float32), 0.0)
    pts = torch.stack([xs.gather(1, o), ys.gather(1, o), zs.gather(1, o)], dim=-1)
    return torch.where(valid[..., None], pts, 0.0), cnt, valid


def _compact_launch(name, xs, ys, zs, counts, kept, cap_per, divide):
    """Kernel C on CUDA tensors: ``kept`` (C, n_per) bool, or None to derive
    the kept cells from ``counts`` by :func:`kept_cells`' rule; ``divide``
    stores x / max(cnt, 1) in the slots."""
    tensors = dict(xs=xs, ys=ys, zs=zs, counts=counts)
    if kept is not None:
        tensors["kept"] = kept
    dev = _build.require_cuda(name, tensors, dict(kept=torch.bool))
    c_ch, n_per = counts.shape
    if any(tuple(a.shape) != (c_ch, n_per) for a in tensors.values()):
        raise ValueError(f"{name}: xs/ys/zs/kept shapes do not match counts")
    if kept is None and n_per * cap_per >= 2**31:
        # The thinning's ranks times cap_per are int32, as the JAX package's.
        raise ValueError(f"{name}: n_per * cap_per = {n_per * cap_per} overflows int32")
    pts = torch.empty((c_ch, cap_per, 3), dtype=torch.float32, device=dev)
    cnt = torch.empty((c_ch, cap_per), dtype=torch.float32, device=dev)
    valid = torch.empty((c_ch, cap_per), dtype=torch.bool, device=dev)
    code = _build.lib().trackdlo_compact(
        xs.data_ptr(), ys.data_ptr(), zs.data_ptr(), counts.data_ptr(),
        None if kept is None else kept.data_ptr(), c_ch, n_per, int(cap_per), int(divide),
        pts.data_ptr(), cnt.data_ptr(), valid.data_ptr(), _build.stream_ptr(dev),
    )
    _build.check(code, "trackdlo_compact")
    _build.count_launch("compact")
    return pts, cnt, valid


def compact_channels(xs, ys, zs, counts, kept, cap_per):
    """Pack each channel's kept cells into its first ``cap_per`` slots in
    ascending cell order (kernel C, csrc/compact.cu; the plain version for
    CPU tensors). ``xs``/``ys``/``zs``/``counts`` (C, n_per) float32, ``kept``
    (C, n_per) bool. Returns points (C, cap_per, 3), counts (C, cap_per) and
    valid (C, cap_per); slots past the kept count are zero and invalid."""
    if counts.device.type == "cpu":
        return compact_channels_plain(xs, ys, zs, counts, kept, cap_per)
    return _compact_launch("compact_channels", xs, ys, zs, counts, kept, cap_per, False)


def compact_occupied_channels_plain(xs, ys, zs, counts, cap_per, inputs_are_sums: bool = False):
    """Kernel C's derived mode in plain tensor ops: :func:`kept_cells`, then
    :func:`compact_channels_plain` and, for raw sums, the centroid division
    x / max(cnt, 1)."""
    pts, cnt, valid = compact_channels_plain(xs, ys, zs, counts, kept_cells(counts, cap_per), cap_per)
    if inputs_are_sums:
        pts = pts / torch.clamp_min(cnt, 1.0)[..., None]
    return pts, cnt, valid


def compact_occupied_channels(xs, ys, zs, counts, cap_per, inputs_are_sums: bool = False):
    """Pack each channel's occupied cells (count > 0), thinned by an even
    stride where they overflow ``cap_per`` (:func:`kept_cells`), into its
    first ``cap_per`` slots in ascending cell order; with
    ``inputs_are_sums`` the slots hold the centroids x / max(cnt, 1) of the
    raw sums. One launch of kernel C for CUDA tensors, bit-equal to
    :func:`compact_occupied_channels_plain`, which the CPU takes. Same
    shapes and outputs as :func:`compact_channels`."""
    if counts.device.type == "cpu":
        return compact_occupied_channels_plain(xs, ys, zs, counts, cap_per, inputs_are_sums)
    return _compact_launch("compact_occupied_channels", xs, ys, zs, counts, None, cap_per,
                           inputs_are_sums)


def _pack_rel_keys(ijk, valid):
    """Voxel indices (..., P, 3) rebased to the minimum over the valid rows
    and packed as rel-x<<20 | rel-y<<10 | rel-z (each clipped to 10 bits)."""
    ijk_min = torch.where(valid[..., None], ijk, _INT32_MAX).amin(dim=-2, keepdim=True)
    rel = (ijk - ijk_min).clamp(0, (1 << 10) - 1)
    return rel[..., 0] * (1 << 20) + rel[..., 1] * (1 << 10) + rel[..., 2]


def pack_vote_keys(key_sums, counts, valid):
    """Per-cell packed voxel key from the pooled floor votes: the rounded
    mean vote per axis, rebased over the valid cells and packed like
    :func:`voxel_snap`'s floor keys. ``key_sums`` (..., C, 3), ``counts`` and
    ``valid`` (..., C); returns (..., C) int32. Call it on every cell before
    any is dropped: the rebasing minimum runs over all valid cells."""
    cnt = torch.clamp_min(counts, 1.0)
    kv = torch.floor(key_sums / cnt[..., None] + 0.5).to(torch.int32)
    return _pack_rel_keys(kv, valid)


def _voxel_snap_channels(points, weights, leaf, parities=None, keys=None):
    """Per-channel voxel snap: (C, P, 3) candidates → (C·P, 3) weighted voxel
    centroids. Voxel duplicates are channel-local under the parity split;
    ``parities`` (C, 3) pins a knife-edge centroid's voxel index to its
    channel's parity (the pixels' own floor vote). ``keys`` (C, P) int32,
    when given, are the candidates' voxel keys (the coarse path's vote keys)
    in place of their centroids' floors."""
    c_ch, p = points.shape[:2]
    dev = points.device
    valid = weights > 0
    if keys is None:
        f = points * (1.0 / leaf)
        ijk = torch.floor(f).to(torch.int32)
        if parities is not None:
            mismatch = (ijk & 1) != parities[:, None, :]
            adj = torch.where(f - ijk.to(torch.float32) >= 0.5, 1, -1).to(torch.int32)
            ijk = torch.where(mismatch, ijk + adj, ijk)
        keys = _pack_rel_keys(ijk, valid)
    key = torch.where(valid, keys, _INT32_MAX)
    w_eff = torch.where(valid, weights, 0.0)
    key_s, order = torch.sort(key, dim=1, stable=True)
    data = torch.stack(
        [w_eff, points[..., 0] * w_eff, points[..., 1] * w_eff, points[..., 2] * w_eff], dim=-1
    ).gather(1, order[..., None].expand(c_ch, p, 4))
    new_seg = torch.cat(
        [torch.ones((c_ch, 1), dtype=torch.bool, device=dev), key_s[:, 1:] != key_s[:, :-1]], dim=1
    )
    seg_id = (
        torch.cumsum(new_seg.to(torch.int64), dim=1) - 1
        + torch.arange(c_ch, device=dev)[:, None] * p
    ).reshape(-1)
    bounds = torch.arange(c_ch * p, device=dev)
    lengths = torch.searchsorted(seg_id, bounds, right=True) - torch.searchsorted(seg_id, bounds)
    sums = torch.segment_reduce(data.reshape(-1, 4), "sum", lengths=lengths, axis=0, unsafe=True)
    wsum = sums[:, 0]
    centroids = sums[:, 1:] / torch.clamp_min(wsum, 1.0)[:, None]
    out_valid = wsum > 0
    return torch.where(out_valid[:, None], centroids, 0.0), out_valid


def _cap_snapped(snapped, snap_valid, cap, max_points):
    """Fit ``cap`` snapped centroids (..., cap, 3) into ``max_points`` slots,
    thinning an overflow with an even stride over the valid entries of each
    stream."""
    if cap > max_points:
        vi = snap_valid.to(torch.int64)
        n_eff = torch.clamp_min(vi.sum(dim=-1, keepdim=True), max_points)
        rank_v = torch.cumsum(vi, -1) - vi
        kept = snap_valid & ((rank_v + 1) * max_points // n_eff > rank_v * max_points // n_eff)
        i = torch.arange(snapped.shape[-2], device=snapped.device)
        key_k, order = torch.sort(torch.where(kept, i, cap), dim=-1, stable=True)
        valid = key_k[..., :max_points] < cap
        idx = order[..., :max_points, None].expand(*order.shape[:-1], max_points, 3)
        points = snapped.gather(-2, idx)
    else:
        points = snapped[..., :max_points, :]
        valid = snap_valid[..., :max_points]
    return torch.where(valid[..., None], points, 0.0), valid


def voxel_snap(points, weights, leaf, vote_keys=None):
    """Weighted centroid per voxel over a fixed-capacity candidate set:
    points (..., C, 3), weights (..., C) → centroids (..., C, 3) and their
    validity, in voxel-key order. The key is the candidates' packed vote key
    (``vote_keys`` (..., C) int32) or else the floor of each centroid over
    ``leaf``, rebased over the valid candidates of each row."""
    lead, c = points.shape[:-2], points.shape[-2]
    keys = None if vote_keys is None else vote_keys.reshape(-1, c)
    snapped, valid = _voxel_snap_channels(points.reshape(-1, c, 3), weights.reshape(-1, c), leaf,
                                          keys=keys)
    return snapped.reshape(*lead, c, 3), valid.reshape(*lead, c)


def compact_cells(xs, ys, zs, counts, max_points, voxel_leaf, candidate_cap=4096,
                  key_sums=None, inputs_are_sums: bool = False) -> PointCloud:
    """Single-channel compaction of per-cell centroids (raw sums when
    ``inputs_are_sums``) into the fixed-capacity cloud, then the voxel snap:
    the JAX package's ``compact_cells(n_channels=1)``.

    ``xs``/``ys``/``zs``/``counts`` (..., n_cells) in raster order;
    ``key_sums`` (..., n_cells, 3), the pooled floor votes of the coarse
    two-stage path. The occupied cells go to the first slots in ascending
    cell order (a stable ``torch.sort`` of the cell index, then gathers, as
    the JAX package's ``lax.sort``); without a leaf an overflow of
    ``max_points`` is thinned with an even stride (:func:`kept_cells`), with
    one the candidate cap keeps the first ones. With ``key_sums`` the vote
    keys are packed over every cell before the pack and ride along to key
    the snap. A leading stream axis gives a batched cloud; every step is
    row-local."""
    lead, n_cells = counts.shape[:-1], counts.shape[-1]
    xs, ys, zs, counts = (a.reshape(-1, n_cells) for a in (xs, ys, zs, counts))
    dev = counts.device
    cap = candidate_cap if voxel_leaf is not None else max_points
    cell_valid = counts > 0
    use_votes = key_sums is not None and voxel_leaf is not None
    kept = kept_cells(counts, cap) if voxel_leaf is None else cell_valid
    idx = torch.arange(n_cells, device=dev)[None, :]
    key_s, order = torch.sort(torch.where(kept, idx, n_cells), dim=-1, stable=True)
    take = min(cap, n_cells)
    key_s, order = key_s[:, :take], order[:, :take]
    valid = key_s < n_cells
    pts = torch.stack([xs.gather(1, order), ys.gather(1, order), zs.gather(1, order)], dim=-1)
    cnt = counts.gather(1, order)
    if inputs_are_sums:
        pts = pts / torch.clamp_min(cnt, 1.0)[..., None]
    points = torch.where(valid[..., None], pts, 0.0)
    vote_keys = None
    if use_votes:
        vote_keys = pack_vote_keys(key_sums.reshape(-1, n_cells, 3), counts, cell_valid)
        vote_keys = vote_keys.gather(1, order)
    if n_cells < cap:
        # Fewer cells than slots: pad to the static cap.
        pad = cap - n_cells
        points = torch.nn.functional.pad(points, (0, 0, 0, pad))
        valid, cnt = (torch.nn.functional.pad(a, (0, pad)) for a in (valid, cnt))
        if vote_keys is not None:
            vote_keys = torch.nn.functional.pad(vote_keys, (0, pad))
    if voxel_leaf is not None:
        w = torch.where(valid, cnt, 0.0)
        snapped, snap_valid = voxel_snap(points, w, voxel_leaf, vote_keys)
        points, valid = _cap_snapped(snapped, snap_valid, cap, max_points)
    points = points.reshape(lead + points.shape[1:])
    valid = valid.reshape(lead + valid.shape[1:])
    return PointCloud(points=points, mask=valid, count=valid.to(torch.int64).sum(dim=-1))


def compact_parity_channels(xs, ys, zs, counts, max_points, voxel_leaf,
                            candidate_cap, inputs_are_sums: bool = False,
                            exact: ExactFrame | None = None) -> PointCloud:
    """Parity-channel compaction from (n_channels, n_per) cell arrays (raw
    sums when ``inputs_are_sums``), then the channel-batched voxel snap.
    Arrays with a leading stream axis (B, n_channels, n_per) give a batched
    cloud: points (B, max_points, 3), mask (B, max_points), count (B,).
    ``exact``: the sums are kernel P's exact route's, and the split
    channel-cells' voxels join their rows before the snap
    (:func:`split_groups`)."""
    lead = counts.shape[:-2]
    n_channels, n_per = counts.shape[-2:]
    rows = lambda a: a.reshape(-1, n_per)
    xs, ys, zs, counts = (rows(a) for a in (xs, ys, zs, counts))
    n_streams = counts.shape[0] // n_channels
    dev = counts.device
    cap = candidate_cap if voxel_leaf is not None else max_points
    cap_per = cap // n_channels
    pts_ch, cnt_s, valid_ch = compact_occupied_channels(xs, ys, zs, counts, cap_per, inputs_are_sums)
    if exact is not None:
        with profiling.device_span("preprocess.split_cells", dev):
            pts_ch, cnt_s, valid_ch = split_groups(exact, pts_ch, cnt_s, valid_ch)
    if voxel_leaf is not None:
        w_ch = torch.where(valid_ch, cnt_s, 0.0)
        parities = None
        if n_channels == 8:
            # Channel c's parity bits (c>>2, c>>1, c) & 1, made on the device:
            # a table copied from host memory would block the host each frame.
            c = torch.arange(8, dtype=torch.int32, device=dev)[:, None]
            parities = (c >> torch.arange(2, -1, -1, dtype=torch.int32, device=dev)) & 1
            parities = parities.repeat(n_streams, 1)
        snapped, snap_valid = _voxel_snap_channels(pts_ch, w_ch, voxel_leaf, parities)
        snapped = snapped.reshape(n_streams, cap_per * n_channels, 3)
        snap_valid = snap_valid.reshape(n_streams, cap_per * n_channels)
        points, valid = _cap_snapped(snapped, snap_valid, cap_per * n_channels, max_points)
    else:
        valid = valid_ch.reshape(n_streams, -1)
        points = torch.where(valid[..., None], pts_ch.reshape(n_streams, -1, 3), 0.0)
    points = points.reshape(lead + points.shape[1:])
    valid = valid.reshape(lead + valid.shape[1:])
    return PointCloud(points=points, mask=valid, count=valid.to(torch.int64).sum(dim=-1))


def default_cell_px(leaf_size: float, fx: float, z_ref: float = 0.65) -> int:
    """Cell size whose footprint at z_ref matches the voxel leaf."""
    return max(2, int(round(leaf_size * fx / z_ref)))


def preprocess_frame(rgb, depth, occlusion_mask, fx, fy, cx, cy, hsv_lower,
                     hsv_upper, multi_color_dlo, cell_px, max_points,
                     voxel_leaf=None, candidate_cap=4096,
                     parity_split=True, exact: bool = False) -> PointCloud:
    """The plain preprocessing: kernel P's plain version, then the shared
    compaction. Three paths, as in the JAX package: the parity split with a
    voxel leaf; one channel with the floor votes and the snap (the coarse
    two-stage path, ``parity_split=False``); one channel of cell centroids
    (``voxel_leaf=None``). ``exact``: the parity split's exact route (the
    step's), PCL's VoxelGrid of the masked cloud at any depth noise, with
    masked pixels without depth at the origin."""
    assert cell_px * cell_px <= (1 << _CNT_BITS) - 1, "cell counts overflow the packed key"
    parity = parity_split and voxel_leaf is not None
    args = (rgb, depth, occlusion_mask, fx, fy, cx, cy, hsv_lower, hsv_upper, multi_color_dlo,
            cell_px, voxel_leaf)
    sums = cell_sums_plain(*args, parity_split=parity,
                           with_votes=not parity and voxel_leaf is not None, exact=exact)
    return compact_sums(sums, max_points, voxel_leaf, candidate_cap, parity,
                        exact_frame(args, sums) if exact and parity else None)


def exact_frame(args: tuple, sums: tuple) -> ExactFrame:
    """Kernel X's inputs from kernel P's arguments (frames, camera, bands,
    cell size, leaf) and its exact route's outputs."""
    return ExactFrame(*args[:3], sums[4], *args[3:])


def compact_sums(sums, max_points, voxel_leaf, candidate_cap, parity: bool,
                 exact: ExactFrame | None = None) -> PointCloud:
    """The cloud from kernel P's raw sums: the four parity grids
    (``parity``; with ``exact``, the exact route's), or the four
    single-channel sums and, on the coarse two-stage path, the three
    floor-vote sums after them."""
    sx, sy, sz, cnt = sums[:4]
    if parity:
        return compact_parity_channels(sx, sy, sz, cnt, max_points, voxel_leaf, candidate_cap,
                                       inputs_are_sums=True, exact=exact)
    key_sums = torch.stack(sums[4:], dim=-1) if len(sums) == 7 else None
    return compact_cells(sx, sy, sz, cnt, max_points, voxel_leaf, candidate_cap,
                         key_sums=key_sums, inputs_are_sums=True)
