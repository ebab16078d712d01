"""Skeleton extraction: mask → thinning → ordered pixel chains.

Re-implementation of the reference's extract_connected_skeleton
(trackdlo/src/utils.py:160-453, itself adapted from "Deformable
One-Dimensional Object Detection for Routing and Manipulation"): mode-filter
smoothing, Zhang-Suen thinning (scikit-image's 'zha' method, written out here
since skimage is not a dependency), contour traversal into
direction-coherent chains, overlap pruning via rotated-rectangle
intersection, and Hungarian tip-matching to merge chains into one ordered
traversal of the DLO.
"""

from __future__ import annotations

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


# --------------------------------------------------------------------------
# Zhang-Suen thinning
# --------------------------------------------------------------------------

def zhang_suen_skeletonize(mask: np.ndarray) -> np.ndarray:
    """Zhang-Suen thinning of a binary mask (the 'zha' method of
    skimage.morphology.skeletonize used at utils.py:179).

    Vectorized over the image; iterates the two sub-passes until no pixel
    changes. Returns a uint8 {0,255} skeleton.
    """
    img = (mask > 0).astype(np.uint8)
    img = np.pad(img, 1)

    def neighbours(a):
        # p2..p9 clockwise from north (Zhang-Suen convention).
        return (
            a[:-2, 1:-1],  # p2 N
            a[:-2, 2:],    # p3 NE
            a[1:-1, 2:],   # p4 E
            a[2:, 2:],     # p5 SE
            a[2:, 1:-1],   # p6 S
            a[2:, :-2],    # p7 SW
            a[1:-1, :-2],  # p8 W
            a[:-2, :-2],   # p9 NW
        )

    while True:
        changed = False
        for phase in (0, 1):
            p2, p3, p4, p5, p6, p7, p8, p9 = neighbours(img)
            center = img[1:-1, 1:-1]
            ring = [p2, p3, p4, p5, p6, p7, p8, p9]
            b = sum(ring)
            a_trans = sum(
                ((ring[i] == 0) & (ring[(i + 1) % 8] == 1)).astype(np.uint8)
                for i in range(8)
            )
            if phase == 0:
                cond3 = (p2 * p4 * p6) == 0
                cond4 = (p4 * p6 * p8) == 0
            else:
                cond3 = (p2 * p4 * p8) == 0
                cond4 = (p2 * p6 * p8) == 0
            delete = (
                (center == 1)
                & (b >= 2)
                & (b <= 6)
                & (a_trans == 1)
                & cond3
                & cond4
            )
            if delete.any():
                img[1:-1, 1:-1][delete] = 0
                changed = True
        if not changed:
            break

    return (img[1:-1, 1:-1] * 255).astype(np.uint8)


def _mode_filter(mask: np.ndarray, size: int = 15) -> np.ndarray:
    """PIL ModeFilter smoothing (utils.py:163-165). For a binary mask the
    mode filter is a majority filter; use a box-sum threshold."""
    if cv2 is not None:
        binary = (mask > 0).astype(np.int32)
        box = cv2.boxFilter(binary, cv2.CV_32S, (size, size), normalize=False)
        return np.where(box * 2 > size * size, 255, 0).astype(np.uint8)
    from PIL import Image, ImageFilter

    im = Image.fromarray(mask)
    return np.array(im.filter(ImageFilter.ModeFilter(size=size)))


# --------------------------------------------------------------------------
# Chains
# --------------------------------------------------------------------------

class _Rect:
    __slots__ = ("pts",)

    def __init__(self, p1, p2, width):
        p1 = np.asarray(p1, float)
        p2 = np.asarray(p2, float)
        d = p2 - p1
        ang = np.arctan2(d[1], d[0])
        n1 = np.array([np.cos(ang + np.pi / 2), np.sin(ang + np.pi / 2)]) * width / 2
        n2 = np.array([np.cos(ang - np.pi / 2), np.sin(ang - np.pi / 2)]) * width / 2
        # Corner order matching build_rect (utils.py:94-104).
        self.pts = np.array([p1 + n1, p1 + n2, p2 + n2, p2 + n1])


def _segments_intersect(p1, q1, p2, q2) -> bool:
    """2-D segment intersection via orientation tests (utils.py:26-92)."""

    def orient(a, b, c):
        v = (b[1] - a[1]) * (c[0] - b[0]) - (b[0] - a[0]) * (c[1] - b[1])
        return 0 if v == 0 else (1 if v > 0 else 2)

    def on_seg(a, b, c):
        return (
            min(a[0], c[0]) <= b[0] <= max(a[0], c[0])
            and min(a[1], c[1]) <= b[1] <= max(a[1], c[1])
        )

    o1, o2 = orient(p1, q1, p2), orient(p1, q1, q2)
    o3, o4 = orient(p2, q2, p1), orient(p2, q2, q1)
    if o1 != o2 and o3 != o4:
        return True
    if o1 == 0 and on_seg(p1, p2, q1):
        return True
    if o2 == 0 and on_seg(p1, q2, q1):
        return True
    if o3 == 0 and on_seg(p2, p1, q2):
        return True
    if o4 == 0 and on_seg(p2, q1, q2):
        return True
    return False


def _rects_overlap(r1: _Rect, r2: _Rect) -> bool:
    for i in range(4):
        for j in range(4):
            if _segments_intersect(
                r1.pts[i - 1], r1.pts[i], r2.pts[j - 1], r2.pts[j]
            ):
                return True
    return False


def _chain_length(chain) -> float:
    if len(chain) < 2:
        return 0.0
    arr = np.asarray(chain, float)
    return float(np.sum(np.linalg.norm(np.diff(arr, axis=0), axis=1)))


def _contour_to_chains(contour, seg_length: float, max_curvature: float):
    """Split one contour into direction-coherent chains (utils.py:198-260)."""
    cos_limit = np.cos(max_curvature / 180.0 * np.pi)
    chains = []
    chain: list = []
    last_dir = None
    seg_start = None
    n = len(contour)
    for i in range(n):
        if i == n - 1:
            if chain:
                chains.append(chain)
            break
        pt = contour[i][0]
        if seg_start is None:
            seg_start = pt.copy()
        if np.hypot(pt[0] - seg_start[0], pt[1] - seg_start[1]) <= seg_length:
            continue
        seg_end = pt.copy()
        cur_dir = np.array(
            [seg_end[0] - seg_start[0], seg_end[1] - seg_start[1]], float
        )
        if last_dir is None:
            last_dir = cur_dir.copy()
        elif (
            np.dot(cur_dir, last_dir)
            / (np.linalg.norm(cur_dir) * np.linalg.norm(last_dir))
            >= cos_limit
        ):
            if not chain:
                chain.append(seg_start.tolist())
            chain.append(seg_end.tolist())
            seg_start = seg_end.copy()
            last_dir = cur_dir.copy()
        else:
            if chain:
                chains.append(chain)
            last_dir = None
            chain = []
            seg_start = None
    return chains


def _prune_overlaps(chains, rect_width: float = 3.0):
    """Greedy longest-first overlap pruning (utils.py:276-334)."""
    rect_cache = {}

    def rect_for(a, b):
        key = (tuple(a), tuple(b))
        if key not in rect_cache:
            rect_cache[key] = _Rect(a, b, rect_width)
        return rect_cache[key]

    remaining = sorted(chains, key=_chain_length)
    pruned = []
    for _ in range(len(chains)):
        if not remaining:
            break
        cur = remaining.pop()  # longest
        if len(cur):
            pruned.append(cur)
        cur_rects = [rect_for(cur[k], cur[k + 1]) for k in range(len(cur) - 1)]
        leftovers = []
        for test in remaining:
            trimmed: list = []
            for l in range(len(test) - 1):
                seg_rect = rect_for(test[l], test[l + 1])
                if any(_rects_overlap(cr, seg_rect) for cr in cur_rects):
                    continue
                if not trimmed:
                    trimmed.append(test[l])
                trimmed.append(test[l + 1])
            leftovers.append(trimmed)
        remaining = sorted((c for c in leftovers), key=_chain_length)
    return [c for c in pruned if len(c) >= 2]


def _tip_cost(chain1, chain2, mode, w_e=0.001, w_c=1.0) -> float:
    """Tip-to-tip match cost: weighted Euclidean + curvature continuation
    (compute_cost, utils.py:120-156). ``mode``: 0 start+start, 1 start+end,
    2 end+start, 3 end+end."""
    c1 = np.asarray(chain1, float)
    c2 = np.asarray(chain2, float)
    if mode == 0:
        join = c1[0] - c2[0]
        t1 = c1[1] - c1[0]
        t2 = c2[0] - c2[1]
    elif mode == 1:
        join = c1[0] - c2[-1]
        t1 = c1[1] - c1[0]
        t2 = c2[-1] - c2[-2]
    elif mode == 2:
        join = c2[0] - c1[-1]
        t1 = c1[-1] - c1[-2]
        t2 = c2[1] - c2[0]
    else:
        join = c2[-1] - c1[-1]
        t1 = c1[-1] - c1[-2]
        t2 = c2[-2] - c2[-1]
    e = np.linalg.norm(join)
    if e == 0:
        return w_e * 0.0
    with np.errstate(invalid="ignore"):
        a1 = np.arccos(np.clip(np.dot(join, t1) / (np.linalg.norm(t1) * e), -1, 1))
        a2 = np.arccos(np.clip(np.dot(join, t2) / (np.linalg.norm(t2) * e), -1, 1))
    return float(w_e * e + w_c * (abs(a1) + abs(a2)) / 2.0)


def _merge_chains(chains):
    """Order and orient chains by Hungarian tip matching
    (utils.py:351-425)."""
    from scipy.optimize import linear_sum_assignment

    n = len(chains)
    if n == 1:
        return list(chains)
    size = 2 * n + 2
    cost = np.zeros((size, size))
    for i in range(n):
        for j in range(n):
            if i == j:
                cost[2 * i : 2 * i + 2, 2 * j : 2 * j + 2] = 100000
            else:
                cost[2 * i, 2 * j] = _tip_cost(chains[i], chains[j], 0)
                cost[2 * i, 2 * j + 1] = _tip_cost(chains[i], chains[j], 1)
                cost[2 * i + 1, 2 * j] = _tip_cost(chains[i], chains[j], 2)
                cost[2 * i + 1, 2 * j + 1] = _tip_cost(chains[i], chains[j], 3)
    cost[:, -2:] = 1000
    cost[-2:, :] = 1000
    cost[-2:, -2:] = 100000

    row_idx, col_idx = linear_sum_assignment(cost)
    cur = col_idx[row_idx[-1]]
    ordered = []
    seen = set()
    while True:
        chain_idx = cur // 2
        if chain_idx >= n or chain_idx in seen:
            break
        seen.add(chain_idx)
        chain = list(chains[chain_idx])
        if cur % 2 == 1:
            chain.reverse()
        ordered.append(chain)
        nxt = col_idx[cur + 1] if cur % 2 == 0 else col_idx[cur - 1]
        if nxt >= size - 2:
            break
        cur = nxt
    return ordered


def _save_debug(debug_dir, name, img):
    if debug_dir is None or cv2 is None:
        return
    import os

    os.makedirs(debug_dir, exist_ok=True)
    cv2.imwrite(os.path.join(debug_dir, name), img)


def _chains_image(shape, chains):
    img = np.zeros((shape[0], shape[1], 3), np.uint8)
    rng = np.random.default_rng(0)
    for chain in chains:
        color = tuple(int(v) for v in rng.integers(55, 255, 3))
        for i in range(len(chain) - 1):
            cv2.line(img, tuple(chain[i]), tuple(chain[i + 1]), color, 1)
    return img


def extract_connected_skeleton(
    mask: np.ndarray,
    seg_length: float = 8,
    max_curvature: float = 25,
    debug_dir: str | None = None,
):
    """mask (H, W) or (H, W, 3) uint8 → ordered pixel chains of (x, y)
    coordinates (utils.py:160-453). ``debug_dir`` saves per-stage images
    (the visualize_initialization_process equivalent)."""
    if cv2 is None:
        raise RuntimeError("skeleton extraction requires OpenCV")
    if mask.ndim == 3:
        mask = mask.max(axis=-1)
    mask = _mode_filter(mask.astype(np.uint8))
    _save_debug(debug_dir, "01_smoothed_mask.png", mask)
    skel = zhang_suen_skeletonize(mask)
    _save_debug(debug_dir, "02_skeleton.png", skel)
    contours, _ = cv2.findContours(skel, cv2.RETR_TREE, cv2.CHAIN_APPROX_SIMPLE)[-2:]

    chains = []
    for contour in contours:
        chains.extend(_contour_to_chains(contour, seg_length, max_curvature))
    if not chains:
        raise ValueError("no chains extracted from skeleton")
    _save_debug(debug_dir, "03_all_chains.png", _chains_image(mask.shape, chains))

    pruned = _prune_overlaps(chains)
    if not pruned:
        raise ValueError("all chains pruned away")
    _save_debug(debug_dir, "04_pruned_chains.png", _chains_image(mask.shape, pruned))
    merged = _merge_chains(pruned)
    _save_debug(debug_dir, "05_merged_chain.png", _chains_image(mask.shape, merged))
    return merged
