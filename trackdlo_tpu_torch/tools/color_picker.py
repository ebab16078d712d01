"""HSV threshold tuning.

Reference: utils/color_picker.py (trackbar GUI, docs/COLOR_THRESHOLD.md).
The programmatic path suggests bounds from a labelled region; the GUI path
reproduces the trackbar tool when a display is available.
"""

from __future__ import annotations

import numpy as np

from trackdlo_tpu_torch.oracle.preprocess import hsv_from_rgb, in_range


def suggest_hsv_bounds(
    rgb: np.ndarray, region_mask: np.ndarray, percentile: float = 2.0
) -> tuple[tuple[int, int, int], tuple[int, int, int]]:
    """Suggest (lower, upper) HSV bounds covering the pixels selected by
    ``region_mask`` (e.g. a user-drawn rectangle over the DLO)."""
    hsv = hsv_from_rgb(rgb)
    sel = hsv[region_mask > 0].astype(float)
    lo = np.percentile(sel, percentile, axis=0)
    hi = np.percentile(sel, 100 - percentile, axis=0)
    lower = tuple(int(max(0, np.floor(v))) for v in lo)
    upper = tuple(int(min(m, np.ceil(v))) for v, m in zip(hi, (180, 255, 255)))
    return lower, upper


def coverage(rgb: np.ndarray, lower, upper, region_mask: np.ndarray) -> float:
    """Fraction of the labelled region covered by the given bounds."""
    mask = in_range(hsv_from_rgb(rgb), lower, upper)
    region = region_mask > 0
    return float((mask[region] > 0).mean()) if region.any() else 0.0


def run_gui(rgb: np.ndarray):  # pragma: no cover - needs a display
    """Interactive trackbar tuner (utils/color_picker.py:1-76)."""
    import cv2

    win = "color_picker"
    cv2.namedWindow(win)
    names = ["H low", "S low", "V low", "H high", "S high", "V high"]
    init = [90, 90, 30, 130, 255, 255]
    maxs = [180, 255, 255, 180, 255, 255]
    for n, v, mx in zip(names, init, maxs):
        cv2.createTrackbar(n, win, v, mx, lambda _: None)
    hsv = hsv_from_rgb(rgb)
    while True:
        vals = [cv2.getTrackbarPos(n, win) for n in names]
        mask = in_range(hsv, vals[:3], vals[3:])
        disp = rgb.copy()
        disp[mask == 0] //= 4
        cv2.imshow(win, disp[..., ::-1])
        if cv2.waitKey(30) == 27:
            break
    cv2.destroyAllWindows()
    return tuple(vals[:3]), tuple(vals[3:])
