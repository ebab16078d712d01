"""Segmentation-mask preview (reference: utils/mask.py)."""

from __future__ import annotations

import numpy as np

from trackdlo_tpu_torch.oracle.preprocess import segment_dlo


def preview_mask(rgb: np.ndarray, params) -> np.ndarray:
    """The exact mask the tracker will see, as an RGB image (white = kept)."""
    mask = segment_dlo(rgb, params.hsv_lower, params.hsv_upper, params.multi_color_dlo)
    return np.repeat(mask[..., None], 3, axis=-1)


def mask_stats(rgb: np.ndarray, params) -> dict:
    mask = segment_dlo(rgb, params.hsv_lower, params.hsv_upper, params.multi_color_dlo)
    on = int((mask > 0).sum())
    return {
        "pixels_on": on,
        "fraction": on / mask.size,
    }
