"""Batched occlusion sweeps: many (trial × pct_occlusion) runs at once.

Counterpart of trackdlo_tpu/evaluation/sweep.py: a whole sweep over
occlusion percentages runs as one batched multi-stream tracker on the
device (:func:`trackdlo_tpu_torch.parallel.build_batched_step_fn`), each
stream seeing the same frames with its own occlusion mask, and the errors
come from the batched metric.
"""

from __future__ import annotations

import numpy as np

from trackdlo_tpu_torch.evaluation.evaluator import piecewise_error_batch
from trackdlo_tpu_torch.evaluation.occlusion import gt_bbox_rect, rect_mask
from trackdlo_tpu_torch.models.trackdlo import init_state
from trackdlo_tpu_torch.parallel.sharding import build_batched_step_fn, replicate_state


def occlusion_sweep(
    params,
    intrinsics,
    frames,
    gt_nodes,
    init_nodes,
    pct_values=(0, 25, 50, 75),
    occlude_from_frame: int = 2,
    device=None,
):
    """Track the same sequence under each occlusion percentage in parallel,
    on ``device`` (the CUDA card unless the caller names the CPU).

    Returns (pct_values, errors (P, F)) — per-trial, per-frame (E1+E2)/2.
    """
    batch = len(pct_values)
    step = build_batched_step_fn(params, intrinsics, device=device)
    state = replicate_state(
        init_state(np.asarray(init_nodes, np.float32), params, device), batch)
    dev = state.y.device

    proj = intrinsics.proj_matrix()
    h, w = intrinsics.height, intrinsics.width

    errors = np.zeros((batch, len(frames)))
    for f_idx, (rgb, depth) in enumerate(frames):
        masks = []
        for pct in pct_values:
            if f_idx >= occlude_from_frame and pct > 0:
                rect = gt_bbox_rect(np.asarray(gt_nodes[f_idx]), pct, proj, h, w)
                masks.append(
                    rect_mask(h, w, rect) if rect is not None else np.ones((h, w), bool)
                )
            else:
                masks.append(np.ones((h, w), bool))
        rgb_b = np.broadcast_to(rgb, (batch,) + rgb.shape)
        depth_b = np.broadcast_to(depth, (batch,) + depth.shape)
        state, _ = step(state, rgb_b, depth_b, np.stack(masks))
        gt_b = np.broadcast_to(gt_nodes[f_idx], (batch,) + np.asarray(gt_nodes[f_idx]).shape)
        errors[:, f_idx] = piecewise_error_batch(state.y, gt_b, device=dev)

    return np.asarray(pct_values), errors
