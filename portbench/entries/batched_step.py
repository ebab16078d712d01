"""A frame set of many camera streams through ``build_batched_step_fn``
(one CUDA graph a frame set on the card), in cohorts of the cell's
``cohort`` streams (the whole batch where it gives none)."""

from __future__ import annotations


def build(params, intr, cell: dict, streams: int, device):
    """(init(nodes) -> state, step(state, rgb, depth, occ) -> (state, outputs))."""
    import torch

    from trackdlo_tpu_torch.models.trackdlo import TrackerState, init_state
    from trackdlo_tpu_torch.parallel import build_batched_step_fn

    step = build_batched_step_fn(params, intr, cohort_size=cell.get("cohort"), device=device)

    def init(nodes):
        states = [init_state(n, params, device) for n in nodes]
        return TrackerState(*(torch.stack(f) for f in zip(*states)))

    return init, step
