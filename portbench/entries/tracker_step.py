"""One camera stream through ``Tracker.step`` (the port's single-stream API:
one CUDA graph a frame on the card)."""

from __future__ import annotations


def build(params, intr, cell: dict, streams: int, device):
    """(init(nodes) -> state, step(state, rgb, depth, occ) -> (state, outputs))."""
    from trackdlo_tpu_torch.models.trackdlo import Tracker

    if streams != 1:
        raise ValueError(f"tracker_step takes one stream, the traffic has {streams}")
    tracker = Tracker(params, intr, device=device)
    return (lambda nodes: tracker.init_from_nodes(nodes[0])), tracker.step
