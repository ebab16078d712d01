"""Occlusion simulation: programmatic rectangle animation + interactive GUI.

Reference: utils/simulate_occlusion.py (draggable rectangle GUI publishing
/mask_with_occlusion) and utils/simulate_occlusion_eval.py (corners → mask).
The programmatic simulator is the fault-injection surface for tests and
evaluation sweeps (SURVEY.md §5 fault injection).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from trackdlo_tpu_torch.evaluation.occlusion import rect_mask


@dataclasses.dataclass
class OcclusionSimulator:
    """A rectangle that can sit still or sweep across the image over time."""

    height: int
    width: int
    rect: tuple = (500, 0, 800, 719)
    velocity: tuple = (0.0, 0.0)  # pixels/frame (dx, dy)

    def mask_at(self, frame_idx: int) -> np.ndarray:
        dx = self.velocity[0] * frame_idx
        dy = self.velocity[1] * frame_idx
        x1, y1, x2, y2 = self.rect
        return rect_mask(self.height, self.width, (x1 + dx, y1 + dy, x2 + dx, y2 + dy))


def run_gui(frame_provider):  # pragma: no cover - needs a display
    """Interactive draggable-rectangle GUI (utils/simulate_occlusion.py):
    draw with the mouse; returns masks via the provided callback."""
    import cv2

    state = {"p1": None, "p2": None, "drag": False}

    def on_mouse(event, x, y, flags, _):
        if event == cv2.EVENT_LBUTTONDOWN:
            state.update(p1=(x, y), p2=(x, y), drag=True)
        elif event == cv2.EVENT_MOUSEMOVE and state["drag"]:
            state["p2"] = (x, y)
        elif event == cv2.EVENT_LBUTTONUP:
            state.update(p2=(x, y), drag=False)

    win = "simulate_occlusion"
    cv2.namedWindow(win)
    cv2.setMouseCallback(win, on_mouse)
    for rgb in frame_provider:
        disp = rgb.copy()
        mask = np.ones(rgb.shape[:2], bool)
        if state["p1"] and state["p2"]:
            x1, y1 = state["p1"]
            x2, y2 = state["p2"]
            mask = rect_mask(*rgb.shape[:2], (min(x1, x2), min(y1, y2), max(x1, x2), max(y1, y2)))
            disp[~mask] //= 4
        cv2.imshow(win, disp[..., ::-1])
        if cv2.waitKey(30) == 27:
            break
        yield mask
    cv2.destroyAllWindows()
