"""Live tracking viewer — the rviz/tracking.rviz equivalent, on the port.

Counterpart of trackdlo_tpu/tools/live_view.py: the same surfaces from the
port's ``Tracker`` (its step one CUDA graph on the card), the outputs
brought to the host to draw. OpenCV is optional, as in the JAX tool: only
``LiveView`` needs it.

The reference ships an RViz config whose displays are the tracking markers,
the filtered cloud, and the annotated image (rviz/tracking.rviz). This tool
reproduces that live view without ROS: it runs the tracker over a frame
source and shows/records the same three surfaces — overlay image, node/edge
markers (projected), and the downsampled cloud.

Usage (programmatic):

    from trackdlo_tpu_torch.tools.live_view import LiveView
    view = LiveView(tracker, out_path="run.mp4")   # or window=True with a GUI
    for rgb, depth in frames:
        state, out = tracker.step(state, rgb, depth)
        view.show(rgb, state, out)
    view.close()

CLI (synthetic demo):  python -m trackdlo_tpu_torch.tools.live_view out.mp4 [n_frames] [device]
"""

from __future__ import annotations

import numpy as np
import torch

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


def _np(a) -> np.ndarray:
    """A tensor (on any device) or array as a numpy array."""
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


class LiveView:
    """Render the reference's RViz surfaces per frame: tracking overlay +
    projected cloud dots; optionally an interactive window and/or a video
    file."""

    def __init__(self, tracker, window: bool = False, out_path: str | None = None,
                 fps: float = 15.0, draw_cloud: bool = True):
        if cv2 is None:
            raise RuntimeError("live view requires OpenCV")
        self.tracker = tracker
        self.window = window
        self.out_path = out_path
        self.fps = fps
        self.draw_cloud = draw_cloud
        self._writer = None
        self.frames_shown = 0

    def show(self, rgb, state, outputs, occlusion_mask=None) -> np.ndarray:
        from trackdlo_tpu_torch.utils.viz import draw_tracking_overlay

        proj = self.tracker.intrinsics.proj_matrix()
        img = draw_tracking_overlay(
            _np(rgb),
            _np(state.y),
            proj,
            visible=_np(outputs.not_self_occluded),
            occlusion_mask=None if occlusion_mask is None else _np(occlusion_mask),
        )
        if self.draw_cloud:
            pts = _np(outputs.points)[_np(outputs.points_mask)]
            if len(pts):
                h = np.hstack([pts, np.ones((len(pts), 1))])
                uvw = (np.asarray(proj) @ h.T).T
                us = (uvw[:, 0] / uvw[:, 2]).astype(int)
                vs = (uvw[:, 1] / uvw[:, 2]).astype(int)
                ok = (us >= 0) & (us < img.shape[1]) & (vs >= 0) & (vs < img.shape[0])
                img[vs[ok], us[ok]] = (255, 255, 0)

        if self.out_path is not None:
            if self._writer is None:
                fourcc = cv2.VideoWriter_fourcc(*"mp4v")
                self._writer = cv2.VideoWriter(
                    self.out_path, fourcc, self.fps,
                    (img.shape[1], img.shape[0]),
                )
            self._writer.write(img[..., ::-1])
        if self.window:  # pragma: no cover - needs a display
            cv2.imshow("trackdlo_tpu", img[..., ::-1])
            cv2.waitKey(1)
        self.frames_shown += 1
        return img

    def close(self):
        if self._writer is not None:
            self._writer.release()
            self._writer = None
        if self.window:  # pragma: no cover
            cv2.destroyAllWindows()


def main(out_path: str = "live_view.mp4", n_frames: int = 30, device=None):  # pragma: no cover
    from trackdlo_tpu_torch.config import CameraIntrinsics, live_params
    from trackdlo_tpu_torch.io.sequence import SyntheticRope, render_frame
    from trackdlo_tpu_torch.models.trackdlo import Tracker

    params = live_params()
    intr = CameraIntrinsics()
    rope = SyntheticRope()
    tracker = Tracker(params, intr, device=device)
    state = tracker.init_from_nodes(rope.nodes(0.0, params.M))
    view = LiveView(tracker, out_path=out_path)
    for i in range(1, n_frames + 1):
        rgb, depth = render_frame(rope, i / 15.0, intr)
        state, out = tracker.step(state, rgb, depth)
        view.show(rgb, state, out)
    view.close()
    print(f"wrote {out_path} ({view.frames_shown} frames)")


if __name__ == "__main__":  # pragma: no cover
    import sys

    main(sys.argv[1] if len(sys.argv) > 1 else "live_view.mp4",
         int(sys.argv[2]) if len(sys.argv) > 2 else 30,
         sys.argv[3] if len(sys.argv) > 3 else None)
