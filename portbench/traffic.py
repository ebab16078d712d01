"""The one traffic generator: camera streams of a rendered rope.

A traffic file (``traffic/<name>.json``) holds only parameters:

- ``streams``: camera streams a call hands the step (1: a frame; more: a
  frame set, one frame a stream);
- ``fps``: the cameras' rate; consecutive frames of a film lie 1/fps of
  rope time apart;
- ``rope``: fields of :class:`portbench.render.SyntheticRope` that differ
  from its defaults;
- ``films``, ``film_frames``, ``film_phase_s``: distinct rendered
  sequences, frames in each, and the rope time between the starts of two
  films; frame ``i`` of film ``f`` renders with the noise seed
  ``100003 f + i``, so every run renders the same films;
- ``render``: :func:`portbench.render.render_frame`'s knobs (``markers``,
  ``depth_noise_mm``, ``dropout_frac``);
- ``stream_films``: the film of each stream (default ``s % films``);
  ``stream_offsets``: each stream's first frame in its film;
- ``positions``: the calls walk ``positions`` steps forward, then back
  (so the rope never jumps), stream ``s`` showing frame
  ``(offset_s + j) % film_frames`` at step ``j``;
- ``occlusion``: ``{"kind": "none"}``; ``{"kind": "band", "columns": [a,
  b], "frames": [f0, f1], "streams": "all" | "odd"}`` (image columns a:b
  masked on film frames f0..f1-1, in every stream or the odd ones); or
  ``{"kind": "gt_bbox", "pct": [...], "from_frame": f, "extra_border": px}``
  (stream ``s`` loses the box around the first ``pct[s]`` percent of the
  true nodes, from film frame ``f`` on, as the upstream's occlusion
  evaluation does).

The seed picks only where in its period the walk starts, and so which
way it goes first: every seed runs the same frames and frame sets, in another order. Every
frame or frame set a call hands over is built before the window, as one
contiguous array of each kind, so the window spends no time on traffic.
"""

from __future__ import annotations

import numpy as np

from portbench import render


class Traffic:
    """The frames of one run. ``frame_set(k)`` is call ``k``'s (rgb, depth,
    occlusion mask): (H, W, 3) u8, (H, W) u16 and (H, W) bool for one
    stream, each with a leading stream axis for more. ``shown(k, s)`` is the
    (film, frame) stream ``s`` sees at call ``k``."""

    def __init__(self, spec: dict, camera, num_nodes: int, seed: int):
        self.spec = spec
        self.camera = camera
        self.m = num_nodes
        self.streams = int(spec["streams"])
        self.fps = float(spec["fps"])
        self.rope = render.SyntheticRope(**spec.get("rope", {}))
        self.films = int(spec.get("films", 1))
        self.film_frames = int(spec["film_frames"])
        self.film_phase = float(spec.get("film_phase_s", 0.0))
        self.positions = int(spec["positions"])
        self.stream_films = list(spec.get("stream_films",
                                          [s % self.films for s in range(self.streams)]))
        self.offsets = [int(o) for o in spec.get("stream_offsets", [0] * self.streams)]
        if len(self.stream_films) != self.streams or len(self.offsets) != self.streams:
            raise ValueError("stream_films and stream_offsets need one entry a stream")
        rng = np.random.default_rng(seed)
        self.start = int(rng.integers(self.period))
        self._render_films()
        self._build_sets()

    # -- the walk -----------------------------------------------------------
    @property
    def period(self) -> int:
        """Calls before the walk repeats."""
        return max(2 * self.positions - 2, 1)

    def position(self, k: int) -> int:
        """The walk's step at call ``k``."""
        i = (self.start + k) % self.period
        return i if i < self.positions else self.period - i

    def shown(self, k: int, s: int) -> tuple[int, int]:
        return self.stream_films[s], (self.offsets[s] + self.position(k)) % self.film_frames

    def time_of(self, film: int, frame: int) -> float:
        return film * self.film_phase + frame / self.fps

    def init_nodes(self, s: int, k: int = 0) -> np.ndarray:
        """Stream ``s``'s starting nodes before call ``k``: the rope's true
        nodes one frame before the frame it then sees."""
        film, frame = self.shown(k, s)
        return self.rope.nodes(self.time_of(film, frame) - 1.0 / self.fps, self.m)

    def true_nodes(self, film: int, frame: int) -> np.ndarray:
        return self.rope.nodes(self.time_of(film, frame), self.m)

    # -- frames -------------------------------------------------------------
    def _render_films(self) -> None:
        cam, kw = self.camera, dict(self.spec.get("render", {}))
        h, w = cam.height, cam.width
        used = sorted({(self.stream_films[s], (self.offsets[s] + j) % self.film_frames)
                       for s in range(self.streams) for j in range(self.positions)})
        self.rgb = np.zeros((self.films, self.film_frames, h, w, 3), np.uint8)
        self.depth = np.zeros((self.films, self.film_frames, h, w), np.uint16)
        for film, frame in used:
            self.rgb[film, frame], self.depth[film, frame] = render.render_frame(
                self.rope, self.time_of(film, frame), cam, seed=100003 * film + frame, **kw)
        self.rendered = len(used)

    def mask(self, s: int, film: int, frame: int) -> np.ndarray:
        """Stream ``s``'s occlusion mask on (film, frame): True keeps a pixel."""
        cam, occ = self.camera, self.spec.get("occlusion", {"kind": "none"})
        h, w = cam.height, cam.width
        keep = np.ones((h, w), bool)
        kind = occ["kind"]
        if kind == "none":
            return keep
        if kind == "band":
            f0, f1 = occ["frames"]
            if (occ.get("streams", "all") == "all" or s % 2 == 1) and f0 <= frame < f1:
                a, b = occ["columns"]
                keep[:, a:b] = False
            return keep
        if kind == "gt_bbox":
            pct = occ["pct"][s]
            if frame >= occ["from_frame"] and pct > 0:
                rect = render.gt_bbox_rect(self.true_nodes(film, frame), pct, cam.proj_matrix(),
                                           h, w, occ.get("extra_border", 30))
                if rect is not None:
                    keep = render.rect_mask(h, w, rect)
            return keep
        raise ValueError(f"unknown occlusion kind {kind!r}")

    def _build_sets(self) -> None:
        """One contiguous (rgb, depth, mask) per step of the walk."""
        self.sets = []
        for j in range(self.positions):
            shown = [(self.stream_films[s], (self.offsets[s] + j) % self.film_frames)
                     for s in range(self.streams)]
            masks = [self.mask(s, f, i) for s, (f, i) in enumerate(shown)]
            if self.streams == 1:
                (f, i), = shown
                self.sets.append((self.rgb[f, i], self.depth[f, i], masks[0]))
            else:
                self.sets.append((np.stack([self.rgb[f, i] for f, i in shown]),
                                  np.stack([self.depth[f, i] for f, i in shown]),
                                  np.stack(masks)))

    def frame_set(self, k: int):
        return self.sets[self.position(k)]

    def stream_frame(self, k: int, s: int):
        """Stream ``s``'s (rgb, depth, mask) at call ``k``."""
        rgb, depth, keep = self.frame_set(k)
        if self.streams == 1:
            return rgb, depth, keep
        return rgb[s], depth[s], keep[s]
