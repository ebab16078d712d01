"""The copied renderer and occlusion boxes, and the traffic generator."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest

from portbench import render
from portbench.reference.pipeline import Camera
from portbench.traffic import Traffic

ROOT = Path(__file__).resolve().parents[1]
# A small camera with the D435's field of view, so that a test renders fast.
SMALL = Camera(fx=918.359130859375 / 8, fy=916.265869140625 / 8, cx=80.5, cy=44.5,
               width=160, height=90)


def small(name: str, **change) -> dict:
    """A traffic file of the benchmark at a size a test renders quickly."""
    spec = json.loads((ROOT / "traffic" / f"{name}.json").read_text())
    spec.update(change)
    return spec


def test_renderer_is_the_ports_renderer():
    from trackdlo_tpu_torch.config import CameraIntrinsics
    from trackdlo_tpu_torch.evaluation import occlusion
    from trackdlo_tpu_torch.io import sequence

    intr = CameraIntrinsics()
    cam = Camera(intr.fx, intr.fy, intr.cx, intr.cy, intr.width, intr.height)
    for kw in ({}, {"markers": 12, "depth_noise_mm": 2.0, "dropout_frac": 0.05, "seed": 7}):
        a = render.render_frame(render.SyntheticRope(), 0.4, cam, **kw)
        b = sequence.render_frame(sequence.SyntheticRope(), 0.4, intr, **kw)
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
    nodes = render.SyntheticRope().nodes(0.4, 40)
    for pct in (0, 25, 75):
        rect = render.gt_bbox_rect(nodes, pct, cam.proj_matrix(), 720, 1280)
        assert rect == occlusion.gt_bbox_rect(nodes, pct, intr.proj_matrix(), 720, 1280)
        if rect is not None:
            assert np.array_equal(render.rect_mask(720, 1280, rect),
                                  occlusion.rect_mask(720, 1280, rect))


@pytest.mark.parametrize("name", ["rope_band", "rope_band16", "tape_rope", "occlusion_sweep16"])
def test_same_seed_same_frames_other_seed_other_order(name):
    spec = small(name, film_frames=min(12, json.loads(
        (ROOT / "traffic" / f"{name}.json").read_text())["film_frames"]))
    if spec["streams"] > 1:
        spec.update(streams=4, positions=4, stream_offsets=[0, 2, 4, 6][:4],
                    stream_films=[s % spec.get("films", 1) for s in range(4)])
        if spec["occlusion"]["kind"] == "gt_bbox":
            spec["occlusion"]["pct"] = [0, 25, 50, 75]
    else:
        spec.update(positions=spec["film_frames"])
    a = Traffic(spec, SMALL, 45, seed=2 ** 31 + 12345)
    b = Traffic(spec, SMALL, 45, seed=2 ** 31 + 12345)
    c = Traffic(spec, SMALL, 45, seed=987654321987)
    differs = False
    for k in range(a.period):
        fa, fb, fc = a.frame_set(k), b.frame_set(k), c.frame_set(k)
        assert all(np.array_equal(x, y) for x, y in zip(fa, fb))
        differs |= not all(np.array_equal(x, y) for x, y in zip(fa, fc))
    assert differs
    # Every seed runs the same frame sets, in another order.
    key = lambda t: [t.frame_set(k)[0].tobytes() for k in range(t.period)]  # noqa: E731
    assert sorted(key(a)) == sorted(key(c))


@pytest.mark.parametrize("name", ["rope_band", "rope_band16", "occlusion_sweep16"])
def test_the_walk_never_jumps(name):
    spec = small(name)
    t = Traffic(dict(spec, render={}, film_frames=spec["film_frames"]), SMALL, 45, seed=3)
    for s in range(t.streams):
        shown = [t.shown(k, s) for k in range(3 * t.period)]
        steps = {abs(b[1] - a[1]) for a, b in zip(shown, shown[1:])}
        assert steps <= {0, 1}, (s, steps)
        assert len({f for f, _ in shown}) == 1


def test_band_occludes_a_third_of_the_film_in_one_run():
    spec = small("rope_band")
    wide = Camera(SMALL.fx, SMALL.fy, 640.5, 4.5, 1280, 8)  # the band's columns, few rows
    t = Traffic(spec, wide, 45, seed=5)
    occluded = [not t.mask(0, 0, f).all() for f in range(t.film_frames)]
    assert sum(occluded) * 3 == t.film_frames
    runs = sum(1 for a, b in zip([False] + occluded, occluded) if b and not a)
    assert runs == 1


def test_sweep_boxes_the_heads_share_from_frame_two():
    spec = small("occlusion_sweep16", film_frames=4, positions=4)
    cam = Camera(918.359130859375, 916.265869140625, 645.8908081054688, 354.02392578125, 1280, 720)
    t = Traffic(dict(spec, render={}), cam, 40, seed=1)
    lost = [[int((~t.mask(s, t.stream_films[s], f)).sum()) for f in range(4)] for s in range(16)]
    for s in range(16):
        assert lost[s][0] == lost[s][1] == 0
        if s < 4:
            assert lost[s] == [0, 0, 0, 0]
        else:
            assert lost[s][2] > 0
    assert lost[4][2] < lost[8][2] < lost[12][2]
