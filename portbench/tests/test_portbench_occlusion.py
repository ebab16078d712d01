"""The cell ``eval_occlusion.tip50``: its torch reference, its traffic, and
its per-layer readers where the program has no kernel X."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import roofline_exact, spec
from portbench.layers import Context
from portbench.reference import preprocess as frozen
from portbench.reference.pipeline import Camera, Params
from portbench.trace import Trace
from portbench.traffic import Traffic
from trackdlo_tpu_torch.oracle import voxel_grid_torch

ROOT = Path(__file__).resolve().parents[1]
CELL = "eval_occlusion.tip50"
NEW_METRICS = ("preprocess.cloud_points", "preprocess.exact.kernel_ms",
               "kernel.split_cells.roofline_pct")


def _cell_traffic(frames: int) -> tuple[Traffic, dict]:
    cell = spec.cell(CELL)
    cfg = cell["config_file"]
    t = dict(cell["traffic_file"], film_frames=frames, positions=frames)
    return Traffic(t, Camera(**cfg["camera"]), cfg["tracker"]["num_of_nodes"], seed=3), cfg


def test_torch_reference_is_the_frozen_preprocessing_on_the_first_frames():
    """The port's torch VoxelGrid (``trackdlo_tpu_torch/oracle``) and the
    benchmark's frozen NumPy one agree on the cell's
    first 8 frames (720p, 2 mm noise, 5% dropout, the box from frame 2):
    the same voxels in the same order, the same centroids."""
    traffic, cfg = _cell_traffic(8)
    params, cam = Params(cfg["tracker"]), Camera(**cfg["camera"])
    for i in range(8):
        rgb, depth = traffic.rgb[0, i], traffic.depth[0, i]
        keep = traffic.mask(0, 0, i)
        want = frozen.preprocess_frame(rgb, depth, params, cam, keep)
        got = voxel_grid_torch.preprocess_frame(
            torch.from_numpy(rgb), torch.from_numpy(depth.view(np.int16)),
            torch.from_numpy(keep), cam.fx, cam.fy, cam.cx, cam.cy, params.hsv_lower,
            params.hsv_upper, params.multi_color_dlo, params.downsample_leaf_size).numpy()
        assert got.shape == want.shape and len(want) > 500
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
        assert (depth[keep & (rgb != 120).any(-1)] == 0).any()  # dropout on the rope
        assert np.any(np.all(want == 0.0, axis=1))  # kept at the origin


def test_traffic_boxes_the_head_half_from_frame_two():
    """No box on frames 0 and 1; from frame 2 the box covers the projections
    of the first half of the true nodes and none of the last quarter."""
    traffic, cfg = _cell_traffic(6)
    cam = Camera(**cfg["camera"])
    m = cfg["tracker"]["num_of_nodes"]
    for f in range(6):
        keep = traffic.mask(0, 0, f)
        if f < 2:
            assert keep.all()
            continue
        nodes = traffic.true_nodes(0, f)
        uv = (cam.proj_matrix() @ np.c_[nodes, np.ones(m)].T).T
        px = np.round(uv[:, :2] / uv[:, 2:]).astype(int)
        hidden = ~keep[px[:, 1], px[:, 0]]
        assert hidden[: m // 2].all() and not hidden[3 * m // 4:].any()


def test_render_knobs_are_the_issue_traffic():
    t = json.loads((ROOT / "traffic" / "occlusion_tip50.json").read_text())
    assert t["streams"] == 1 and t["films"] == 1 and t["film_frames"] == t["positions"] == 120
    assert t["render"] == {"markers": 12, "depth_noise_mm": 2.0, "dropout_frac": 0.05}
    assert t["occlusion"] == {"kind": "gt_bbox", "pct": [50], "from_frame": 2, "extra_border": 30}


def _context(trace: Trace, frames=None) -> Context:
    return Context(trace=trace, calls=2, streams=1, window_s=0.01, plain_s=0.005, cohort=1,
                   frames=frames or [], height=720, width=1280, cell_px=7, mode="parity")


def _kernel(name, s, e):
    return (f"void (anonymous namespace)::{name}(XArgs)", float(s), float(e))


@pytest.mark.parametrize("name", NEW_METRICS)
def test_new_metric_is_none_without_kernel_x(name):
    """The parent's program has no kernel X: no events, no counters. Each
    new reader gives None there, never 0."""
    p_and_c = [_kernel("cell_sums_kernel", 0, 10), _kernel("compact_kernel", 10, 12),
               _kernel("cell_sums_kernel", 20, 30), _kernel("compact_kernel", 30, 32)]
    parent = Trace(p_and_c, [], {"cell_sums": 2, "compact": 2})
    got = spec.reader(name)(_context(parent))
    assert got is None


def test_new_metrics_read_kernel_x_where_it_ran():
    dev = [_kernel("cell_sums_kernel", 0, 10), _kernel("compact_kernel", 10, 12),
           _kernel("split_cells_kernel", 12, 20), _kernel("cell_sums_kernel", 30, 40),
           _kernel("compact_kernel", 40, 42), _kernel("split_cells_kernel", 42, 50)]
    work = {"split_cells.frames": 2, "split_cells.cells": 900, "split_cells.pixels": 44100,
            "split_cells.entries": 1000, "split_cells.groups": 2100,
            "split_cells.slots": 2 * 8 * 1024}
    counts = {"cell_sums": 2, "compact": 2, "split_cells": 2, **work}
    ctx = _context(Trace(dev, [], counts), frames=[dict(n_points=1700), dict(n_points=1800)])
    assert spec.reader("preprocess.cloud_points")(ctx) == 1750
    assert spec.reader("preprocess.exact.kernel_ms")(ctx) == pytest.approx(40e-3 / 2)
    blocks = roofline_exact.p_blocks(720, 1280, 7)
    assert blocks == 6 * 103  # strips of 32 cells: ceil(183 / 32) a row of 103
    least = roofline_exact.split_cells_bound(2, blocks, 900, 44100, 2 * 8 * 1024, 2100)[0]
    share = spec.reader("kernel.split_cells.roofline_pct")(ctx)
    assert share == pytest.approx(100 * least / 16e-3) and 0 < share < 100
    lost = Trace(dev, [], dict(counts, split_cells=3))  # a launch the trace did not see
    assert spec.reader("preprocess.exact.kernel_ms")(_context(lost)) is None
    assert spec.reader("kernel.split_cells.roofline_pct")(_context(lost)) is None
