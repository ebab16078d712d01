"""The import rule, and the reference held bit for bit to the port's oracle.

Nothing under ``portbench/`` imports JAX or the JAX package (each imported
module's top-level name compared whole, since the port's name begins with
the JAX package's); nothing under ``portbench/reference/`` imports the
program either.
"""

from __future__ import annotations

import ast
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX_NAMES = {"jax", "jaxlib", "flax", "trackdlo_tpu"}


def imported_top_names(path: Path) -> set[str]:
    """Top-level names of every module a file imports, anywhere in it."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_top_names_are_compared_whole():
    assert "trackdlo_tpu_torch".split(".")[0] not in JAX_NAMES
    assert "trackdlo_tpu.ops".split(".")[0] in JAX_NAMES


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(ROOT.rglob("*.py"))
    assert len(files) > 20
    bad = {str(p.relative_to(ROOT)): sorted(imported_top_names(p) & JAX_NAMES) for p in files}
    assert {k: v for k, v in bad.items() if v} == {}


def test_reference_imports_nothing_of_the_program():
    files = sorted((ROOT / "reference").rglob("*.py"))
    assert files
    for p in files:
        names = imported_top_names(p)
        assert not names & (JAX_NAMES | {"trackdlo_tpu_torch", "torch"}), (p, names)
        assert names <= {"__future__", "dataclasses", "numpy", "portbench"}, (p, names)


def _camera(intr):
    from portbench.reference.pipeline import Camera

    return Camera(intr.fx, intr.fy, intr.cx, intr.cy, intr.width, intr.height)


@pytest.mark.parametrize("config", ["live", "eval"])
def test_reference_is_the_ports_oracle_bit_for_bit(config, monkeypatch):
    """Two rendered frames of each configuration, closed loop from the same
    starting nodes: the copy and the port's oracle (its NumPy HSV and
    rasterisation, as on a machine without OpenCV) give the same bits."""
    import json

    from trackdlo_tpu_torch import oracle  # noqa: F401
    from trackdlo_tpu_torch.config import CameraIntrinsics
    from trackdlo_tpu_torch.oracle import pipeline as port_pipeline
    from trackdlo_tpu_torch.oracle import preprocess as port_pre
    from trackdlo_tpu_torch.oracle import visibility as port_vis

    from portbench import render
    from portbench.reference import pipeline
    from portbench.run import program_params

    monkeypatch.setattr(port_pre, "cv2", None)
    monkeypatch.setattr(port_vis, "cv2", None)
    cfg = json.loads((ROOT / "configs" / f"{config}.json").read_text())
    params, intr = program_params(cfg)
    assert intr == CameraIntrinsics()
    ref_params, cam = pipeline.Params(cfg["tracker"]), _camera(intr)
    rope = render.SyntheticRope()
    nodes = rope.nodes(0.0, params.num_of_nodes).astype(np.float32)
    a = port_pipeline.init_state(nodes, params)
    b = pipeline.init_state(nodes, ref_params)
    markers = 12 if config == "eval" else 0
    for i in (1, 2):
        rgb, depth = render.render_frame(rope, i / 30.0, cam, markers=markers)
        keep = np.ones((intr.height, intr.width), bool)
        keep[:, 500:800] = i == 2
        a, ra, xa = port_pipeline.step_frame(a, rgb, depth, params, intr, keep)
        b, rb, xb = pipeline.step_frame(b, rgb, depth, ref_params, cam, keep)
        assert np.array_equal(xa["points"], xb["points"])
        assert xa["visible_nodes_extended"] == xb["visible_nodes_extended"]
        assert np.array_equal(ra.guide_nodes, rb.guide_nodes)
        assert np.array_equal(ra.correspondence_priors, rb.correspondence_priors)
        assert ra.occlusion_state == rb.occlusion_state
        assert np.array_equal(ra.y, rb.y) and ra.sigma2 == rb.sigma2


def test_tf32_product_rounds_to_ten_mantissa_bits():
    from portbench.reference.pipeline import tf32, tf32_matmul

    x = np.array([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10, 1.0 + 3 * 2.0 ** -12, -0.1])
    got = tf32(x)
    assert got[0] == 1.0 + 2.0 ** -10  # a tie rounds away from zero
    assert got[1] == 1.0 + 2.0 ** -10
    assert got[2] == 1.0 + 2.0 ** -10
    assert abs(got[3] + 0.1) <= 0.1 * 2.0 ** -11
    a = np.random.default_rng(0).standard_normal((5, 7))
    b = np.random.default_rng(1).standard_normal((7, 3))
    err = np.abs(tf32_matmul(a, b) - a @ b).max()
    assert 1e-6 < err < 1e-2
