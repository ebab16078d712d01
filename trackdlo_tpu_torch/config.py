"""Typed configuration for the TPU-native DLO tracker.

Mirrors the reference's rosparam flag system (reference:
launch/trackdlo.launch:26-60 and launch/trackdlo_eval.launch:26-60, parsed in
trackdlo/src/trackdlo_node.cpp:539-562). Two presets ship with the reference —
the "live" profile and the "eval" profile — reproduced here as
:func:`live_params` and :func:`eval_params`.

Unlike the reference (dynamic rosparam server), parameters here are a frozen
dataclass: hyperparameters are compile-time constants baked into the jitted
per-frame graph, which lets XLA constant-fold them into fused kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class TrackerParams:
    """All tracker hyperparameters.

    Names follow the reference launch files (launch/trackdlo.launch:27-59);
    docstrings quote the reference's own parameter comments.
    """

    # Number of nodes M in the tracked chain (launch/trackdlo.launch:12).
    num_of_nodes: int = 45

    # MCT kernel weights: "the larger they are, the more rigid the object
    # becomes" (launch/trackdlo.launch:27-29).
    beta: float = 0.35
    lam: float = 50000.0

    # "alpha: the alignment strength" of correspondence priors
    # (launch/trackdlo.launch:31-32).
    alpha: float = 3.0

    # "mu: ranges from 0 to 1, large mu indicates the point cloud is noisy"
    # (launch/trackdlo.launch:34-35).
    mu: float = 0.1

    # EM budget (launch/trackdlo.launch:37-40).
    max_iter: int = 50
    tol: float = 0.0002

    # "k_vis: the strength of visibility information's effect on membership
    # probability computation" (launch/trackdlo.launch:43-44).
    k_vis: float = 50.0

    # "d_vis: the max geodesic distance between two adjacent visible nodes for
    # the nodes between them to be considered visible"
    # (launch/trackdlo.launch:46-47).
    d_vis: float = 0.06

    # "visibility_threshold (tau_vis): the max distance a node can be away
    # from the current point cloud to be considered visible"
    # (launch/trackdlo.launch:49-50).
    visibility_threshold: float = 0.008

    # "dlo_pixel_width (w): the approximate dlo width when projected onto 2D"
    # (launch/trackdlo.launch:52-53).
    dlo_pixel_width: int = 40

    # GLTP pre-processing registration parameters
    # (launch/trackdlo.launch:55-58).
    beta_pre_proc: float = 3.0
    lambda_pre_proc: float = 1.0
    lle_weight: float = 10.0

    # Voxel-grid downsample leaf size in metres (launch/trackdlo.launch:59).
    downsample_leaf_size: float = 0.008

    # HSV segmentation bounds (launch/trackdlo.launch:8-10); the reference
    # passes these as space-delimited strings and hand-parses them
    # (trackdlo_node.cpp:565-594) — here they are typed tuples.
    hsv_lower: Tuple[int, int, int] = (90, 90, 30)
    hsv_upper: Tuple[int, int, int] = (130, 255, 255)

    # Multi-colour DLO segmentation (blue rope + red/yellow tape), see
    # color_thresholding (trackdlo_node.cpp:88-119).
    multi_color_dlo: bool = False

    # --- TPU-native additions (no reference equivalent) -------------------
    # Static capacity for the downsampled point cloud; the graph is traced
    # once for this shape and shorter clouds are padded with an invalid mask.
    max_points: int = 4096
    # Points farther than this from every node are pruned from the EM input
    # (trackdlo.cpp:177-195 hardcodes 0.1 m).
    prune_radius: float = 0.1
    # Hash-table size for the on-device voxel-grid downsample (power of two).
    voxel_table_size: int = 1 << 15
    # Image-cell size (pixels) for the on-device cell-pooling downsample;
    # None derives it from downsample_leaf_size and the camera intrinsics.
    downsample_cell_px: int | None = None
    # Two-stage downsample: pool fine image cells (~half a leaf) then snap
    # their centroids to 3-D voxel bins — near-exact PCL VoxelGrid semantics
    # on device at the cost of one small argsort. False = single-stage cell
    # pooling (fastest, slightly coarser parity).
    exact_voxels: bool = True
    # Split cell pooling into 8 voxel-parity channels so cells straddling
    # voxel boundaries emit separate candidates — recovers PCL VoxelGrid
    # semantics essentially exactly (candidate occupancy == oracle voxel
    # occupancy; see perf/cell_parity_sweep.py). ON by default since round 3:
    # with the 2-D-tiled preprocess kernel the exact-parity pipeline runs at
    # full tracking rate (recorded bench 2026-08-17: 0.711 ms/frame b1,
    # 0.599 ms/frame in the 8-stream batch), so the one default profile is
    # the accurate profile — matching the reference, whose only pipeline is
    # its accurate pipeline (trackdlo_node.cpp:236-241 PCL VoxelGrid).
    # parity_split=False remains a ~0.18 ms/frame-faster coarse option
    # (~2.4 mm closed-loop vs <=1 mm).
    parity_split: bool = True
    # Fixed candidate capacity of the compaction, or None to derive it from
    # the voxel leaf via candidate_cap(): occupancy scales ~(1/leaf)^2, so a
    # fixed number tuned on one profile silently truncates finer-leaf
    # profiles (the 5 mm eval leaf measures up to 749 occupied cells per
    # parity channel across the six scenarios vs the live 8 mm profile's
    # 190 — a live-tuned 256/channel cap would chop eval clouds). At the
    # live leaf the derived cap is 2048 (256 per channel): measured
    # worst-case occupancy 190/channel and 1438 total across the six
    # scenarios, and the snap sort at 2048 candidates is much cheaper than
    # at 4096; full-step A/B across {1024, 2048, 4096} picked 2048
    # (perf/parity_cap_ab.py).
    parity_candidate_cap: int | None = None
    # LLE chain neighbourhood size k (trackdlo.cpp:236 hardcodes 6).
    lle_k: int = 6
    # Initial sigma^2 after node initialization (trackdlo_node.cpp:133).
    sigma2_init: float = 0.001
    # Fused Pallas E-step: None = auto (enabled on any non-CPU backend — one
    # kernel per EM iteration beats the ~15-launch XLA path at every size on
    # v5e, perf/stage_scan_bench.py; CPU stays on the XLA path since Pallas
    # interpret mode is far slower there); True/False forces it.
    use_pallas_estep: bool | None = None
    # M-step solver: "lu" (fastest) or "lstsq" (the reference's
    # completeOrthogonalDecomposition semantics, trackdlo.cpp:415, realized
    # with Householder QR — backward stable on every backend, unlike the
    # TPU SVD lowering; see ops/cpd_lle._solve_qr and CpdParams.solver).
    solver: str = "lu"

    @property
    def M(self) -> int:
        return self.num_of_nodes

    def candidate_cap(self) -> int:
        """Compaction candidate capacity (see parity_candidate_cap).

        Derived from the voxel leaf unless pinned: occupancy scales
        ~(1/leaf)^2 with 2048 fitting the 8 mm live leaf, rounded up to a
        power of two so the per-channel slot count stays a power of two
        (8 mm → 2048, 5 mm → 8192)."""
        if self.parity_candidate_cap is not None:
            return self.parity_candidate_cap
        import math

        scale = max((0.008 / self.downsample_leaf_size) ** 2, 1.0)
        return 1 << math.ceil(math.log2(2048 * scale))


def params_from_dict(data: dict) -> TrackerParams:
    """Build params from a plain dict (the rosparam-server role of the
    reference's launch files, trackdlo_node.cpp:539-562).

    Accepts the reference's parameter names, including its space-delimited
    HSV bound strings ("90 90 30") and `lambda` (a Python keyword, mapped to
    `lam`). Unknown keys raise.
    """
    import dataclasses as _dc

    field_names = {f.name for f in _dc.fields(TrackerParams)}
    aliases = {"lambda": "lam", "lle_weight": "lle_weight"}
    out = {}
    for key, value in data.items():
        key = aliases.get(key, key)
        if key in ("hsv_threshold_lower_limit", "hsv_lower"):
            key = "hsv_lower"
            if isinstance(value, str):
                value = tuple(int(v) for v in value.split())
            else:
                value = tuple(value)
        elif key in ("hsv_threshold_upper_limit", "hsv_upper"):
            key = "hsv_upper"
            if isinstance(value, str):
                value = tuple(int(v) for v in value.split())
            else:
                value = tuple(value)
        if key not in field_names:
            raise KeyError(f"unknown tracker parameter {key!r}")
        out[key] = value
    return dataclasses.replace(TrackerParams(), **out)


def params_from_json(path: str) -> TrackerParams:
    import json

    with open(path) as f:
        return params_from_dict(json.load(f))


def live_params(**overrides) -> TrackerParams:
    """The reference's live profile (launch/trackdlo.launch:27-59)."""
    return dataclasses.replace(TrackerParams(), **overrides)


def eval_params(**overrides) -> TrackerParams:
    """The reference's evaluation profile (launch/trackdlo_eval.launch:27-59).

    Like the live profile this uses exact-PCL-VoxelGrid preprocessing
    (parity_split, the round-3 default): 0.3-0.7 mm closed-loop oracle
    parity (chaotic per-build band) vs ~2.4 mm with plain cell pooling
    (perf/parity_decomposition.py)."""
    base = TrackerParams(
        num_of_nodes=40,
        beta=0.5,
        k_vis=500.0,
        visibility_threshold=0.005,
        dlo_pixel_width=30,
        downsample_leaf_size=0.005,
        multi_color_dlo=True,
    )
    return dataclasses.replace(base, **overrides)


@dataclasses.dataclass(frozen=True)
class CameraIntrinsics:
    """Pinhole camera model (3x4 projection matrix, trackdlo_node.cpp:74-81).

    Default values are the RealSense D435 intrinsics hardcoded in the
    reference's NumPy prototype (utils/tracking_test.py:23-25).
    """

    fx: float = 918.359130859375
    fy: float = 916.265869140625
    cx: float = 645.8908081054688
    cy: float = 354.02392578125
    width: int = 1280
    height: int = 720

    def proj_matrix(self):
        import numpy as np

        return np.array(
            [
                [self.fx, 0.0, self.cx, 0.0],
                [0.0, self.fy, self.cy, 0.0],
                [0.0, 0.0, 1.0, 0.0],
            ]
        )
