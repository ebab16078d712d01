"""Per-frame outer tracking logic: occlusion-case dispatch + two EM passes.

Reference: trackdlo::tracking_step (trackdlo.cpp:900-999).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from portbench.reference.cpd_lle import cpd_lle
from portbench.reference.geometry import pt2pt_dis
from portbench.reference.traverse import traverse_euclidean

# Occlusion states (logged by the reference at trackdlo.cpp:931-981).
ALL_VISIBLE = 0
MID_SECTION_OCCLUDED = 1
TAIL_OCCLUDED = 2
HEAD_OCCLUDED = 3
BOTH_ENDS_OCCLUDED = 4
# Zero visible nodes: the reference crashes (empty-vector index at
# trackdlo.cpp:933); defined here as a distinct no-priors state matching
# ops/priors.NO_VISIBLE_NODES.
NO_VISIBLE_NODES = 5


@dataclasses.dataclass
class TrackingStepResult:
    y: np.ndarray
    sigma2: float
    guide_nodes: np.ndarray
    correspondence_priors: np.ndarray
    occlusion_state: int
    converged: bool


def classify_occlusion(visible_nodes_extended: list[int], m: int) -> int:
    """Which of the five occlusion cases applies (trackdlo.cpp:929-981)."""
    v = visible_nodes_extended
    if len(v) == 0:
        return NO_VISIBLE_NODES
    if len(v) == m:
        return ALL_VISIBLE
    if v[0] == 0 and v[-1] == m - 1:
        return MID_SECTION_OCCLUDED
    if v[0] == 0:
        return TAIL_OCCLUDED
    if v[-1] == m - 1:
        return HEAD_OCCLUDED
    return BOTH_ENDS_OCCLUDED


def _merge_all_visible(
    priors_head: np.ndarray, priors_tail_rev: np.ndarray, m: int
) -> np.ndarray:
    """Average the head and tail walks (trackdlo.cpp:938-956).

    ``priors_tail_rev`` must already be reversed to ascending node order
    (trackdlo.cpp:942).
    """
    out = []
    len1 = len(priors_head)
    len2 = len(priors_tail_rev)
    tail_first_idx = priors_tail_rev[0][0]
    head_last_idx = priors_head[-1][0]
    for i in range(m):
        if i < tail_first_idx and i < len1:
            out.append(priors_head[i])
        elif i > head_last_idx and 0 <= i - (m - len2) < len2:
            out.append(priors_tail_rev[i - (m - len2)])
        else:
            out.append((priors_head[i] + priors_tail_rev[i - (m - len2)]) / 2.0)
    return np.array(out)


def tracking_step(
    x: np.ndarray,
    y: np.ndarray,
    sigma2: float,
    geodesic_coord: np.ndarray,
    visible_nodes: list[int],
    visible_nodes_extended: list[int],
    params,
    mm=np.matmul,
) -> TrackingStepResult:
    """One tracker update (trackdlo.cpp:900-999).

    ``params`` holds the configuration's tracker fields (attributes as
    :class:`portbench.reference.pipeline.Params`); ``mm`` is the EM's matrix
    product (float64 ``np.matmul`` unless a control lowers it).
    """
    m = len(y)

    if len(visible_nodes_extended) == 0:
        # No visible nodes at all: no guides, no priors; run the main EM
        # unconstrained (defined behavior where the reference crashes).
        main = cpd_lle(
            x, y, sigma2,
            params.beta, params.lam, params.lle_weight, params.mu,
            params.max_iter, params.tol,
            include_lle=False,
            prune_radius=params.prune_radius,
            mm=mm,
        )
        return TrackingStepResult(
            y=main.y,
            sigma2=main.sigma2,
            guide_nodes=np.zeros((0, 3)),
            correspondence_priors=np.zeros((0, 4)),
            occlusion_state=NO_VISIBLE_NODES,
            converged=main.converged,
        )

    # Guide nodes = previous node positions at the extended-visible indices
    # (trackdlo.cpp:913-921).
    if len(visible_nodes_extended) != m:
        guide_nodes = y[np.array(visible_nodes_extended)].copy()
    else:
        guide_nodes = y.copy()

    # Pre-processing GLTP registration of the visible subset
    # (trackdlo.cpp:925-927); sigma2 is copied, not persisted.
    pre = cpd_lle(
        x,
        guide_nodes,
        sigma2,
        params.beta_pre_proc,
        params.lambda_pre_proc,
        params.lle_weight,
        params.mu,
        params.max_iter,
        params.tol,
        include_lle=True,
        prune_radius=params.prune_radius,
        mm=mm,
    )
    guide_nodes = pre.y

    state = classify_occlusion(visible_nodes_extended, m)

    if state == ALL_VISIBLE:
        pv1 = traverse_euclidean(geodesic_coord, guide_nodes, visible_nodes_extended, 0)
        pv2 = traverse_euclidean(geodesic_coord, guide_nodes, visible_nodes_extended, 1)
        pv2 = pv2[::-1]
        priors = _merge_all_visible(pv1, pv2, m)
    elif state == MID_SECTION_OCCLUDED:
        pv1 = traverse_euclidean(geodesic_coord, guide_nodes, visible_nodes_extended, 0)
        pv2 = traverse_euclidean(geodesic_coord, guide_nodes, visible_nodes_extended, 1)
        priors = np.concatenate([pv1, pv2], axis=0)
    elif state == TAIL_OCCLUDED:
        priors = traverse_euclidean(geodesic_coord, guide_nodes, visible_nodes_extended, 0)
    elif state == HEAD_OCCLUDED:
        priors = traverse_euclidean(geodesic_coord, guide_nodes, visible_nodes_extended, 1)
    else:
        # Both ends occluded: anchor at the least-moved visible node
        # (trackdlo.cpp:980-994). NOTE the reference compares Y at
        # visible_nodes[i] against guide node i, where guide nodes were built
        # from visible_nodes_extended — kept as-is for parity.
        moved = [
            pt2pt_dis(y[visible_nodes[i]], guide_nodes[i])
            for i in range(len(visible_nodes))
        ]
        alignment_idx = int(np.argmin(moved))
        priors = traverse_euclidean(
            geodesic_coord, guide_nodes, visible_nodes_extended, 2, alignment_idx
        )

    main = cpd_lle(
        x,
        y,
        sigma2,
        params.beta,
        params.lam,
        params.lle_weight,
        params.mu,
        params.max_iter,
        params.tol,
        include_lle=False,
        correspondence_priors=priors,
        alpha=params.alpha,
        visible_nodes=visible_nodes_extended,
        k_vis=params.k_vis,
        visibility_threshold=params.visibility_threshold,
        prune_radius=params.prune_radius,
        mm=mm,
    )

    return TrackingStepResult(
        y=main.y,
        sigma2=main.sigma2,
        guide_nodes=guide_nodes,
        correspondence_priors=priors,
        occlusion_state=state,
        converged=main.converged,
    )
