"""The CPD/MCT EM solver — oracle port of trackdlo::cpd_lle.

Reference: trackdlo.cpp:161-441. This is the hot loop of the whole system:
E-step with geodesic re-distancing and a visibility-aware membership prior,
M-step solving a dense (G + regularizers) system for kernel weights W, and a
σ² trace update, iterated to tolerance.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from portbench.reference.geometry import pt2pt_dis
from portbench.reference.lle import calc_lle_weights


@dataclasses.dataclass
class CpdLleResult:
    y: np.ndarray
    sigma2: float
    converged: bool
    iterations: int


def mct_kernel(node_dis: np.ndarray, beta: float) -> np.ndarray:
    """2nd-order motion-coherence kernel over geodesic distances.

    G = 1/(4β²)·exp(−√2·d/β)·(2d + √2·β)   (trackdlo.cpp:233)
    """
    return (
        1.0
        / (2 * beta * 2 * beta)
        * np.exp(-np.sqrt(2.0) * node_dis / beta)
        * (2.0 * node_dis + np.sqrt(2.0) * beta)
    )


def gaussian_kernel(node_dis: np.ndarray, beta: float) -> np.ndarray:
    """Gaussian kernel G = exp(−d²/2β²) — the NumPy prototype's variant
    (tracking_test.py:290, 305), applicable to Euclidean or geodesic d."""
    return np.exp(-np.square(node_dis) / (2 * beta**2))


def geodesic_redistance(
    p: np.ndarray,
    y: np.ndarray,
    x: np.ndarray,
    node_coord: np.ndarray,
) -> np.ndarray:
    """Replace Euclidean squared distances with mixed geodesic+Euclidean ones.

    For each point: find the argmax-membership node, pick the nearer of its
    chain neighbours (with the reference's boundary fallback that substitutes
    index 2 / M−3 when out of range, trackdlo.cpp:313-321), then distances to
    nodes beyond the pair accumulate along the chain (trackdlo.cpp:303-351).
    Entries strictly between the pair (only possible via the boundary
    fallback) remain 0 — a reference quirk kept for parity.
    """
    m, n = p.shape[0], p.shape[1]
    out = np.zeros((m, n))
    max_p_nodes = np.argmax(p, axis=0)
    for i in range(n):
        mp = int(max_p_nodes[i])
        cand1 = mp - 1
        if cand1 == -1:
            cand1 = 2
        cand2 = mp + 1
        if cand2 == m:
            cand2 = m - 3
        d1 = np.linalg.norm(y[cand1] - x[i])
        d2 = np.linalg.norm(y[cand2] - x[i])
        nxt = cand1 if d1 < d2 else cand2

        d_mp = np.linalg.norm(y[mp] - x[i])
        d_nxt = np.linalg.norm(y[nxt] - x[i])
        out[mp, i] = d_mp**2
        out[nxt, i] = d_nxt**2

        if mp < nxt:
            for j in range(0, mp):
                out[j, i] = (abs(node_coord[j] - node_coord[mp]) + d_mp) ** 2
            for j in range(nxt, m):
                out[j, i] = (abs(node_coord[j] - node_coord[nxt]) + d_nxt) ** 2
        else:
            for j in range(0, nxt):
                out[j, i] = (abs(node_coord[j] - node_coord[nxt]) + d_nxt) ** 2
            for j in range(mp, m):
                out[j, i] = (abs(node_coord[j] - node_coord[mp]) + d_mp) ** 2
    return out


def cpd_lle(
    x_orig: np.ndarray,
    y: np.ndarray,
    sigma2: float,
    beta: float,
    lam: float,
    lle_weight: float,
    mu: float,
    max_iter: int,
    tol: float,
    include_lle: bool,
    correspondence_priors: np.ndarray | None = None,
    alpha: float = 0.0,
    visible_nodes: list[int] | None = None,
    k_vis: float = 0.0,
    visibility_threshold: float = 0.01,
    prune_radius: float = 0.1,
    kernel: str = "mct_geodesic",
    use_geodesic_redistance: bool = True,
    mm=np.matmul,
) -> CpdLleResult:
    """EM registration of M chain nodes to N points (trackdlo.cpp:161-441).

    ``correspondence_priors`` is a (P, 4) array of rows (index, x, y, z)
    matching the reference's std::vector<MatrixXd> layout (trackdlo.cpp:242-260).

    ``mm``: the matrix product every product of the pass goes through
    (``np.matmul``, float64; the control passes a lower-precision product).
    """
    x_orig = np.asarray(x_orig, dtype=float)
    y = np.asarray(y, dtype=float).copy()

    # Prune input points farther than prune_radius from every node
    # (trackdlo.cpp:177-195).
    if len(x_orig):
        d_all = np.linalg.norm(x_orig[None, :, :] - y[:, None, :], axis=2)
        x = x_orig[d_all.min(axis=0) < prune_radius]
    else:
        x = x_orig

    m = len(y)
    n = len(x)
    d = 3
    y0 = y.copy()

    # Geodesic node coordinates and the kernel matrix (trackdlo.cpp:216-233;
    # Gaussian variants from tracking_test.py:288-305).
    seg = np.linalg.norm(np.diff(y0, axis=0), axis=1)
    node_coord = np.concatenate([[0.0], np.cumsum(seg)])
    node_dis = np.abs(node_coord[:, None] - node_coord[None, :])
    if kernel == "mct_geodesic":
        g = mct_kernel(node_dis, beta)
    elif kernel == "gaussian_geodesic":
        g = gaussian_kernel(node_dis, beta)
    elif kernel == "gaussian_euclidean":
        euclid = np.sqrt(np.sum((y0[:, None, :] - y0[None, :, :]) ** 2, axis=2))
        g = gaussian_kernel(euclid, beta)
    else:
        raise ValueError(f"unknown kernel {kernel!r}")

    # LLE matrix (trackdlo.cpp:236-237).
    l_mat = calc_lle_weights(6, y0, mm)
    h = mm((np.eye(m) - l_mat).T, (np.eye(m) - l_mat))

    # Correspondence-prior selector J and target Y_extended
    # (trackdlo.cpp:240-260).
    j_mat = np.zeros((m, m))
    y_extended = y0.copy()
    has_priors = correspondence_priors is not None and len(correspondence_priors) > 0
    if has_priors:
        for row in np.asarray(correspondence_priors, dtype=float):
            idx = int(row[0])
            j_mat[idx, idx] = 1.0
            y_extended[idx] = row[1:4]

    if n == 0:
        return CpdLleResult(y=y, sigma2=sigma2, converged=False, iterations=0)

    diff_xy = np.sum((y0[:, None, :] - x[None, :, :]) ** 2, axis=2)
    if sigma2 == 0:
        sigma2 = diff_xy.sum() / (d * m * n)

    use_vis = (
        visible_nodes is not None
        and len(visible_nodes) != 0
        and len(visible_nodes) != m
        and k_vis != 0
    )

    converged = True
    it = 0
    for it in range(max_iter):
        # Per-node nearest point distance, zeroed when within the visibility
        # threshold (trackdlo.cpp:278-296).
        diff_xy = np.sum((y[:, None, :] - x[None, :, :]) ** 2, axis=2)
        shortest = np.sqrt(diff_xy.min(axis=1))
        shortest = np.where(shortest <= visibility_threshold, 0.0, shortest)

        # E-step (trackdlo.cpp:298-301).
        p = np.exp(-0.5 * diff_xy / sigma2)
        c = (2 * np.pi * sigma2) ** (d / 2) * mu / (1 - mu) * m / n
        p = p / (p.sum(axis=0)[None, :] + c)

        # Geodesic re-distancing (trackdlo.cpp:303-354); the prototype's
        # pure-Euclidean mode (tracking_test.py use_geodesic=False) skips it
        # and keeps the single normalization above.
        if use_geodesic_redistance:
            pts_dis_sq_geo = geodesic_redistance(p, y, x, node_coord)
            p = np.exp(-0.5 * pts_dis_sq_geo / sigma2)

            # Visibility-aware membership prior (trackdlo.cpp:357-383).
            if use_vis:
                p_vis_node = np.exp(-k_vis * shortest)
                p = p * (p_vis_node / p_vis_node.sum())[:, None]
                c = (2 * np.pi * sigma2) ** (d / 2) * mu / (1 - mu) / n
                p = p / (p.sum(axis=0)[None, :] + c)
            else:
                p = p / (p.sum(axis=0)[None, :] + c)

        pt1 = p.sum(axis=0)
        p1 = p.sum(axis=1)
        np_total = p1.sum()
        px = mm(p, x)

        # M-step (trackdlo.cpp:392-415).
        a_mat = mm(np.diag(p1), g) + lam * sigma2 * np.eye(m)
        b_mat = px - mm(np.diag(p1), y0)
        if include_lle:
            a_mat = a_mat + sigma2 * lle_weight * mm(h, g)
            b_mat = b_mat - sigma2 * lle_weight * mm(h, y0)
        if has_priors:
            a_mat = a_mat + alpha * mm(j_mat, g)
            b_mat = b_mat + alpha * (y_extended - y0)

        # The reference uses a complete orthogonal decomposition (minimum-norm
        # least squares, trackdlo.cpp:415); lstsq matches that behaviour.
        w = np.linalg.lstsq(a_mat, b_mat, rcond=None)[0]

        t = y0 + mm(g, w)
        tr_xtdpt1x = np.trace(mm(mm(x.T, np.diag(pt1)), x))
        tr_pxtt = np.trace(mm(px.T, t))
        tr_ttdp1t = np.trace(mm(mm(t.T, np.diag(p1)), t))
        sigma2 = (tr_xtdpt1x - 2 * tr_pxtt + tr_ttdp1t) / (np_total * d)
        # Robustness guard (deviation from the reference, which can drive
        # sigma2 <= 0 on noise-free clouds and NaN out): floor at ~1e-10.
        sigma2 = max(sigma2, 1e-10)

        if pt2pt_dis(y, t) / m < tol:
            y = t
            break
        y = t
        if it == max_iter - 1:
            converged = False

    return CpdLleResult(y=y, sigma2=float(sigma2), converged=converged, iterations=it + 1)


def register_cold_start(
    pts: np.ndarray, m: int, mu: float, max_iter: int
) -> tuple[np.ndarray, float]:
    """Plain GMM EM cold-start registration (utils.cpp:21-82).

    Initializes Y as a 0.1 m straight segment and runs fixed-iteration EM with
    the closed-form mean update Y = PX ⊘ P1.
    """
    x = np.asarray(pts, dtype=float)
    n, d = x.shape
    y = np.zeros((m, 3))
    y[:, 1] = 0.1 / m * np.arange(m)

    diff_xy = np.sum((y[:, None, :] - x[None, :, :]) ** 2, axis=2)
    sigma2 = diff_xy.sum() / (d * m * n)

    for _ in range(max_iter):
        diff_xy = np.sum((y[:, None, :] - x[None, :, :]) ** 2, axis=2)
        p = np.exp(-0.5 * diff_xy / sigma2)
        c = (2 * np.pi * sigma2) ** (d / 2) * mu / (1 - mu) * m / n
        p = p / (p.sum(axis=0)[None, :] + c)
        p1 = p.sum(axis=1)
        px = p @ x
        y = px / p1[:, None]
        sigma2 = float((p * diff_xy).sum() / (p.sum() * d))

    return y, sigma2
