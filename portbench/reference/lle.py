"""Locally-linear-embedding weights over the node chain.

Reference: trackdlo.cpp:92-158. Note the C++ neighbourhood is *truncated* at
the chain ends (get_nearest_indices, trackdlo.cpp:92-117), unlike the Python
prototype which extends to the other side (utils/tracking_test.py:233-247).
Parity follows the C++ behaviour, per SURVEY.md §5.
"""

from __future__ import annotations

import numpy as np


def nearest_chain_indices(k: int, m: int, idx: int) -> list[int]:
    """Chain neighbours of ``idx``: up to k on each side, truncated at the
    ends (trackdlo.cpp:92-117)."""
    if idx - k < 0:
        return [i for i in range(0, idx + k + 1) if i != idx]
    if idx + k >= m:
        return [i for i in range(idx - k, m) if i != idx]
    return [i for i in range(idx - k, idx + k + 1) if i != idx]


def calc_lle_weights(k: int, x: np.ndarray, mm=np.matmul) -> np.ndarray:
    """LLE reconstruction weights W (M×M) (trackdlo.cpp:119-158).

    Per node: Gram matrix of neighbour offsets, inverted (with an eps-diagonal
    fallback when singular, trackdlo.cpp:136-144), then the weight vector is
    the normalized row sums of the inverse.

    Deviation from the reference: the C++ takes the plain inverse whenever
    det(Gi) != 0 (trackdlo.cpp:136) — but 2k=6 neighbour offsets in R^3 have
    rank <= 3, so Gi is always numerically singular and that inverse is
    ill-defined. Here the eps-diagonal regularization is applied
    unconditionally, giving a deterministic, well-conditioned spec shared by
    the oracle and the TPU path.
    """
    x = np.asarray(x, dtype=float)
    m = len(x)
    w = np.zeros((m, m))
    for i in range(m):
        indices = nearest_chain_indices(k // 2, m, i)
        xi = x[i]
        neigh = x[indices]
        component = xi[None, :].repeat(len(neigh), axis=0).T - neigh.T
        gi = mm(component.T, component)
        gi_inv = np.linalg.inv(gi + 1e-5 * np.eye(len(gi)))
        ones = np.ones((len(neigh), 1))
        wi = mm(gi_inv, ones) / mm(mm(ones.T, gi_inv), ones).item()
        w[i, indices] = wi.ravel()
    return w


def lle_regularizer(k: int, x: np.ndarray) -> np.ndarray:
    """H = (I − L)ᵀ(I − L) (trackdlo.cpp:236-237)."""
    m = len(x)
    l_mat = calc_lle_weights(k, x)
    i_l = np.eye(m) - l_mat
    return i_l.T @ i_l
