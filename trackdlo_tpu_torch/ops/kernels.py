"""Shared numerics: distances, geodesic coordinates, MCT kernel, LLE weights.

Counterpart of trackdlo_tpu/ops/kernels.py, in plain PyTorch (no kernel of
its own: these build the small (M, M) operators of each EM pass). Each takes
any leading batch axes (a stream axis in the batched step).
"""

from __future__ import annotations

import math

import torch


def pairwise_sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(len(a), len(b)) squared distances in the difference form (no
    |a|²+|b|²−2ab cancellation for near-coincident points)."""
    d = a[..., :, None, :] - b[..., None, :, :]
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]


def _arc_length(seg: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros(seg.shape[:-1] + (1,), dtype=seg.dtype, device=seg.device)
    return torch.cat([zero, torch.cumsum(seg, -1)], dim=-1)


def geodesic_coords(y: torch.Tensor) -> torch.Tensor:
    """Cumulative arc length along the chain."""
    return _arc_length(torch.linalg.norm(torch.diff(y, dim=-2), dim=-1))


def masked_geodesic_coords(y: torch.Tensor, node_mask: torch.Tensor) -> torch.Tensor:
    """Arc length over a prefix-packed chain; rows past the valid prefix add
    zero-length segments."""
    seg = torch.linalg.norm(torch.diff(y, dim=-2), dim=-1)
    seg = torch.where(node_mask[..., 1:], seg, torch.zeros_like(seg))
    return _arc_length(seg)


def mct_kernel(node_dis: torch.Tensor, beta: float) -> torch.Tensor:
    """G = 1/(4β²)·exp(−√2·d/β)·(2d + √2·β) over geodesic distances."""
    s2 = math.sqrt(2.0)
    return (
        1.0 / (2 * beta * 2 * beta)
        * torch.exp(-s2 * node_dis / beta)
        * (2.0 * node_dis + s2 * beta)
    )


def gaussian_kernel(node_dis: torch.Tensor, beta: float) -> torch.Tensor:
    """The prototype's Gaussian kernel G = exp(−d²/(2β²))."""
    return torch.exp(-(node_dis * node_dis) / (2 * beta * beta))


def chain_lle_weights(y: torch.Tensor, node_mask: torch.Tensor, k: int = 6) -> torch.Tensor:
    """LLE reconstruction weights over the chain, batched over nodes.

    Each node solves its (2·(k/2)+1)-slot regularised Gram system with chain
    truncation as slot masks; the (M, w, w) systems are solved by an
    unrolled diagonal-pivot Gauss-Jordan (the Gram is PSD + 1e-5·I and
    deactivated slots are identity rows). Invalid rows give zero weights."""
    m = y.shape[-2]
    half = k // 2
    width = 2 * half + 1
    dev, dt = y.device, y.dtype
    zero = torch.zeros((), dtype=dt, device=dev)
    valid_count = node_mask.to(torch.int64).sum(dim=-1)[..., None, None]
    idx = torch.arange(m, device=dev)
    offsets = torch.arange(width, device=dev) - half
    neigh_idx = idx[:, None] + offsets[None, :]
    slot_mask = (neigh_idx >= 0) & (neigh_idx < valid_count) & (neigh_idx != idx[:, None])

    neigh = y[..., neigh_idx.clamp(0, m - 1), :]  # (..., M, width, 3); clamped slots are masked
    off = torch.where(slot_mask[..., None], y[..., :, None, :] - neigh, zero)
    gram = torch.einsum("...mwd,...mvd->...mwv", off, off)
    eye_w = torch.eye(width, dtype=dt, device=dev)
    pair = slot_mask[..., :, None] & slot_mask[..., None, :]
    gram = torch.where(pair, gram, eye_w) + 1e-5 * eye_w

    a = torch.cat([gram, slot_mask.to(dt)[..., None]], dim=-1)
    for j in range(width):
        row = a[..., j : j + 1, :] / a[..., j : j + 1, j : j + 1]
        a = a - a[..., :, j : j + 1] * row
        a[..., j, :] = row[..., 0, :]
    sol = a[..., width]
    denom = (sol * slot_mask).sum(dim=-1, keepdim=True)
    wi = torch.where(slot_mask, sol / torch.where(denom == 0, torch.ones_like(denom), denom), zero)

    # W[i, i+o] = wi[i, o]: each window column fills one diagonal.
    w = torch.zeros(y.shape[:-2] + (m, m), dtype=dt, device=dev)
    for oi in range(width):
        o = oi - half
        if o >= 0:
            w.diagonal(o, dim1=-2, dim2=-1).copy_(wi[..., : m - o, oi])
        else:
            w.diagonal(o, dim1=-2, dim2=-1).copy_(wi[..., -o:, oi])
    return torch.where(node_mask[..., :, None], w, zero)


def lle_regularizer(y: torch.Tensor, node_mask: torch.Tensor, k: int = 6) -> torch.Tensor:
    """H = (I − L)ᵀ(I − L) over the valid prefix."""
    m = y.shape[-2]
    l_mat = chain_lle_weights(y, node_mask, k)
    eye = torch.eye(m, dtype=y.dtype, device=y.device) * node_mask[..., :, None].to(y.dtype)
    i_l = eye - l_mat
    return i_l.mT @ i_l


def split3(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """float32 ``v`` as three bfloat16 pieces held in float32 (the JAX
    package's ``_exact_dot`` split, pallas_kernels.py:1158-1163): hi the
    nearest bfloat16 of v, mid that of v - hi, lo that of v - hi - mid."""
    bf = lambda t: t.to(torch.bfloat16).to(torch.float32)
    hi = bf(v)
    r1 = v - hi
    mid = bf(r1)
    return hi, mid, bf(r1 - mid)


def exact_split_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the JAX package's ``_exact_dot`` (pallas_kernels.py:1152)
    takes it: both operands split into three bfloat16 pieces, the nine piece
    products (exact in float32) summed over the inner axis in float32, and
    the nine sums added in the order (hi, hi), (hi, mid), ..., (lo, lo).
    Where a product cancels heavily (the EM's M-step: A W against B, and
    G W) this stays near the exact value where a float32 product does not.
    Other dtypes take the plain product."""
    if a.dtype != torch.float32:
        return a @ b
    out = None
    for pa in split3(a):
        for pb in split3(b):
            term = pa @ pb
            out = term if out is None else out + term
    return out
