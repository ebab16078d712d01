"""Plain CPD/GMM registration (the cold-start ``reg``).

Counterpart of trackdlo_tpu/models/cpd.py: straight-line node init, then a
fixed number of EM iterations with the closed-form mean update
Y = PX ⊘ P1. The JAX package computes it outside any Pallas kernel, so here
it is plain PyTorch (``torch.matmul`` at full float32 precision).
"""

from __future__ import annotations

import math

import torch

from trackdlo_tpu_torch.device import resolve_device, set_full_fp32


def register_gmm(x, x_mask, m: int = 40, mu: float = 0.05, max_iter: int = 100, device=None):
    """Register ``m`` nodes to the masked point set ``x`` (N, 3) with
    ``x_mask`` (N,) bool (tensors or arrays); returns (Y (m, 3), sigma2 ())
    on ``device`` (the CUDA card unless the caller names the CPU).

    The node chain is NOT ordered on output (the reference runs sort_pts
    afterwards, tracking_test.py:526)."""
    dev = resolve_device(device)
    set_full_fp32()
    x = torch.as_tensor(x, dtype=torch.float32).to(dev)
    x_mask = torch.as_tensor(x_mask).to(dev, torch.bool)
    d = 3
    n_valid = torch.clamp_min(x_mask.to(torch.float32).sum(), 1.0)
    y = torch.zeros((m, 3), dtype=torch.float32, device=dev)
    # 0.1 m straight segment along +y (utils.cpp:24-29).
    y[:, 1] = 0.1 / m * torch.arange(m, dtype=torch.float32, device=dev)
    valid = x_mask[None, :]
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    def sq_dists(y):
        diff = y[:, None, :] - x[None, :, :]
        return (diff * diff).sum(dim=-1)

    s2 = torch.where(valid, sq_dists(y), zero).sum() / (d * m * n_valid)
    for _ in range(max_iter):
        sq = sq_dists(y)
        p = torch.where(valid, torch.exp(-0.5 * sq / s2), zero)
        c = (2 * math.pi * s2) ** (d / 2) * mu / (1 - mu) * m / n_valid
        p = p / (p.sum(dim=0, keepdim=True) + c)
        p = torch.where(valid, p, zero)
        p1 = p.sum(dim=1)
        px = p @ x
        y = px / torch.clamp_min(p1, 1e-20)[:, None]
        s2 = torch.clamp_min((p * sq).sum() / torch.clamp_min(p.sum() * d, 1e-20), 1e-10)
    return y, s2
