"""The CPD/MCT EM registration pass.

Counterpart of trackdlo_tpu/ops/cpd_lle.py, product route: prune by the
visibility pass's per-point minima, build the MCT kernel G (and the LLE
HG/HY0, the prior rows JG and the prior displacement), set the visibility
gate, then run the whole tolerance loop in one call of kernel E
(:func:`trackdlo_tpu_torch.ops.hopper_kernels.fused_em_loop`). Data-dependent
scalars (v_count, n_count, σ², the gate) stay on the device and reach the
kernel as one small buffer.

Only the ``"lu"`` solver with the MCT-geodesic E-step is ported; the other
solvers, ``return_deltas``, ``axis_name`` and ``use_fused_mstep`` raise
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from trackdlo_tpu_torch.ops.hopper_kernels import fused_em_loop
from trackdlo_tpu_torch.ops.kernels import (
    lle_regularizer,
    masked_geodesic_coords,
    mct_kernel,
    pairwise_sq_dists,
)

_BIG = 1e5


@dataclasses.dataclass(frozen=True)
class CpdParams:
    """Hyperparameters of one EM pass: the fields of the JAX CpdParams but
    ``use_pallas``; here the tensors' device alone picks kernel E (CUDA) or
    its plain version (CPU)."""

    beta: float
    lam: float
    lle_weight: float
    mu: float
    max_iter: int
    tol: float
    include_lle: bool
    alpha: float = 0.0
    k_vis: float = 0.0
    visibility_threshold: float = 0.01
    prune_radius: float = 0.1
    use_priors: bool = False
    use_visibility: bool = False
    use_fused_mstep: bool = False
    solver: str = "lu"
    kernel: str = "mct_geodesic"
    use_geodesic_redistance: bool = True


class CpdResult(NamedTuple):
    y: torch.Tensor
    sigma2: torch.Tensor
    converged: torch.Tensor
    iterations: torch.Tensor


def _check_ported(params: CpdParams, axis_name, return_deltas) -> None:
    if params.solver != "lu":
        raise NotImplementedError(f"solver {params.solver!r} is not ported yet")
    if params.use_fused_mstep:
        raise NotImplementedError("use_fused_mstep is not ported yet")
    if params.kernel != "mct_geodesic" or not params.use_geodesic_redistance:
        raise NotImplementedError("only the MCT-geodesic E-step is ported")
    if axis_name is not None:
        raise NotImplementedError("point-axis sharding is not ported yet")
    if return_deltas:
        raise NotImplementedError("return_deltas is not ported yet")


class EmStaging(NamedTuple):
    """Kernel E's inputs for one pass: positional tensors, keyword
    constants, the pruned point count and the starting σ²."""

    args: tuple
    kwargs: dict
    n_count: torch.Tensor
    sigma2: torch.Tensor


def em_staging(x, x_mask, y, node_mask, sigma2, params: CpdParams, prior_pos=None,
               prior_mask=None, visible_count=None, point_min_sq=None) -> EmStaging:
    """Prune, build G/HG/HY0/JG/prior displacement and the gate: every
    iteration-invariant input of the EM loop."""
    dt, dev = y.dtype, y.device
    m = y.shape[0]
    zero = torch.zeros((), dtype=dt, device=dev)
    sigma2 = torch.as_tensor(sigma2, dtype=dt, device=dev)
    v_count = node_mask.to(dt).sum()
    y0 = y

    sq_d0 = None
    if point_min_sq is None:
        sq_d0 = pairwise_sq_dists(y0, x)
        point_min_sq = torch.where(node_mask[:, None], sq_d0, _BIG).amin(dim=0)
    x_mask = x_mask & (point_min_sq < params.prune_radius**2)
    n_count = x_mask.to(dt).sum()
    n_safe = torch.clamp_min(n_count, 1.0)

    node_coord = masked_geodesic_coords(y0, node_mask)
    node_dis = torch.abs(node_coord[:, None] - node_coord[None, :])
    pair_mask = node_mask[:, None] & node_mask[None, :]
    g = torch.where(pair_mask, mct_kernel(node_dis, params.beta), zero)

    zeros_mm = torch.zeros((m, m), dtype=dt, device=dev)
    zeros_m3 = torch.zeros((m, 3), dtype=dt, device=dev)
    if params.include_lle:
        h = lle_regularizer(y0, node_mask)
        hg, hy0 = h @ g, h @ y0
    else:
        hg, hy0 = zeros_mm, zeros_m3
    if params.use_priors:
        active = prior_mask & node_mask
        jg = torch.where(active[:, None], g, zero)
        prior_disp = torch.where(active[:, None], prior_pos - y0, zero)
    else:
        jg, prior_disp = zeros_mm, zeros_m3

    # Visibility gate: on when some but not all nodes are visible.
    if params.use_visibility and params.k_vis != 0 and visible_count is not None:
        vc = visible_count.to(dt)
        gate = (vc != v_count) & (vc > 0)
    else:
        gate = torch.zeros((), dtype=torch.bool, device=dev)

    if sq_d0 is not None:
        # sigma2 == 0: start from the mean squared node-point distance.
        masked = torch.where(x_mask[None, :] & node_mask[:, None], sq_d0, zero)
        s2_init = masked.sum() / (3 * torch.clamp_min(v_count, 1.0) * n_safe)
        sigma2 = torch.where(sigma2 == 0, s2_init, sigma2)

    dyn = torch.stack([sigma2, v_count, n_safe, gate.to(dt)])
    args = tuple(
        t.contiguous()
        for t in (dyn, y0, node_coord, node_mask.to(dt), g, hg, hy0, jg, prior_disp,
                  x, x_mask.to(dt))
    )
    kwargs = dict(
        muf=params.mu / (1.0 - params.mu),
        k_vis=float(params.k_vis),
        tau_vis=float(params.visibility_threshold),
        lam=float(params.lam),
        coef_lle=float(params.lle_weight) if params.include_lle else 0.0,
        alpha=float(params.alpha) if params.use_priors else 0.0,
        tol=float(params.tol),
        max_iter=int(params.max_iter),
    )
    return EmStaging(args, kwargs, n_count, sigma2)


def cpd_lle(
    x: torch.Tensor,
    x_mask: torch.Tensor,
    y: torch.Tensor,
    node_mask: torch.Tensor,
    sigma2: torch.Tensor,
    params: CpdParams,
    prior_pos: torch.Tensor | None = None,
    prior_mask: torch.Tensor | None = None,
    visible_count: torch.Tensor | None = None,
    axis_name: str | None = None,
    point_min_sq: torch.Tensor | None = None,
    return_deltas: bool = False,
) -> CpdResult:
    """EM registration of the masked node chain ``y`` (M, 3) to the masked
    cloud ``x`` (N, 3). ``point_min_sq`` (N,), when given, is each point's
    min squared distance to the valid nodes (from the visibility pass) and
    requires ``sigma2 > 0``."""
    _check_ported(params, axis_name, return_deltas)
    st = em_staging(x, x_mask, y, node_mask, sigma2, params, prior_pos, prior_mask,
                    visible_count, point_min_sq)
    y_out, stats = fused_em_loop(*st.args, **st.kwargs)
    sigma2 = st.sigma2
    # Degenerate input: no valid point at all leaves the state unchanged.
    any_points = st.n_count > 0
    return CpdResult(
        y=torch.where(any_points, y_out, y),
        sigma2=torch.where(any_points, stats[0], sigma2),
        converged=stats[2] > 0,
        iterations=stats[1].to(torch.int32),
    )
