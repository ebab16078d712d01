"""The CPD/MCT EM registration pass.

Counterpart of trackdlo_tpu/ops/cpd_lle.py: prune by the visibility pass's
per-point minima, build the kernel G (MCT, or the prototype's Gaussian) and
the LLE HG/HY0, the prior rows JG and the prior displacement, set the
visibility gate, then iterate. The routes, as in the JAX package:

- one stream, solver ``"lu"``: the whole tolerance loop in one call of
  kernel E (:func:`trackdlo_tpu_torch.ops.hopper_kernels.fused_em_loop`);
- one stream, any other solver or ``return_deltas``: the per-iteration loop,
  each iteration one launch of the E-step kernel for one stream (B6), the
  M-step assembly in torch and the chosen solve;
- B ≥ 2 streams (:func:`cpd_lle_batched`, the counterpart of
  ``jax.vmap(cpd_lle)``): the per-iteration loop over a leading stream axis,
  each iteration one launch of the batched E-step (B7) and one of the
  batched Gauss-Jordan solve (B8), in lockstep as ``lax.while_loop`` runs
  under ``vmap``. A batch of one takes kernel E;
- ``use_fused_mstep``: the per-iteration loop, each iteration one launch of
  kernel F (B10) for all streams (the solver is not used);
- the prototype E-step variants (``kernel`` ``"gaussian_geodesic"`` or
  ``"gaussian_euclidean"``, ``use_geodesic_redistance=False``): the
  per-iteration loop with the JAX package's XLA iteration in torch and the
  chosen solver, which no kernel of the JAX package computes;
- ``axis_name`` (the point-sharded EM, the JAX package's ``shard_map`` over
  a ``model`` axis): ``x`` is this rank's shard of the cloud and
  ``axis_name`` the ``torch.distributed`` process group of the ranks that
  hold the other shards. Every route is then the per-iteration loop (never
  kernel E or F, also for ``use_fused_mstep``); each over-points sum is an
  all-reduce SUM (:func:`~trackdlo_tpu_torch.ops.collectives.psum`) and
  each over-points minimum an all-reduce MIN (``pmin``). With the
  visibility prior, an iteration runs kernel N (B9) on the shard, the
  cross-shard minimum, the visibility weights, then the one-phase E-step
  (kernel S) with those weights; without it, the two-phase E-step. Node
  space stays replicated: every rank solves the same M-step.

Data-dependent scalars (v_count, n_count, σ², the gate) stay on the device.
Eagerly the lockstep loop reads one flag per iteration to learn whether any
stream is still active; under an axis every rank reads the same flag, since
every rank holds the same all-reduced bits. Inside a CUDA graph the card
decides the trips (:mod:`~trackdlo_tpu_torch.ops.graph_loop`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from trackdlo_tpu_torch.ops import graph_loop
from trackdlo_tpu_torch.ops.collectives import pmin, psum
from trackdlo_tpu_torch.ops.hopper_kernels import (
    fused_em_iteration_staged,
    fused_em_loop,
    fused_estep_packed,
    fused_estep_packed_batch,
    gauss_jordan_solve_batched,
    gauss_jordan_solve_batched_plain,
    nearest_point_sq,
)
from trackdlo_tpu_torch.ops.kernels import (
    gaussian_kernel,
    lle_regularizer,
    masked_geodesic_coords,
    mct_kernel,
    pairwise_sq_dists,
)

_BIG = 1e5
_TWO_PI = 6.283185307179586


@dataclasses.dataclass(frozen=True)
class CpdParams:
    """Hyperparameters of one EM pass: the fields of the JAX CpdParams but
    ``use_pallas``; here the tensors' device alone picks the kernels (CUDA)
    or their plain versions (CPU)."""

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


_KERNELS = ("mct_geodesic", "gaussian_geodesic", "gaussian_euclidean")


def _check_params(params: CpdParams) -> None:
    if params.solver not in _UPDATE:
        raise ValueError(f"unknown solver {params.solver!r}")
    if params.kernel not in _KERNELS:
        raise ValueError(f"unknown kernel {params.kernel!r}")


def _is_prototype(params: CpdParams) -> bool:
    """The prototype E-step variants, which take the XLA iteration."""
    return params.kernel != "mct_geodesic" or not params.use_geodesic_redistance


class EmStaging(NamedTuple):
    """The EM loop's inputs for one pass (a leading stream axis on every
    tensor when batched): positional tensors, keyword constants, the pruned
    point count and the starting σ²."""

    args: tuple  # dyn, y0, coord, nm, g, hg, hy0, jg, pd, x, xm
    kwargs: dict
    n_count: torch.Tensor
    sigma2: torch.Tensor


def em_staging(x, x_mask, y, node_mask, sigma2, params: CpdParams, prior_pos=None,
               prior_mask=None, visible_count=None, point_min_sq=None,
               axis_name=None) -> EmStaging:
    """Prune, build G/HG/HY0/JG/prior displacement and the gate: every
    iteration-invariant input of the EM loop. Every tensor may carry the
    same leading stream axis (x (B, N, 3), y (B, M, 3), sigma2 (B,), …).
    Under ``axis_name`` the point count and the σ² init's sum are summed
    over the shards."""
    dt, dev = y.dtype, y.device
    zero = torch.zeros((), dtype=dt, device=dev)
    sigma2 = torch.as_tensor(sigma2, dtype=dt, device=dev)
    v_count = node_mask.to(dt).sum(dim=-1)
    y0 = y

    sq_d0 = None
    if point_min_sq is None:
        sq_d0 = pairwise_sq_dists(y0, x)
        point_min_sq = torch.where(node_mask[..., :, None], sq_d0, _BIG).amin(dim=-2)
    x_mask = x_mask & (point_min_sq < params.prune_radius**2)
    n_count = psum(x_mask.to(dt).sum(dim=-1), axis_name)
    n_safe = torch.clamp_min(n_count, 1.0)

    node_coord = masked_geodesic_coords(y0, node_mask)
    node_dis = torch.abs(node_coord[..., :, None] - node_coord[..., None, :])
    pair_mask = node_mask[..., :, None] & node_mask[..., None, :]
    if params.kernel == "mct_geodesic":
        g_raw = mct_kernel(node_dis, params.beta)
    elif params.kernel == "gaussian_geodesic":
        g_raw = gaussian_kernel(node_dis, params.beta)
    else:
        g_raw = gaussian_kernel(torch.sqrt(pairwise_sq_dists(y0, y0)), params.beta)
    g = torch.where(pair_mask, g_raw, zero)

    zeros_mm = torch.zeros_like(g)
    zeros_m3 = torch.zeros_like(y0)
    if params.include_lle:
        h = lle_regularizer(y0, node_mask)
        hg, hy0 = h @ g, h @ y0
    else:
        hg, hy0 = zeros_mm, zeros_m3
    if params.use_priors:
        active = prior_mask & node_mask
        jg = torch.where(active[..., :, None], g, zero)
        prior_disp = torch.where(active[..., :, None], prior_pos - y0, zero)
    else:
        jg, prior_disp = zeros_mm, zeros_m3

    # Visibility gate: on when some but not all nodes are visible.
    if params.use_visibility and params.k_vis != 0 and visible_count is not None:
        vc = visible_count.to(dt)
        gate = (vc != v_count) & (vc > 0)
    else:
        gate = torch.zeros(v_count.shape, dtype=torch.bool, device=dev)

    if sq_d0 is not None:
        # sigma2 == 0: start from the mean squared node-point distance.
        masked = torch.where(x_mask[..., None, :] & node_mask[..., :, None], sq_d0, zero)
        s2_init = psum(masked.sum(dim=(-2, -1)), axis_name) / (
            3 * torch.clamp_min(v_count, 1.0) * n_safe)
        sigma2 = torch.where(sigma2 == 0, s2_init, sigma2)

    dyn = torch.stack(torch.broadcast_tensors(sigma2, v_count, n_safe, gate.to(dt)), dim=-1)
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


# ---------------------------------------------------------------------------
# The per-iteration EM over a leading stream axis.
# ---------------------------------------------------------------------------


def estep_scalars(dyn, s2, params: CpdParams):
    """(B, 8) E-step scalars per stream: sigma2, c_plain, c_vis, gate,
    v_count, k_vis, tau_vis, 0 (the JAX package's ``estep_scalars``)."""
    v_count, n_safe, gate = dyn[:, 1], dyn[:, 2], dyn[:, 3]
    c_base = (_TWO_PI * s2) ** 1.5 * params.mu / (1 - params.mu)
    c = c_base * v_count / n_safe
    c_vis = c_base / n_safe
    full = lambda v: torch.full_like(s2, v)
    return torch.stack(
        [s2, c, c_vis, gate, v_count, full(params.k_vis), full(params.visibility_threshold),
         full(0.0)], dim=1,
    )


def mstep_system(st: EmStaging, p1, px, s2, params: CpdParams):
    """The M-step system A w = B of every stream: (B, m, m) and (B, m, 3),
    identity rows and zero right-hand sides for inactive nodes."""
    _, y0, _, nm, g, hg, hy0, jg, pd, _, _ = st.args
    m = y0.shape[-2]
    node = nm > 0
    eye = torch.eye(m, dtype=y0.dtype, device=y0.device)
    s2c = s2[:, None, None]
    a = p1[:, :, None] * g + params.lam * s2c * eye
    b = px - p1[:, :, None] * y0
    if params.include_lle:
        a = a + s2c * params.lle_weight * hg
        b = b - s2c * params.lle_weight * hy0
    if params.use_priors:
        a = a + params.alpha * jg
        b = b + params.alpha * pd
    a = torch.where(node[:, :, None] & node[:, None, :], a, eye)
    b = torch.where(node[:, :, None], b, 0.0)
    return a.contiguous(), b.contiguous()


def _psum_packed(axis_name, *parts):
    """psum of several (B, …) tensors in one all-reduce."""
    if axis_name is None:
        return parts
    flat = psum(torch.cat([p.reshape(p.shape[0], -1) for p in parts], dim=1), axis_name)
    sizes = [p[0].numel() for p in parts]
    return tuple(f.reshape(p.shape) for f, p in zip(flat.split(sizes, dim=1), parts))


def em_iteration(st: EmStaging, y, s2, params: CpdParams, estep: Callable, update: Callable,
                 axis_name=None):
    """One EM iteration of every stream (the JAX package's
    ``em_iteration_pallas_sharded``, with or without an axis): the E-step,
    the M-step system, its solve and T = Y0 + G·W (``update``, see
    ``_UPDATE``), the σ² update (floored at 1e-10) and the mean node move.
    Returns (t (B, m, 3), sigma2 (B,), delta (B,)).

    Without an axis, or without the visibility prior, the E-step runs two
    phases (it finds each node's nearest point itself). Under ``axis_name``
    with the prior, the nearest points of this shard come from kernel N, the
    shards' minimum from ``pmin``, and the E-step runs one phase with the
    visibility weights made here; P1, PX, Np and tr(XᵀdPt1X) are then summed
    over the shards in one all-reduce."""
    dyn, y0, coord, nm, g, _, _, _, _, x, xm = st.args
    scal = estep_scalars(dyn, s2, params)
    y = y.contiguous()
    if axis_name is not None and params.use_visibility and params.k_vis != 0:
        shortest = torch.sqrt(pmin(nearest_point_sq(y, nm, x, xm), axis_name))
        shortest = torch.where(shortest <= params.visibility_threshold, 0.0, shortest)
        pv = torch.where(nm > 0, torch.exp(-params.k_vis * shortest), 0.0)
        pv = pv / torch.clamp_min(pv.sum(dim=1, keepdim=True), 1e-30)
        p1, px, stats, _ = estep(scal, y, coord, nm, pv, x, xm, two_phase=False)
    else:
        p1, px, stats, _ = estep(scal, y, coord, nm, torch.ones_like(nm), x, xm, two_phase=True)
    p1, px, stats = _psum_packed(axis_name, p1, px, stats)
    a, b = mstep_system(st, p1, px, s2, params)
    t = update(a, b, g, y0)
    tr_pxtt = (px * t).sum(dim=(1, 2))
    tr_tt = (p1[:, :, None] * t * t).sum(dim=(1, 2))
    s2_new = (stats[:, 1] - 2 * tr_pxtt + tr_tt) / (stats[:, 0] * 3)
    s2_new = torch.clamp_min(s2_new, 1e-10)
    move = torch.where(nm > 0, torch.linalg.norm(y - t, dim=2), 0.0).sum(dim=1)
    delta = move / torch.clamp_min(dyn[:, 1], 1.0)
    return t, s2_new, delta


def fused_iteration(st: EmStaging, y, s2, params: CpdParams, kernel: Callable | None = None):
    """One EM iteration of every stream in one launch of kernel F (the
    JAX package's ``em_iteration_pallas``); same results as
    :func:`em_iteration`. By default the launch computes the c's from the
    staging's ``dyn`` (:func:`fused_em_iteration_staged`); a ``kernel`` with
    the JAX package's arguments (F's plain version, or
    :func:`fused_em_iteration`) takes them computed here as the JAX package
    does."""
    dyn, y0, coord, nm, g, hg, hy0, jg, pd, x, xm = st.args
    kw = st.kwargs
    fkw = dict(k_vis=kw["k_vis"], tau_vis=kw["tau_vis"], lam=kw["lam"], coef_lle=kw["coef_lle"],
               alpha=kw["alpha"])
    if kernel is None:
        return fused_em_iteration_staged(y.contiguous(), s2, dyn, y0, nm, coord, g, hg, hy0, jg, pd,
                                         x, xm, muf=kw["muf"], **fkw)
    v_count, n_safe, gate = dyn[:, 1], dyn[:, 2], dyn[:, 3]
    c_base = (_TWO_PI * s2) ** 1.5 * params.mu / (1 - params.mu)
    return kernel(y.contiguous(), y0, nm, coord, g, hg, hy0, jg, pd, x, xm, s2,
                  c_base * v_count / n_safe, c_base / n_safe, gate, v_count, **fkw)


def _geodesic_redistance(p, sq_d, coord, node, v_count):
    """The XLA iteration's geodesic re-distance over (B, m, n): anchors at
    the first argmax membership and its nearer chain neighbour (boundary
    fallbacks to rows 2 and v_count − 3; a negative row wraps to the end, as
    ``take_along_axis`` does), then the distances along the chain, zero
    strictly between non-adjacent anchors."""
    m = p.shape[1]
    mp = torch.where(node[:, :, None], p, -torch.inf).argmax(dim=1)  # (B, n)
    vc = v_count.to(torch.int64)[:, None]
    take = lambda vals, idx: vals.gather(1, torch.where(idx < 0, idx + m, idx).clamp(0, m - 1)[:, None])[:, 0]
    cand1 = torch.where(mp - 1 == -1, 2, mp - 1)
    cand2 = torch.where(mp + 1 == vc, vc - 3, mp + 1)
    nxt = torch.where(take(sq_d, cand1) < take(sq_d, cand2), cand1, cand2)
    lo = torch.minimum(mp, nxt)
    hi = torch.maximum(mp, nxt)
    d_lo = torch.sqrt(take(sq_d, lo))
    d_hi = torch.sqrt(take(sq_d, hi))
    coord_b = coord[:, :, None].expand_as(sq_d)
    c_lo, c_hi = take(coord_b, lo), take(coord_b, hi)
    j = torch.arange(m, device=p.device)[None, :, None]
    below = torch.abs(coord[:, :, None] - c_lo[:, None, :]) + d_lo[:, None, :]
    above = torch.abs(coord[:, :, None] - c_hi[:, None, :]) + d_hi[:, None, :]
    lo_b, hi_b = lo[:, None, :], hi[:, None, :]
    return torch.where(
        j < lo_b, below * below,
        torch.where(j >= hi_b, above * above,
                    torch.where(j == lo_b, (d_lo * d_lo)[:, None, :], 0.0)),
    )


def em_iteration_xla(st: EmStaging, y, s2, params: CpdParams, update: Callable, axis_name=None):
    """One EM iteration of every stream as the JAX package's XLA iteration
    computes it, in plain tensor ops on any device: the route of the
    prototype E-step variants (the MCT or Gaussian G is in the staging; with
    ``use_geodesic_redistance=False`` one normalisation and no visibility
    prior). Under ``axis_name`` the nearest distances take the shards'
    minimum and P1, PX and tr(XᵀdPt1X) their sum. Returns (t, sigma2,
    delta) as :func:`em_iteration`."""
    dyn, y0, coord, nm, g, hg, hy0, jg, pd, x, xm = st.args
    v_count, n_safe, gate = dyn[:, 1], dyn[:, 2], dyn[:, 3] > 0
    node, pts = nm > 0, xm > 0
    pair = node[:, :, None] & pts[:, None, :]
    s2c = s2[:, None, None]
    sq_d = pairwise_sq_dists(y, x)
    shortest = torch.sqrt(pmin(torch.where(pts[:, None, :], sq_d, _BIG).amin(dim=2), axis_name))
    shortest = torch.where(shortest <= params.visibility_threshold, 0.0, shortest)
    p = torch.where(pair, torch.exp(-0.5 * sq_d / s2c), 0.0)
    c_base = (_TWO_PI * s2) ** 1.5 * params.mu / (1 - params.mu)
    c = c_base * v_count / n_safe
    p = p / (p.sum(dim=1, keepdim=True) + c[:, None, None])
    if params.use_geodesic_redistance:
        sq_geo = _geodesic_redistance(p, sq_d, coord, node, v_count)
        p = torch.where(pair, torch.exp(-0.5 * sq_geo / s2c), 0.0)
        p_vis = torch.where(node, torch.exp(-params.k_vis * shortest), 0.0)
        p_vis = p_vis / torch.clamp_min(p_vis.sum(dim=1, keepdim=True), 1e-30)
        p = torch.where(gate[:, None, None], p * p_vis[:, :, None], p)
        c_eff = torch.where(gate, c_base / n_safe, c)
        p = p / (p.sum(dim=1, keepdim=True) + c_eff[:, None, None])
        p = torch.where(pair, p, 0.0)
    pt1 = p.sum(dim=1)
    tr_x = (pt1[:, :, None] * x * x).sum(dim=(1, 2))
    p1, px, tr_x = _psum_packed(axis_name, p.sum(dim=2), p @ x, tr_x)
    a, b = mstep_system(st, p1, px, s2, params)
    t = update(a, b, g, y0)
    tr_pxtt = (px * t).sum(dim=(1, 2))
    tr_tt = (p1[:, :, None] * t * t).sum(dim=(1, 2))
    s2_new = torch.clamp_min((tr_x - 2 * tr_pxtt + tr_tt) / (p1.sum(dim=1) * 3), 1e-10)
    move = torch.where(node, torch.linalg.norm(y - t, dim=2), 0.0).sum(dim=1)
    return t, s2_new, move / torch.clamp_min(v_count, 1.0)


def em_loop_lockstep(st: EmStaging, params: CpdParams, iteration: Callable):
    """The tolerance loop of B streams in lockstep, as ``lax.while_loop``
    runs under ``vmap``: it goes on while any stream is active (not yet
    converged and below max_iter); a stream that is not active is frozen by
    select, so its y, σ², iteration count and ``converged`` stay as they
    were. ``iteration(y, sigma2)`` computes one iteration of every stream,
    returning (t, sigma2, delta). Each trip runs one body that writes the
    loop's state (y, σ², it, done, converged) in place into the buffers it
    reads. Eagerly a host ``while`` reads whether any stream is active
    before each trip (one flag crosses to the host); while a CUDA graph is
    being captured the body becomes a conditional WHILE node whose trips
    the card decides (:func:`~trackdlo_tpu_torch.ops.graph_loop.device_while`,
    kernel L), so a replay reads nothing on the host. Returns (y, sigma2,
    iterations int32, converged), each with the leading stream axis."""
    y = st.args[1].clone()
    s2 = st.args[0][:, 0].clone()
    bsz = y.shape[0]
    dev = y.device
    it = torch.zeros(bsz, dtype=torch.int32, device=dev)
    done = torch.zeros(bsz, dtype=torch.bool, device=dev)
    converged = torch.ones(bsz, dtype=torch.bool, device=dev)
    max_iter = params.max_iter

    def trip():
        active = ~done & (it < max_iter)
        t, s2_new, delta = iteration(y, s2)
        new_done = delta < params.tol
        torch.where(active[:, None, None], t, y, out=y)
        torch.where(active, s2_new, s2, out=s2)
        torch.where(active, new_done | (it + 1 < max_iter), converged, out=converged)
        torch.where(active, new_done, done, out=done)
        it.add_(active.to(torch.int32))

    if graph_loop.capturing(dev):
        graph_loop.device_while(done, it, max_iter, trip)
    else:
        while bool((~done & (it < max_iter)).any()):
            trip()
    return y, s2, it, converged


def _solve_qr(a, b):
    """Householder-QR solve (the reference's orthogonal-decomposition
    solve); an exactly zero diagonal of R becomes the smallest normal
    float32, anything larger passes untouched."""
    q, r = torch.linalg.qr(a)
    diag = torch.diagonal(r, dim1=-2, dim2=-1)
    safe = torch.where(diag == 0, torch.full_like(diag, 1.1754944e-38), diag)
    r = r + torch.diag_embed(safe - diag)
    return torch.linalg.solve_triangular(r, q.mT @ b, upper=True)


def _solve_normal_cholesky(a, b):
    ata = a.mT @ a
    atb = a.mT @ b
    # cholesky_ex: the factor of linalg.cholesky without its status check,
    # which reads the card; then cholesky_solve's two triangular solves,
    # written out (cuSOLVER's potrs is not held by a CUDA graph's
    # conditional loop body in every process, PERF.md §6).
    low = torch.linalg.cholesky_ex(ata).L
    y = torch.linalg.solve_triangular(low, atb, upper=False)
    return torch.linalg.solve_triangular(low.mT, y, upper=True)


def _solve_svd(a, b, rcond: float = 1e-12):
    """The SVD min-norm solve with a relative cutoff of ``rcond``."""
    u, s, vh = torch.linalg.svd(a)
    keep = s >= rcond * s[..., :1]
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, 1.0), 0.0)
    return vh.mT @ (s_inv[..., None] * (u.mT @ b))


def _then_update(solve: Callable) -> Callable:
    return lambda a, b, g, y0: y0 + g @ solve(a, b)


# Per solver, the M-step's solve and node update T = Y0 + G·W,
# ``(a, b, g, y0) -> t``. The LU routes take G·W as kernel E takes it
# (B1's ``_exact_dot``; a float32 product puts noise of the order of the
# tolerance into the pre-registration pass, ROADMAP §C fault 1): kernel G
# with its solve in one launch, and ``xla_lu`` as G's plain version on any
# device. The other solvers keep the float32 product of the JAX package's
# XLA route.
_UPDATE = {
    "lu": lambda a, b, g, y0: gauss_jordan_solve_batched(a, b, g, y0)[1],
    "xla_lu": lambda a, b, g, y0: gauss_jordan_solve_batched_plain(a, b, g, y0)[1],
    "lstsq": _then_update(_solve_qr),
    "normal_cholesky": _then_update(_solve_normal_cholesky),
    "svd_lstsq": _then_update(_solve_svd),
}


def _estep_one_stream(scal, y, coord, nm, pv, x, xm, *, two_phase):
    out = fused_estep_packed(scal[0], y[0], coord[0], nm[0], pv[0], x[0], xm[0],
                             two_phase=two_phase)
    return tuple(o[None] for o in out)


def iteration_route(st: EmStaging, params: CpdParams, estep: Callable,
                    axis_name=None) -> Callable:
    """The per-iteration route's iteration ``(y, sigma2) -> (t, sigma2,
    delta)`` for the streams of ``st``: the prototype variants' XLA
    iteration, kernel F (``use_fused_mstep`` without an axis), or the
    E-step ``estep`` with the M-step assembly and the chosen solve."""
    update = _UPDATE[params.solver]
    if _is_prototype(params):
        return lambda y, s2: em_iteration_xla(st, y, s2, params, update, axis_name)
    if params.use_fused_mstep and axis_name is None:
        return lambda y, s2: fused_iteration(st, y, s2, params)
    return lambda y, s2: em_iteration(st, y, s2, params, estep, update, axis_name)


def _per_iteration_single(st: EmStaging, params: CpdParams, return_deltas: bool, axis_name=None):
    """The single-stream per-iteration route (solvers other than ``"lu"``,
    ``return_deltas``, ``use_fused_mstep``, the prototype variants, an
    axis): the lockstep loop over a batch of one, or with ``return_deltas``
    all max_iter iterations unconditionally."""
    st1 = EmStaging(tuple(a[None] for a in st.args), st.kwargs, st.n_count, st.sigma2)
    iteration = iteration_route(st1, params, _estep_one_stream, axis_name)
    if not return_deltas:
        y, s2, it, converged = em_loop_lockstep(st1, params, iteration)
        return y[0], s2[0], it[0], converged[0], None
    y, s2 = st1.args[1], st1.args[0][:, 0]
    deltas = []
    for _ in range(params.max_iter):
        y, s2, delta = iteration(y, s2)
        deltas.append(delta[0])
    dev = y.device
    deltas = torch.stack(deltas) if deltas else torch.zeros(0, dtype=y.dtype, device=dev)
    return (y[0], s2[0], torch.tensor(params.max_iter, dtype=torch.int32, device=dev),
            torch.ones((), dtype=torch.bool, device=dev), deltas)


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
    axis_name: torch.distributed.ProcessGroup | None = None,
    point_min_sq: torch.Tensor | None = None,
    return_deltas: bool = False,
):
    """EM registration of the masked node chain ``y`` (M, 3) to the masked
    cloud ``x`` (N, 3). ``point_min_sq`` (N,), when given, is each point's
    min squared distance to the valid nodes (from the visibility pass) and
    requires ``sigma2 > 0``. With ``return_deltas`` every one of the
    max_iter iterations runs and the result is ``(CpdResult, deltas
    (max_iter,))``, each iteration's mean node move.

    ``axis_name``: the process group of the point axis (the JAX package's
    mesh axis name), or ``None``. Under a group, ``x``, ``x_mask`` and
    ``point_min_sq`` are this rank's shard of the cloud, every other
    argument is the same on every rank of the group, and so is the
    result; every rank of the group must make the call."""
    _check_params(params)
    st = em_staging(x, x_mask, y, node_mask, sigma2, params, prior_pos, prior_mask,
                    visible_count, point_min_sq, axis_name)
    deltas = None
    if (axis_name is None and params.solver == "lu" and not return_deltas
            and not params.use_fused_mstep and not _is_prototype(params)):
        y_out, stats = fused_em_loop(*st.args, **st.kwargs)
        s2_out, iters, converged = stats[0], stats[1].to(torch.int32), stats[2] > 0
    else:
        y_out, s2_out, iters, converged, deltas = _per_iteration_single(
            st, params, return_deltas, axis_name)
    # Degenerate input: no valid point at all leaves the state unchanged.
    any_points = st.n_count > 0
    res = CpdResult(
        y=torch.where(any_points, y_out, y),
        sigma2=torch.where(any_points, s2_out, st.sigma2),
        converged=converged,
        iterations=iters,
    )
    return (res, deltas) if return_deltas else res


def cpd_lle_batched(
    x: torch.Tensor,
    x_mask: torch.Tensor,
    y: torch.Tensor,
    node_mask: torch.Tensor,
    sigma2: torch.Tensor,
    params: CpdParams,
    prior_pos: torch.Tensor | None = None,
    prior_mask: torch.Tensor | None = None,
    visible_count: torch.Tensor | None = None,
    point_min_sq: torch.Tensor | None = None,
    axis_name: torch.distributed.ProcessGroup | None = None,
) -> CpdResult:
    """:func:`cpd_lle` of B streams, every argument and result with a
    leading stream axis (the counterpart of ``jax.vmap(cpd_lle)``). B ≥ 2
    runs the lockstep per-iteration loop (batched E-step, batched
    Gauss-Jordan solve; solver ``"lu"``, or the named solver for the
    diagnostic ones; kernel F for all streams with ``use_fused_mstep`` and
    no axis; the XLA iteration for the prototype variants); B = 1 is
    :func:`cpd_lle` (kernel E on its route; the per-iteration loop under an
    axis), as the JAX package's axis-size-1 rule is. ``axis_name`` as for
    :func:`cpd_lle`: every rank of the group holds the same B streams, each
    with its own shard of their clouds."""
    _check_params(params)
    bsz = y.shape[0]
    if bsz == 1:
        one = lambda a: None if a is None else a[0]
        res = cpd_lle(one(x), one(x_mask), one(y), one(node_mask), one(sigma2), params,
                      one(prior_pos), one(prior_mask), one(visible_count), axis_name,
                      point_min_sq=one(point_min_sq))
        return CpdResult(*(v[None] for v in res))
    st = em_staging(x, x_mask, y, node_mask, sigma2, params, prior_pos, prior_mask,
                    visible_count, point_min_sq, axis_name)
    y_out, s2_out, iters, converged = em_loop_lockstep(
        st, params, iteration_route(st, params, fused_estep_packed_batch, axis_name)
    )
    any_points = st.n_count > 0
    return CpdResult(
        y=torch.where(any_points[:, None, None], y_out, y),
        sigma2=torch.where(any_points, s2_out, st.sigma2),
        converged=converged,
        iterations=iters,
    )
