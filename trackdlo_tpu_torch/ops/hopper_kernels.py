"""The EM-loop and prior-walk kernels, each beside its plain PyTorch version.

Counterpart of trackdlo_tpu/ops/pallas_kernels.py for the two of its
kernels on the main path: ``fused_em_loop`` (kernel E, csrc/em_loop.cu) and
``pursuit_walks_fused`` (kernel W, csrc/walks.cu).

A wrapper takes its plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel (or raises).
"""

from __future__ import annotations

import torch

from trackdlo_tpu_torch import _build
from trackdlo_tpu_torch.ops.kernels import pairwise_sq_dists

_BIG = 1e5
_TWO_PI = 6.283185307179586
_F32 = torch.float32


# ---------------------------------------------------------------------------
# Kernel E: the whole tolerance EM loop of one registration pass.
# ---------------------------------------------------------------------------


def _select_rows(vals: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """vals[idx[j], j] per column, 0 where idx is outside [0, rows)."""
    rows = vals.shape[0]
    inside = (idx >= 0) & (idx < rows)
    got = vals.gather(0, idx.clamp(0, rows - 1)[None, :])[0]
    return torch.where(inside, got, torch.zeros_like(got))


def fused_em_loop_plain(
    dyn, y0, coord, nm, g, hg, hy0, jg, pd, x, xm, *,
    muf: float, k_vis: float, tau_vis: float, lam: float, coef_lle: float,
    alpha: float, tol: float, max_iter: int,
):
    """The EM loop in plain tensor ops; same inputs and outputs as
    :func:`fused_em_loop`. The M-step is a direct solve. Iterations after
    convergence are computed but frozen out, so nothing is read back to the
    host (on the CPU the loop stops at convergence)."""
    m = y0.shape[0]
    dt, dev = y0.dtype, y0.device
    zero = torch.zeros((), dtype=dt, device=dev)
    s2 = dyn[0]
    v_count = dyn[1]
    n_safe = dyn[2]
    gate = dyn[3] > 0
    kc_v = muf * v_count / n_safe
    kc_n = muf / n_safe
    vcf = torch.clamp_min(v_count, 1.0)
    vi = v_count.to(torch.int64)
    node = nm > 0
    pair = node[:, None] & (xm > 0)[None, :]
    pair_nodes = node[:, None] & node[None, :]
    eye = torch.eye(m, dtype=dt, device=dev)
    rows = torch.arange(m, device=dev)[:, None]
    xsq = x[:, 0] * x[:, 0] + x[:, 1] * x[:, 1] + x[:, 2] * x[:, 2]

    y = y0.clone()
    it = torch.zeros((), dtype=torch.int64, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    converged = torch.ones((), dtype=torch.bool, device=dev)
    delta_out = zero.clone()
    for _ in range(max_iter):
        active = ~done
        tps = _TWO_PI * s2
        c_core = tps * torch.sqrt(tps)
        c_plain = kc_v * c_core
        c_vis = kc_n * c_core
        sq = pairwise_sq_dists(y, x)  # (m, n)

        shortest = torch.sqrt(torch.where(pair, sq, _BIG).amin(dim=1))
        shortest = torch.where(shortest <= tau_vis, zero, shortest)
        pv = torch.where(node, torch.exp(-k_vis * shortest), zero)
        pv = pv / torch.clamp_min(pv.sum(), 1e-30)

        e = torch.where(pair, torch.exp(-0.5 * sq / s2), zero)
        q = e / (e.sum(dim=0, keepdim=True) + c_plain)
        masked = torch.where(pair, q, -1.0)
        mx = masked.amax(dim=0, keepdim=True)
        mp = torch.where(masked == mx, rows, m).amin(dim=0)
        cand1 = torch.where(mp - 1 == -1, 2, mp - 1)
        cand2 = torch.where(mp + 1 == vi, vi - 3, mp + 1)
        nxt = torch.where(_select_rows(sq, cand1) < _select_rows(sq, cand2), cand1, cand2)
        lo = torch.minimum(mp, nxt)
        hi = torch.maximum(mp, nxt)
        d_lo = torch.sqrt(_select_rows(sq, lo))
        d_hi = torch.sqrt(_select_rows(sq, hi))
        coord_b = coord[:, None].expand_as(sq)
        c_lo = _select_rows(coord_b, lo)
        c_hi = _select_rows(coord_b, hi)
        below = torch.abs(coord[:, None] - c_lo[None, :]) + d_lo[None, :]
        above = torch.abs(coord[:, None] - c_hi[None, :]) + d_hi[None, :]
        geo = torch.where(
            rows < lo[None, :], below * below,
            torch.where(rows >= hi[None, :], above * above,
                        torch.where(rows == lo[None, :], (d_lo * d_lo)[None, :], zero)),
        )
        e2 = torch.where(pair, torch.exp(-0.5 * geo / s2), zero)
        e2 = torch.where(gate, e2 * pv[:, None], e2)
        c_eff = torch.where(gate, c_vis, c_plain)
        p = e2 / (e2.sum(dim=0, keepdim=True) + c_eff)
        p = torch.where(pair, p, zero)

        p1 = p.sum(dim=1)
        px = p @ x
        pt1 = p.sum(dim=0)
        np_total = pt1.sum()
        tr_x = (pt1 * xsq).sum()

        a = p1[:, None] * g + (lam * s2) * eye
        a = a + (s2 * coef_lle) * hg
        a = a + alpha * jg
        b = px - p1[:, None] * y0
        b = b - (s2 * coef_lle) * hy0
        b = b + alpha * pd
        a = torch.where(pair_nodes, a, eye)
        b = torch.where(node[:, None], b, zero)
        w = torch.linalg.solve(a, b)
        t = torch.where(node[:, None], y0 + g @ w, y0)

        tr_pxt = (px * t).sum()
        tr_tt = (p1[:, None] * t * t).sum()
        s2_new = torch.clamp_min(
            (tr_x - 2.0 * tr_pxt + tr_tt) / torch.clamp_min(np_total * 3.0, 1e-30), 1e-10
        )
        dm = t - y
        move = (torch.sqrt(dm[:, 0] * dm[:, 0] + dm[:, 1] * dm[:, 1] + dm[:, 2] * dm[:, 2]) * nm).sum()
        delta = move / vcf
        new_done = delta < tol

        y = torch.where(active, t, y)
        s2 = torch.where(active, s2_new, s2)
        delta_out = torch.where(active, delta, delta_out)
        converged = torch.where(active, new_done | (it + 1 < max_iter), converged)
        it = it + active.to(torch.int64)
        done = done | new_done
        if dev.type == "cpu" and bool(done):
            break
    stats = torch.stack([s2, it.to(dt), converged.to(dt), delta_out])
    return y, stats


def fused_em_loop(
    dyn, y0, coord, nm, g, hg, hy0, jg, pd, x, xm, *,
    muf: float, k_vis: float, tau_vis: float, lam: float, coef_lle: float,
    alpha: float, tol: float, max_iter: int,
):
    """The whole tolerance EM loop of one pass in one launch.

    ``dyn`` (4,) device values: sigma2, v_count, n_safe, visibility gate.
    ``y0`` (m, 3) EM origin and first iterate; ``coord``/``nm`` (m,)
    geodesic coordinates and 0/1 node mask; ``g``/``hg``/``jg`` (m, m);
    ``hy0``/``pd`` (m, 3) (zeros where unused); ``x`` (n, 3), ``xm`` (n,) 0/1.
    Returns (y (m, 3), stats (4,) = sigma2, iterations, converged, delta)."""
    kw = dict(muf=muf, k_vis=k_vis, tau_vis=tau_vis, lam=lam, coef_lle=coef_lle,
              alpha=alpha, tol=tol, max_iter=max_iter)
    args = dict(dyn=dyn, y0=y0, coord=coord, nm=nm, g=g, hg=hg, hy0=hy0, jg=jg,
                pd=pd, x=x, xm=xm)
    if y0.device.type == "cpu":
        return fused_em_loop_plain(*args.values(), **kw)
    dev = _build.require_cuda("fused_em_loop", args)
    m, n = y0.shape[0], x.shape[0]
    if not 1 <= m <= 48:
        raise ValueError(f"fused_em_loop: m={m} outside [1, 48]")
    y_out = torch.empty((m, 3), dtype=_F32, device=dev)
    stats = torch.empty((4,), dtype=_F32, device=dev)
    code = _build.lib().trackdlo_em_loop(
        *(t.data_ptr() for t in args.values()), m, n,
        muf, k_vis, tau_vis, lam, coef_lle, alpha, tol, int(max_iter),
        y_out.data_ptr(), stats.data_ptr(), _build.stream_ptr(dev),
    )
    _build.check(code, "trackdlo_em_loop")
    _build.count_launch("em_loop")
    return y_out, stats


# ---------------------------------------------------------------------------
# Kernel W: the pure-pursuit prior walks.
# ---------------------------------------------------------------------------


def _norm3(d: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2])


def pursuit_walks_plain(guides, seglens, ints, eps: float = 1e-4):
    """All walks as one batched tensor loop; same contract as
    :func:`pursuit_walks`."""
    n_w, m, _ = guides.shape
    dev, dt = guides.device, guides.dtype
    n_seg = m - 1
    start_guide, seg_hi, outer_hi, start_node, count = ints.to(torch.int64).unbind(1)
    a = guides[:, :-1]
    b = guides[:, 1:]
    ab = b - a
    qa = ab[..., 0] * ab[..., 0] + ab[..., 1] * ab[..., 1] + ab[..., 2] * ab[..., 2]
    lo = torch.minimum(a, b) - eps
    hi = torch.maximum(a, b) + eps
    seg = torch.arange(n_seg, device=dev)[None, :]
    seg_exists = seg < (count - 1)[:, None]
    widx = torch.arange(n_w, device=dev)
    nodes = torch.arange(m, device=dev)[None, :]

    anchor = guides[widx, start_guide.clamp(0, m - 1)]
    center = anchor
    last = start_guide
    node_pos = start_node
    alive = torch.ones(n_w, dtype=torch.bool, device=dev)
    at = nodes == start_node[:, None]
    pos = torch.where(at[..., None], anchor[:, None, :], torch.zeros((), dtype=dt, device=dev))
    valid = at
    qa_safe = torch.where(qa == 0, 1.0, qa)

    def between(p):
        return ((p >= lo) & (p <= hi)).all(dim=-1)

    for _ in range(m - 1):
        alive_t = alive & (last <= outer_hi) & (node_pos + 1 <= m - 1)
        look = seglens.gather(1, node_pos.clamp(0, m - 2)[:, None])[:, 0]
        ca = a - center[:, None, :]
        qb = 2.0 * (ab[..., 0] * ca[..., 0] + ab[..., 1] * ca[..., 1] + ab[..., 2] * ca[..., 2])
        qc = (ca[..., 0] * ca[..., 0] + ca[..., 1] * ca[..., 1] + ca[..., 2] * ca[..., 2]) - (look * look)[:, None]
        delta = qb * qb - 4.0 * qa * qc
        sq = torch.sqrt(torch.clamp_min(delta, 0.0))
        d1 = (-qb + sq) / (2.0 * qa_safe)
        d2 = (-qb - sq) / (2.0 * qa_safe)
        p1 = a + d1[..., None] * ab
        p2 = a + d2[..., None] * ab
        v1 = (delta >= 0) & between(p1) & (qa > 0)
        v2 = (delta > 0) & between(p2) & (qa > 0)
        cnt = v1.to(torch.int32) + v2.to(torch.int32)
        d1b = _norm3(p1 - b)
        d2b = _norm3(p2 - b)
        dcb = _norm3(center[:, None, :] - b)
        d_single = torch.where(v1, d1b, d2b)
        acceptable = (cnt == 2) | ((cnt == 1) & (d_single <= dcb))
        chosen = torch.where(
            (cnt == 2)[..., None],
            torch.where((d1b <= d2b)[..., None], p1, p2),
            torch.where(v1[..., None], p1, p2),
        )
        ok = acceptable & (seg >= last[:, None]) & (seg <= seg_hi[:, None]) & seg_exists
        first = torch.where(ok, seg, n_seg).amin(dim=1)
        found = first < n_seg
        eff = alive_t & found
        pick = chosen.gather(1, first.clamp(max=n_seg - 1)[:, None, None].expand(n_w, 1, 3))[:, 0]
        center = torch.where(eff[:, None], pick, center)
        last = torch.where(eff, first, last)
        node_pos = node_pos + eff.to(torch.int64)
        at = (nodes == node_pos[:, None]) & eff[:, None]
        pos = torch.where(at[..., None], center[:, None, :], pos)
        valid = valid | at
        alive = alive & found
    return pos, valid


def pursuit_walks(guides, seglens, ints, eps: float = 1e-4):
    """The prior walks, one warp each.

    ``guides`` (W, M, 3) walk-space guide polylines, ``seglens`` (W, M-1)
    look-ahead per node position, ``ints`` (W, 5) int32 rows of
    (start_guide, seg_hi, outer_hi, start_node, count). Returns
    (pos (W, M, 3) float32, valid (W, M) bool)."""
    if guides.device.type == "cpu":
        return pursuit_walks_plain(guides, seglens, ints, eps)
    dev = _build.require_cuda(
        "pursuit_walks", dict(guides=guides, seglens=seglens, ints=ints),
        dict(ints=torch.int32),
    )
    n_w, m, _ = guides.shape
    if not 2 <= m <= 65:
        raise ValueError(f"pursuit_walks: m={m} outside [2, 65]")
    pos = torch.empty((n_w, m, 3), dtype=_F32, device=dev)
    valid = torch.empty((n_w, m), dtype=torch.uint8, device=dev)
    code = _build.lib().trackdlo_walks(
        guides.data_ptr(), seglens.data_ptr(), ints.data_ptr(), n_w, m, float(eps),
        pos.data_ptr(), valid.data_ptr(), _build.stream_ptr(dev),
    )
    _build.check(code, "trackdlo_walks")
    _build.count_launch("walks")
    return pos, valid.bool()

