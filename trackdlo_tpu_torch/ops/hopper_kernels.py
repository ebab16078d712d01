"""The EM and prior-walk kernels, each beside its plain PyTorch version.

Counterpart of trackdlo_tpu/ops/pallas_kernels.py for its kernels:
``fused_em_loop`` (kernel E, csrc/em_loop.cu), ``pursuit_walks_fused``
(kernel W, csrc/walks.cu), ``fused_estep_packed_batch`` and
``fused_estep_packed`` (kernel S, csrc/estep.cu, launched for B streams or
for one), ``gauss_jordan_solve_batched`` (kernel G, csrc/gj_solve.cu),
``fused_em_iteration`` (kernel F, csrc/em_iter.cu) and ``nearest_point_sq``
(kernel N, csrc/nearest.cu).

A wrapper takes its plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel, at any node count from :data:`NODE_MIN` up
(:data:`NODE_BUILDS`: a narrow and a wide build with a node bound fixed at
compile time, then the node-unbounded build) and any row count, or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from trackdlo_tpu_torch import _build
from trackdlo_tpu_torch.ops.kernels import exact_split_matmul, pairwise_sq_dists

_BIG = 1e5
_TWO_PI = 6.283185307179586
_F32 = torch.float32

# Each kernel's builds on the card, by the most nodes each takes (None: any
# number); a launch takes the first build that takes m. E, S, G and F are
# compiled for at most 48 and at most 128 nodes (EC_MMAX and EC_MMAX_WIDE,
# csrc/estep_cluster.cuh; GJ_MMAX and GJ_MMAX_WIDE, csrc/gj.cuh); N keeps one
# node a thread up to 128 (csrc/nearest.cu); V is compiled for 64 and 128
# nodes (one or two 64-bit words a node mask, csrc/visibility.cu); W for 65
# and 129 guides (two or four segments a lane, csrc/walks.cu). Past those,
# each runs its node-unbounded build (csrc/unbounded.cuh for E, S, G and F:
# the node arrays and the M-step system in a global workspace).
NODE_BUILDS = {"em_loop": (48, 128, None), "estep": (48, 128, None),
               "estep_batch": (48, 128, None), "gj_solve": (48, 128, None),
               "em_iteration": (48, 128, None), "nearest": (128, None),
               "visibility": (64, 128, None), "walks": (65, 129, None)}
# The fewest nodes each kernel takes (V and W need an edge).
NODE_MIN = {**dict.fromkeys(NODE_BUILDS, 1), "visibility": 2, "walks": 2}


def node_build(name: str, m: int) -> int:
    """The index in ``NODE_BUILDS[name]`` of the build that a launch of
    kernel ``name`` (a launch counter's name) takes for ``m`` nodes."""
    return next(i for i, top in enumerate(NODE_BUILDS[name]) if top is None or m <= top)


def unbounded(name: str, m: int) -> bool:
    """Whether ``m`` nodes take kernel ``name``'s node-unbounded build."""
    return NODE_BUILDS[name][node_build(name, m)] is None


def check_nodes(fn: str, name: str, m: int) -> None:
    """Raise unless kernel ``name`` (a launch counter's name) takes ``m``
    nodes on the card; ``fn`` names the wrapper in the message."""
    if m < NODE_MIN[name]:
        raise ValueError(f"{fn}: m={m} below {NODE_MIN[name]}")


# Kernels E, S and F run one E-step over a thread-block cluster
# (csrc/estep_cluster.cuh): one CTA per 256 rows, 1 to 8 CTAs, each holding
# 2048 compacted rows at a time (a CTA with more takes them a tile at a
# time). Their unbounded builds always run 8 CTAs.
_CLUSTER_ROWS, _CLUSTER_MAX = 256, 8


def cluster_shape(n: int, m: int = 45) -> tuple[int, int]:
    """(CTAs per cluster, rows per CTA) of kernels E, S and F for ``n`` rows
    and ``m`` nodes: a function of ``n`` (and of whether ``m`` takes the
    unbounded build) alone, so a stream's result depends neither on the
    batch it is launched in nor on the card (csrc/estep_cluster.cuh,
    csrc/unbounded.cuh)."""
    if unbounded("em_loop", m):
        return _CLUSTER_MAX, -(-n // _CLUSTER_MAX)
    c = min(max(-(-n // _CLUSTER_ROWS), 1), _CLUSTER_MAX)
    return c, -(-n // c)


@functools.lru_cache(maxsize=None)
def _workspace_bytes(kernel: str, n_streams: int, m: int, n: int) -> int:
    out = ctypes.c_longlong()
    fn = getattr(_build.lib(), f"trackdlo_{kernel}_workspace")
    _build.check(fn(int(n_streams), int(m), int(n), ctypes.addressof(out)),
                 f"trackdlo_{kernel}_workspace")
    return out.value


def workspace(kernel: str, n_streams: int, m: int, n: int, device) -> torch.Tensor:
    """The global workspace of an unbounded launch of kernel ``kernel``
    (``"em_loop"``, ``"estep"``, ``"gj_solve"``, ``"em_iter"`` or
    ``"visibility"``; its node-indexed arrays and, for E, G and F, the
    M-step system): one allocation on ``device``, in a CUDA graph's pool
    when captured."""
    return torch.empty(_workspace_bytes(kernel, n_streams, m, n), dtype=torch.uint8,
                       device=device)


def cluster_info(kernel: str, n: int, m: int = 45) -> dict:
    """Kernel E's (``"em_loop"``), S's (``"estep"``) or F's (``"em_iter"``)
    cluster launch for ``n`` rows and ``m`` nodes on the current card: the
    cluster size, the rows per CTA, how many such clusters the card can hold
    at once and a CTA's shared memory in bytes (of the build for ``m``)."""
    out = (ctypes.c_int * 4)()
    fn = getattr(_build.lib(), f"trackdlo_{kernel}_cluster_info")
    _build.check(fn(int(n), int(m), ctypes.addressof(out)), f"trackdlo_{kernel}_cluster_info")
    return {"cluster_size": out[0], "rows_per_cta": out[1], "max_active_clusters": out[2],
            "smem_bytes": out[3]}


# ---------------------------------------------------------------------------
# Kernel E: the whole tolerance EM loop of one registration pass.
# ---------------------------------------------------------------------------


def _select_rows(vals: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """vals[idx[j], j] per column, 0 where idx is outside [0, rows)."""
    rows = vals.shape[0]
    inside = (idx >= 0) & (idx < rows)
    got = vals.gather(0, idx.clamp(0, rows - 1)[None, :])[0]
    return torch.where(inside, got, torch.zeros_like(got))


class EmPhasesPlain:
    """One EM iteration of :func:`fused_em_loop` in plain tensor ops, phase
    by phase, on the loop's inputs: ``estep`` (y, σ²) → P1, PX, Np,
    tr(X^T dPt1 X); ``mstep`` (P1, PX, σ²) → the system A, B; the direct
    solve; ``update`` (W) → T; ``sigma2`` → the next σ² and the mean node
    move. :func:`fused_em_loop_plain` chains them; a probe can feed each
    phase another route's inputs."""

    def __init__(self, dyn, y0, coord, nm, g, hg, hy0, jg, pd, x, xm, *,
                 muf: float, k_vis: float, tau_vis: float, lam: float, coef_lle: float,
                 alpha: float):
        m = y0.shape[0]
        dt, dev = y0.dtype, y0.device
        self.zero = torch.zeros((), dtype=dt, device=dev)
        self.y0, self.coord, self.nm, self.g, self.hg, self.hy0, self.jg, self.pd, self.x = (
            y0, coord, nm, g, hg, hy0, jg, pd, x)
        self.k_vis, self.tau_vis, self.lam, self.coef_lle, self.alpha = (
            k_vis, tau_vis, lam, coef_lle, alpha)
        v_count = dyn[1]
        n_safe = dyn[2]
        self.gate = dyn[3] > 0
        self.kc_v = muf * v_count / n_safe
        self.kc_n = muf / n_safe
        self.vcf = torch.clamp_min(v_count, 1.0)
        self.vi = v_count.to(torch.int64)
        self.node = nm > 0
        self.pair = self.node[:, None] & (xm > 0)[None, :]
        self.pair_nodes = self.node[:, None] & self.node[None, :]
        self.eye = torch.eye(m, dtype=dt, device=dev)
        self.rows = torch.arange(m, device=dev)[:, None]
        self.xsq = x[:, 0] * x[:, 0] + x[:, 1] * x[:, 1] + x[:, 2] * x[:, 2]

    def estep(self, y, s2):
        zero, pair, rows, coord, vi = self.zero, self.pair, self.rows, self.coord, self.vi
        m = y.shape[0]
        tps = _TWO_PI * s2
        c_core = tps * torch.sqrt(tps)
        c_plain = self.kc_v * c_core
        c_vis = self.kc_n * c_core
        sq = pairwise_sq_dists(y, self.x)  # (m, n)

        shortest = torch.sqrt(torch.where(pair, sq, _BIG).amin(dim=1))
        shortest = torch.where(shortest <= self.tau_vis, zero, shortest)
        pv = torch.where(self.node, torch.exp(-self.k_vis * shortest), zero)
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
        e2 = torch.where(self.gate, e2 * pv[:, None], e2)
        c_eff = torch.where(self.gate, c_vis, c_plain)
        p = e2 / (e2.sum(dim=0, keepdim=True) + c_eff)
        p = torch.where(pair, p, zero)

        p1 = p.sum(dim=1)
        px = p @ self.x
        pt1 = p.sum(dim=0)
        return p1, px, pt1.sum(), (pt1 * self.xsq).sum()

    def mstep(self, p1, px, s2):
        a = p1[:, None] * self.g + (self.lam * s2) * self.eye
        a = a + (s2 * self.coef_lle) * self.hg
        a = a + self.alpha * self.jg
        b = px - p1[:, None] * self.y0
        b = b - (s2 * self.coef_lle) * self.hy0
        b = b + self.alpha * self.pd
        a = torch.where(self.pair_nodes, a, self.eye)
        b = torch.where(self.node[:, None], b, self.zero)
        return a, b

    def update(self, w):
        return torch.where(self.node[:, None], self.y0 + self.g @ w, self.y0)

    def sigma2(self, t, y, p1, px, np_total, tr_x):
        tr_pxt = (px * t).sum()
        tr_tt = (p1[:, None] * t * t).sum()
        s2_new = torch.clamp_min(
            (tr_x - 2.0 * tr_pxt + tr_tt) / torch.clamp_min(np_total * 3.0, 1e-30), 1e-10
        )
        dm = t - y
        move = (torch.sqrt(dm[:, 0] * dm[:, 0] + dm[:, 1] * dm[:, 1] + dm[:, 2] * dm[:, 2])
                * self.nm).sum()
        return s2_new, move / self.vcf


def fused_em_loop_plain(
    dyn, y0, coord, nm, g, hg, hy0, jg, pd, x, xm, *,
    muf: float, k_vis: float, tau_vis: float, lam: float, coef_lle: float,
    alpha: float, tol: float, max_iter: int,
):
    """The EM loop in plain tensor ops; same inputs and outputs as
    :func:`fused_em_loop`. The M-step is a direct solve (``solve_ex`` with
    its error check off: ``torch.linalg.solve``'s routine and values, without
    the host read of its status on the card). Iterations after convergence
    are computed but frozen out, so nothing is read back to the host (on the
    CPU the loop stops at convergence)."""
    ph = EmPhasesPlain(dyn, y0, coord, nm, g, hg, hy0, jg, pd, x, xm, muf=muf, k_vis=k_vis,
                       tau_vis=tau_vis, lam=lam, coef_lle=coef_lle, alpha=alpha)
    dev = y0.device
    s2 = dyn[0]
    y = y0.clone()
    it = torch.zeros((), dtype=torch.int64, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    converged = torch.ones((), dtype=torch.bool, device=dev)
    delta_out = ph.zero.clone()
    for _ in range(max_iter):
        active = ~done
        p1, px, np_total, tr_x = ph.estep(y, s2)
        a, b = ph.mstep(p1, px, s2)
        t = ph.update(torch.linalg.solve_ex(a, b)[0])
        s2_new, delta = ph.sigma2(t, y, p1, px, np_total, tr_x)
        new_done = delta < tol

        y = torch.where(active, t, y)
        s2 = torch.where(active, s2_new, s2)
        delta_out = torch.where(active, delta, delta_out)
        converged = torch.where(active, new_done | (it + 1 < max_iter), converged)
        it = it + active.to(torch.int64)
        done = done | new_done
        if dev.type == "cpu" and bool(done):
            break
    stats = torch.stack([s2, it.to(y0.dtype), converged.to(y0.dtype), delta_out])
    return y, stats


def fused_em_loop(
    dyn, y0, coord, nm, g, hg, hy0, jg, pd, x, xm, *,
    muf: float, k_vis: float, tau_vis: float, lam: float, coef_lle: float,
    alpha: float, tol: float, max_iter: int,
):
    """The whole tolerance EM loop of one pass in one launch (kernel E, one
    thread-block cluster of :func:`cluster_shape` CTAs).

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
    check_nodes("fused_em_loop", "em_loop", m)
    y_out = torch.empty((m, 3), dtype=_F32, device=dev)
    stats = torch.empty((4,), dtype=_F32, device=dev)
    call = (*(t.data_ptr() for t in args.values()), m, n,
            muf, k_vis, tau_vis, lam, coef_lle, alpha, tol, int(max_iter),
            y_out.data_ptr(), stats.data_ptr())
    if unbounded("em_loop", m):
        ws = workspace("em_loop", 1, m, n, dev)
        code = _build.lib().trackdlo_em_loop_ub(*call, ws.data_ptr(), _build.stream_ptr(dev))
    else:
        code = _build.lib().trackdlo_em_loop(*call, _build.stream_ptr(dev))
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


def alloc_walks_out(n_w: int, m: int, device):
    """Kernel W's outputs in their final dtypes: pos (W, M, 3) float32 and
    valid (W, M) bool, whose one-byte storage the kernel writes as 0/1 (no
    cast after the launch)."""
    return (torch.empty((n_w, m, 3), dtype=_F32, device=device),
            torch.empty((n_w, m), dtype=torch.bool, device=device))


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
    check_nodes("pursuit_walks", "walks", m)
    pos, valid = alloc_walks_out(n_w, m, dev)
    code = _build.lib().trackdlo_walks(
        guides.data_ptr(), seglens.data_ptr(), ints.data_ptr(), n_w, m, float(eps),
        pos.data_ptr(), valid.data_ptr(), _build.stream_ptr(dev),
    )
    _build.check(code, "trackdlo_walks")
    _build.count_launch("walks")
    return pos, valid


# ---------------------------------------------------------------------------
# Kernel S: the streamed E-step of B streams (B6 unbatched, B7 batched).
# ---------------------------------------------------------------------------


def fused_estep_packed_batch_plain(scal, y, coord, nm, pv, x, xm, *, two_phase: bool):
    """The batched E-step in plain tensor ops; same contract as
    :func:`fused_estep_packed_batch`. Rows are padded to a multiple of 8
    with zero rows, as the TPU kernel's are: the anchor row select reads
    them (and gives 0 outside them)."""
    return _estep_batch_plain(scal, y, coord, nm, pv, x, xm, two_phase,
                              lambda sq, s2: sq * (-0.5 / s2))


def _estep_batch_plain(scal, y, coord, nm, pv, x, xm, two_phase, exponent):
    """The batched E-step; ``exponent(sq, s2)`` is the argument of each
    membership's exponential, in the operation order of the TPU kernel being
    replaced."""
    bsz, m, _ = y.shape
    dt, dev = y.dtype, y.device
    m_pad = (m + 7) // 8 * 8
    zero = torch.zeros((), dtype=dt, device=dev)
    pad = m_pad - m
    if pad:
        y = torch.nn.functional.pad(y, (0, 0, 0, pad))
        coord, nm, pv = (torch.nn.functional.pad(a, (0, pad)) for a in (coord, nm, pv))
    s2, c_plain, c_vis, gate, v_count, k_vis, tau_vis = (
        scal[:, k, None, None] for k in range(7)
    )
    vi = v_count.to(torch.int64)
    node = (nm > 0)[:, :, None]
    pair = node & (xm > 0)[:, None, :]
    d = y[:, :, None, :] - x[:, None, :, :]
    sq = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]  # (B, m_pad, n)

    short = torch.full((bsz, m_pad), _BIG, dtype=dt, device=dev)
    if two_phase:
        if bool((scal[:, 3] > 0).any()):
            short = torch.where(pair, sq, _BIG).amin(dim=2)
        shortest = torch.sqrt(short)
        shortest = torch.where(shortest <= tau_vis[:, :, 0], zero, shortest)
        pv = torch.where(nm > 0, torch.exp(-k_vis[:, :, 0] * shortest), zero)
        pv = pv / torch.clamp_min(pv.sum(dim=1, keepdim=True), 1e-30)

    p = torch.where(pair, torch.exp(exponent(sq, s2)), zero)
    p = p / (p.sum(dim=1, keepdim=True) + c_plain)
    rows = torch.arange(m_pad, device=dev)[None, :, None]
    masked = torch.where(pair, p, -1.0)
    mx = masked.amax(dim=1, keepdim=True)
    mp = torch.where(masked == mx, rows, m_pad).amin(dim=1)  # (B, n)

    def select(vals, idx):  # vals (B, m_pad, n), idx (B, n): 0 outside [0, m_pad)
        inside = (idx >= 0) & (idx < m_pad)
        got = vals.gather(1, idx.clamp(0, m_pad - 1)[:, None, :])[:, 0]
        return torch.where(inside, got, zero)

    v2 = vi[:, :, 0]
    cand1 = torch.where(mp - 1 == -1, 2, mp - 1)
    cand2 = torch.where(mp + 1 == v2, v2 - 3, mp + 1)
    nxt = torch.where(select(sq, cand1) < select(sq, cand2), cand1, cand2)
    lo = torch.minimum(mp, nxt)
    hi = torch.maximum(mp, nxt)
    d_lo = torch.sqrt(select(sq, lo))
    d_hi = torch.sqrt(select(sq, hi))
    coord_b = coord[:, :, None].expand_as(sq)
    c_lo = select(coord_b, lo)
    c_hi = select(coord_b, hi)
    below = torch.abs(coord[:, :, None] - c_lo[:, None, :]) + d_lo[:, None, :]
    above = torch.abs(coord[:, :, None] - c_hi[:, None, :]) + d_hi[:, None, :]
    lo_b, hi_b = lo[:, None, :], hi[:, None, :]
    geo = torch.where(
        rows < lo_b, below * below,
        torch.where(rows >= hi_b, above * above,
                    torch.where(rows == lo_b, (d_lo * d_lo)[:, None, :], zero)),
    )
    p = torch.where(pair, torch.exp(exponent(geo, s2)), zero)
    p = p * (1.0 + gate * (pv[:, :, None] - 1.0))
    c_eff = c_plain + gate * (c_vis - c_plain)
    p = p / (p.sum(dim=1, keepdim=True) + c_eff)
    p = torch.where(pair, p, zero)

    p1 = p.sum(dim=2)
    px = torch.stack([(p * x[:, None, :, k]).sum(dim=2) for k in range(3)], dim=-1)
    pt1 = p.sum(dim=1)
    xsq = x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1] + x[..., 2] * x[..., 2]
    stats = torch.stack([pt1.sum(dim=1), (pt1 * xsq).sum(dim=1)], dim=-1)
    return p1[:, :m], px[:, :m], stats, short[:, :m]


def _estep_launch(name, scal, y, coord, nm, pv, x, xm, two_phase):
    dev = _build.require_cuda(
        name, dict(scal=scal, y=y, coord=coord, nm=nm, pv=pv, x=x, xm=xm)
    )
    bsz, m, _ = y.shape
    n = x.shape[1]
    check_nodes(name, "estep", m)
    if tuple(scal.shape) != (bsz, 8) or tuple(x.shape) != (bsz, n, 3) or tuple(xm.shape) != (bsz, n):
        raise ValueError(f"{name}: scal/x/xm shapes do not match y")
    if any(tuple(a.shape) != (bsz, m) for a in (coord, nm, pv)):
        raise ValueError(f"{name}: coord/nm/pv must be ({bsz}, {m})")
    p1 = torch.empty((bsz, m), dtype=_F32, device=dev)
    px = torch.empty((bsz, m, 3), dtype=_F32, device=dev)
    stats = torch.empty((bsz, 2), dtype=_F32, device=dev)
    short = torch.empty((bsz, m), dtype=_F32, device=dev)
    call = (scal.data_ptr(), y.data_ptr(), coord.data_ptr(), nm.data_ptr(), pv.data_ptr(),
            x.data_ptr(), xm.data_ptr(), bsz, m, n, int(bool(two_phase)),
            p1.data_ptr(), px.data_ptr(), stats.data_ptr(), short.data_ptr())
    if unbounded("estep", m):
        ws = workspace("estep", bsz, m, n, dev)
        code = _build.lib().trackdlo_estep_ub(*call, ws.data_ptr(), _build.stream_ptr(dev))
    else:
        code = _build.lib().trackdlo_estep(*call, _build.stream_ptr(dev))
    _build.check(code, "trackdlo_estep")
    return p1, px, stats, short


def fused_estep_packed_batch(scal, y, coord, nm, pv, x, xm, *, two_phase: bool):
    """The E-step of B streams in one launch (kernel S, one thread-block
    cluster of :func:`cluster_shape` CTAs per stream).

    ``scal`` (B, 8) per stream: sigma2, c_plain, c_vis, visibility gate,
    v_count, k_vis, tau_vis, unused; ``y`` (B, m, 3); ``coord``/``nm``/``pv``
    (B, m) geodesic coordinates, 0/1 node mask and, without ``two_phase``,
    the visibility weights; ``x`` (B, n, 3) and ``xm`` (B, n) 0/1 points.
    Returns (p1 (B, m), px (B, m, 3), stats (B, 2) = Np, tr(XᵀdPt1X),
    shortest_sq (B, m)). ``shortest_sq`` holds the 1e5 sentinel unless
    ``two_phase`` and some stream's gate is on."""
    if y.device.type == "cpu":
        return fused_estep_packed_batch_plain(scal, y, coord, nm, pv, x, xm, two_phase=two_phase)
    out = _estep_launch("fused_estep_packed_batch", scal, y, coord, nm, pv, x, xm, two_phase)
    _build.count_launch("estep_batch")
    return out


def fused_estep_packed_plain(scal, y, coord, nm, pv, x, xm, *, two_phase: bool):
    """:func:`fused_estep_packed`'s plain version: the batched one for one stream."""
    out = fused_estep_packed_batch_plain(
        scal[None], y[None], coord[None], nm[None], pv[None], x[None], xm[None],
        two_phase=two_phase,
    )
    return tuple(o[0] for o in out)


def fused_estep_packed(scal, y, coord, nm, pv, x, xm, *, two_phase: bool):
    """The E-step of one stream (kernel S launched for one stream): the
    arguments and results of :func:`fused_estep_packed_batch` without the
    stream axis."""
    if y.device.type == "cpu":
        return fused_estep_packed_plain(scal, y, coord, nm, pv, x, xm, two_phase=two_phase)
    out = _estep_launch(
        "fused_estep_packed", *(a.unsqueeze(0) for a in (scal, y, coord, nm, pv, x, xm)), two_phase
    )
    _build.count_launch("estep")
    return tuple(o[0] for o in out)


# ---------------------------------------------------------------------------
# Kernel G: B equilibrated Gauss-Jordan solves.
# ---------------------------------------------------------------------------


def lu_solve_plain(a, b):
    """a w = b by LU with partial pivoting and two triangular solves, the
    algorithm of ``linalg.solve`` (and of the JAX package's
    ``jnp.linalg.solve``), built from the factorisation and the triangular
    solves alone: no status read on the host, and none of cuSOLVER's
    getrs, which a CUDA graph's conditional loop body cannot hold in a
    process that captured other library calls before (PERF.md §6).
    Applying the pivots as a product with the 0/1 permutation is exact."""
    lu, piv, _ = torch.linalg.lu_factor_ex(a)
    perm, lower, upper = torch.lu_unpack(lu, piv)
    y = torch.linalg.solve_triangular(lower, perm.mT @ b, upper=False, unitriangular=True)
    return torch.linalg.solve_triangular(upper, y, upper=True)


def gauss_jordan_solve_batched_plain(a, b, g=None, y0=None):
    """Kernel G's plain version: a direct solve (the JAX package's route off
    the TPU, ``jnp.linalg.solve``; :func:`lu_solve_plain`) and, with ``g``
    and ``y0``, the node update y0 + g w as the kernel takes its product
    (B1's ``_exact_dot``)."""
    w = lu_solve_plain(a, b)
    return w if g is None else (w, y0 + exact_split_matmul(g, w))


def gauss_jordan_solve_batched(a, b, g=None, y0=None):
    """Solve a[i] @ w[i] = b[i] for (B, m, m) ``a`` and (B, m, 3) ``b`` in
    one launch (kernel G): power-of-two row equilibration, Gauss-Jordan with
    partial pivoting, the inverse and three refinement steps (the residual's
    product as B1's ``_exact_dot``). Returns w (B, m, 3); given the EM's
    (B, m, m) ``g`` and (B, m, 3) ``y0``, returns (w, t) with its node update
    t = y0 + g w, the product taken the same way, in the same launch."""
    if a.device.type == "cpu":
        return gauss_jordan_solve_batched_plain(a, b, g, y0)
    tensors = dict(a=a, b=b) if g is None else dict(a=a, b=b, g=g, y0=y0)
    dev = _build.require_cuda("gauss_jordan_solve_batched", tensors)
    n_sys, m, _ = a.shape
    check_nodes("gauss_jordan_solve_batched", "gj_solve", m)
    if tuple(a.shape) != (n_sys, m, m) or tuple(b.shape) != (n_sys, m, 3):
        raise ValueError("gauss_jordan_solve_batched: a must be (B, m, m) and b (B, m, 3)")
    w = torch.empty((n_sys, m, 3), dtype=_F32, device=dev)
    if g is not None and (tuple(g.shape) != (n_sys, m, m) or tuple(y0.shape) != (n_sys, m, 3)):
        raise ValueError("gauss_jordan_solve_batched: g must be (B, m, m) and y0 (B, m, 3)")
    t = None if g is None else torch.empty((n_sys, m, 3), dtype=_F32, device=dev)
    if unbounded("gj_solve", m):
        ws = workspace("gj_solve", n_sys, m, 0, dev)
        ptr = lambda v: None if v is None else v.data_ptr()
        code = _build.lib().trackdlo_gj_solve_ub(
            a.data_ptr(), b.data_ptr(), ptr(g), ptr(y0), n_sys, m, w.data_ptr(), ptr(t),
            ws.data_ptr(), _build.stream_ptr(dev))
    elif g is None:
        code = _build.lib().trackdlo_gj_solve(
            a.data_ptr(), b.data_ptr(), n_sys, m, w.data_ptr(), _build.stream_ptr(dev))
    else:
        code = _build.lib().trackdlo_gj_solve_update(
            a.data_ptr(), b.data_ptr(), g.data_ptr(), y0.data_ptr(), n_sys, m, w.data_ptr(),
            t.data_ptr(), _build.stream_ptr(dev))
    _build.check(code, "trackdlo_gj_solve")
    _build.count_launch("gj_solve")
    return w if g is None else (w, t)


# ---------------------------------------------------------------------------
# Kernel F: one whole EM iteration of B streams with its one-hot M-step solve.
# ---------------------------------------------------------------------------


def onehot_gauss_jordan_plain(a, b):
    """Kernel F's solve in plain tensor ops: the TPU's one-hot Gauss-Jordan
    elimination of (B, m, m) ``a`` with (B, m, 3) ``b``. No equilibration;
    at step k the pivot is the first maximum of |a[:, k]| over the rows not
    yet used (used rows bid -1), every other row is eliminated without row
    swaps, and w[k] = b[perm k] / pivot_k with |pivot| < 1e-30 read as 1."""
    bsz, m, _ = a.shape
    aug = torch.cat([a, b], dim=-1)
    rows = torch.arange(m, device=a.device)
    used = torch.zeros((bsz, m), dtype=torch.bool, device=a.device)
    perm = torch.zeros((bsz, m), dtype=torch.int64, device=a.device)
    diag = torch.zeros((bsz, m), dtype=a.dtype, device=a.device)
    for k in range(m):
        col = aug[:, :, k]
        r = torch.where(used, -1.0, col.abs()).argmax(dim=1)  # the first maximum
        pv = col.gather(1, r[:, None])
        onehot = rows[None, :] == r[:, None]
        factor = torch.where(onehot, 0.0, col / torch.where(pv == 0, 1.0, pv))
        pivot_row = aug.gather(1, r[:, None, None].expand(bsz, 1, m + 3))
        aug = aug - factor[:, :, None] * pivot_row
        used = used | onehot
        perm[:, k] = r
        diag[:, k] = pv[:, 0]
    diag = torch.where(diag.abs() < 1e-30, 1.0, diag)
    return aug[..., m:].gather(1, perm[:, :, None].expand(bsz, m, 3)) / diag[:, :, None]


def fused_em_iteration_plain(y, y0, node_mask, node_coord, g, hg, hy0, jg, prior_disp, x,
                             x_mask, sigma2, c_plain, c_vis, vis_gate, v_count, *, k_vis: float,
                             tau_vis: float, lam: float, coef_lle: float, alpha: float):
    """Kernel F's plain version: the same iteration in tensor ops, every
    argument with the leading stream axis of :func:`fused_em_iteration`."""
    bsz, m, _ = y.shape
    nm = node_mask.to(_F32)
    node = nm > 0
    scal = torch.stack([sigma2, c_plain, c_vis, vis_gate.to(_F32), v_count.to(_F32),
                        torch.full_like(sigma2, k_vis), torch.full_like(sigma2, tau_vis),
                        torch.ones_like(sigma2)], dim=1)
    p1, px, stats, _ = _estep_batch_plain(
        scal, y, node_coord, nm, torch.ones_like(nm), x, x_mask.to(_F32), True,
        lambda sq, s2: (-0.5 * sq) / s2,
    )
    s2c = sigma2[:, None, None]
    eye = torch.eye(m, dtype=_F32, device=y.device)
    a = p1[:, :, None] * g + (lam * s2c) * eye
    a = a + (s2c * coef_lle) * hg + alpha * jg
    b = px - p1[:, :, None] * y0
    b = b - (s2c * coef_lle) * hy0 + alpha * prior_disp
    a = torch.where(node[:, :, None] & node[:, None, :], a, eye)
    b = b * nm[:, :, None]
    w = onehot_gauss_jordan_plain(a, b)
    t = torch.where(node[:, :, None], y0 + g @ w, y0)
    tr_pxt = (px * t).sum(dim=(1, 2))
    tr_tt = (p1[:, :, None] * t * t).sum(dim=(1, 2))
    s2_new = (stats[:, 1] - 2.0 * tr_pxt + tr_tt) / torch.clamp_min(stats[:, 0] * 3.0, 1e-30)
    dm = t - y
    move = (torch.sqrt(dm[..., 0] * dm[..., 0] + dm[..., 1] * dm[..., 1] + dm[..., 2] * dm[..., 2])
            * nm).sum(dim=1)
    return t, torch.clamp_min(s2_new, 1e-10), move / torch.clamp_min(v_count.to(_F32), 1.0)


def fused_em_iteration(y, y0, node_mask, node_coord, g, hg, hy0, jg, prior_disp, x, x_mask,
                       sigma2, c_plain, c_vis, vis_gate, v_count, *, k_vis: float = 0.0,
                       tau_vis: float = 0.0, lam: float = 1.0, coef_lle: float = 0.0,
                       alpha: float = 0.0):
    """One whole EM iteration in one launch (kernel F): the per-node minimum
    sweep, the two-phase E-step with the visibility prior and gate, the
    M-step system A = diag(P1)G + λσ²I + σ²·lle·HG + α·JG and its one-hot
    Gauss-Jordan solve, T = Y0 + G·W, the σ² update and the mean node move.

    The arguments of the JAX package's ``fused_em_iteration``: ``y``/``y0``
    (m, 3), ``node_mask``/``node_coord`` (m,), ``g``/``hg``/``jg`` (m, m),
    ``hy0``/``prior_disp`` (m, 3) (zeros where unused), ``x`` (n, 3),
    ``x_mask`` (n,), the scalars ``sigma2``, ``c_plain``, ``c_vis``,
    ``vis_gate`` and ``v_count``. With a leading stream axis on every one
    (scalars (B,)) the B streams take one launch, one thread-block cluster
    each. Returns (t (…, m, 3), sigma2_new (…), delta (…)). The EM's own
    route takes :func:`fused_em_iteration_staged`, which computes the c's
    in the launch."""
    single = y.ndim == 2
    if single:
        y, y0, node_mask, node_coord, g, hg, hy0, jg, prior_disp, x, x_mask = (
            a.unsqueeze(0) for a in (y, y0, node_mask, node_coord, g, hg, hy0, jg, prior_disp,
                                     x, x_mask))
    bsz = y.shape[0]
    dev = y.device
    sigma2, c_plain, c_vis, vis_gate, v_count = (
        torch.as_tensor(v, device=dev).to(_F32).reshape(bsz)
        for v in (sigma2, c_plain, c_vis, vis_gate, v_count))
    kw = dict(k_vis=float(k_vis), tau_vis=float(tau_vis), lam=float(lam),
              coef_lle=float(coef_lle), alpha=float(alpha))
    if dev.type == "cpu":
        out = fused_em_iteration_plain(y, y0, node_mask, node_coord, g, hg, hy0, jg, prior_disp,
                                       x, x_mask, sigma2, c_plain, c_vis, vis_gate, v_count, **kw)
    else:
        dyn = torch.stack([sigma2, v_count, torch.ones_like(sigma2), vis_gate], dim=1)
        out = _em_iteration_launch(
            "fused_em_iteration", sigma2, dyn, torch.stack([c_plain, c_vis], dim=1), y, y0,
            node_mask.to(_F32), node_coord, g, hg, hy0, jg, prior_disp, x, x_mask.to(_F32),
            muf=0.0, **kw)
    return tuple(o[0] for o in out) if single else out


def em_iteration_c(s2, dyn, muf: float):
    """The c's of one iteration from σ² (B,) and the staging's ``dyn``
    (B, 4): (c_plain, c_vis), (2π σ²)^1.5 μ/(1 − μ) times v_count / n_safe
    and over n_safe, in kernel F's (and kernel E's) operation order."""
    tps = _TWO_PI * s2
    c_core = tps * torch.sqrt(tps)
    return (muf * dyn[:, 1] / dyn[:, 2]) * c_core, (muf / dyn[:, 2]) * c_core


def fused_em_iteration_staged(y, s2, dyn, y0, nm, coord, g, hg, hy0, jg, prior_disp, x, xm, *,
                              muf: float, k_vis: float, tau_vis: float, lam: float,
                              coef_lle: float, alpha: float):
    """Kernel F on the EM staging's tensors, the c's computed from ``dyn``
    in the launch (:func:`em_iteration_c`): one device op per iteration.

    ``y`` (B, m, 3); ``s2`` (B,) σ² (any stride); ``dyn`` (B, 4): σ² of the
    origin, v_count, n_safe, the visibility gate; ``nm`` (B, m) and ``xm``
    (B, n) float32 0/1; the rest as :func:`fused_em_iteration`'s, with the
    stream axis; ``muf`` = μ/(1 − μ). Returns (t, sigma2_new, delta)."""
    kw = dict(k_vis=float(k_vis), tau_vis=float(tau_vis), lam=float(lam),
              coef_lle=float(coef_lle), alpha=float(alpha))
    if y.device.type == "cpu":
        c_plain, c_vis = em_iteration_c(s2, dyn, muf)
        return fused_em_iteration_plain(y, y0, nm, coord, g, hg, hy0, jg, prior_disp, x, xm, s2,
                                        c_plain, c_vis, dyn[:, 3], dyn[:, 1], **kw)
    return _em_iteration_launch("fused_em_iteration_staged", s2, dyn, None, y, y0, nm, coord, g,
                                hg, hy0, jg, prior_disp, x, xm, muf=float(muf), **kw)


def _em_iteration_launch(name, s2, dyn, cc, y, y0, nm, coord, g, hg, hy0, jg, pd, x, xm, *,
                         muf, k_vis, tau_vis, lam, coef_lle, alpha):
    args = dict(dyn=dyn, y=y, y0=y0, coord=coord, nm=nm, g=g, hg=hg, hy0=hy0, jg=jg, pd=pd, x=x,
                xm=xm)
    if cc is not None:
        args["cc"] = cc
    args = {k: v.contiguous() for k, v in args.items()}
    dev = _build.require_cuda(name, args)
    bsz, m, _ = y.shape
    n = x.shape[1]
    check_nodes(name, "em_iteration", m)
    shapes = dict(dyn=(bsz, 4), y0=(bsz, m, 3), coord=(bsz, m), nm=(bsz, m), g=(bsz, m, m),
                  hg=(bsz, m, m), hy0=(bsz, m, 3), jg=(bsz, m, m), pd=(bsz, m, 3), x=(bsz, n, 3),
                  xm=(bsz, n), cc=(bsz, 2))
    for k, t in args.items():
        if k != "y" and tuple(t.shape) != shapes[k]:
            raise ValueError(f"{name}: {k} must be {shapes[k]}, got {tuple(t.shape)}")
    if s2.device != dev or s2.dtype != _F32 or tuple(s2.shape) != (bsz,):
        raise ValueError(f"{name}: sigma2 must be a ({bsz},) float32 tensor on {dev}")
    t = torch.empty((bsz, m, 3), dtype=_F32, device=dev)
    stats = torch.empty((bsz, 2), dtype=_F32, device=dev)
    cc_ptr = args["cc"].data_ptr() if cc is not None else None  # null: the c's from dyn
    call = (s2.data_ptr(), s2.stride(0), args["dyn"].data_ptr(), cc_ptr,
            *(args[k].data_ptr() for k in ("y", "y0", "coord", "nm", "g", "hg", "hy0", "jg", "pd",
                                           "x", "xm")),
            bsz, m, n, muf, k_vis, tau_vis, lam, coef_lle, alpha, t.data_ptr(), stats.data_ptr())
    if unbounded("em_iteration", m):
        ws = workspace("em_iter", bsz, m, n, dev)
        code = _build.lib().trackdlo_em_iter_ub(*call, ws.data_ptr(), _build.stream_ptr(dev))
    else:
        code = _build.lib().trackdlo_em_iter(*call, _build.stream_ptr(dev))
    _build.check(code, "trackdlo_em_iter")
    _build.count_launch("em_iteration")
    return t, stats[:, 0], stats[:, 1]


# ---------------------------------------------------------------------------
# Kernel N: each node's nearest valid point on one shard of the cloud.
# ---------------------------------------------------------------------------


def nearest_point_sq_plain(y, node_mask, x, x_mask):
    """Kernel N's plain version; same contract as :func:`nearest_point_sq`.
    The squared distance is summed d = 0, 1, 2 in that order."""
    d = y[..., :, None, :] - x[..., None, :, :]
    sq = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    pair = (node_mask > 0)[..., :, None] & (x_mask > 0)[..., None, :]
    return torch.where(pair, sq, _BIG).amin(dim=-1).clamp_max(_BIG)


def nearest_point_sq(y, node_mask, x, x_mask):
    """The minimum over the valid points of each valid node's squared
    distance, in one launch (kernel N): ``y`` (…, m, 3), ``node_mask``
    (…, m) and ``x_mask`` (…, n) bool or float32 0/1 (read as given), ``x``
    (…, n, 3), with an optional leading stream axis on all four. Returns
    (…, m) float32, 1e5 where the node is masked or no point is valid."""
    if y.device.type == "cpu":
        return nearest_point_sq_plain(y, node_mask, x, x_mask)
    single = y.ndim == 2
    masks = [a if a.dtype in (torch.bool, _F32) else a.to(_F32) for a in (node_mask, x_mask)]
    args = dict(y=y, nm=masks[0], x=x, xm=masks[1])
    args = {k: (v[None] if single else v).contiguous() for k, v in args.items()}
    dev = _build.require_cuda("nearest_point_sq", args,
                              dict(nm=args["nm"].dtype, xm=args["xm"].dtype))
    bsz, m, _ = args["y"].shape
    n = args["x"].shape[1]
    check_nodes("nearest_point_sq", "nearest", m)
    shapes = dict(y=(bsz, m, 3), nm=(bsz, m), x=(bsz, n, 3), xm=(bsz, n))
    for k, want in shapes.items():
        if tuple(args[k].shape) != want:
            raise ValueError(f"nearest_point_sq: {k} must be {want}, got {tuple(args[k].shape)}")
    out = torch.empty((bsz, m), dtype=_F32, device=dev)
    code = _build.lib().trackdlo_nearest(
        *(v.data_ptr() for v in args.values()), bsz, m, n, int(args["nm"].dtype == torch.bool),
        int(args["xm"].dtype == torch.bool), out.data_ptr(), _build.stream_ptr(dev)
    )
    _build.check(code, "trackdlo_nearest")
    _build.count_launch("nearest")
    return out[0] if single else out
