"""The port's E-step and Gauss-Jordan solve (kernels S and G, their plain
versions on the CPU) and the single-stream per-iteration EM route against
the JAX package: its Pallas kernels run in interpret mode
(``fused_estep_packed_batch``, ``fused_estep_packed``,
``gauss_jordan_solve_batched``) and its ``cpd_lle`` with the same solver
options, on both of its routes.

Inputs are seeded numpy arrays handed to both packages."""

import importlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trackdlo_tpu.ops import pallas_kernels as jp
from trackdlo_tpu_torch.config import live_params
from trackdlo_tpu_torch.io.sequence import SyntheticRope
from trackdlo_tpu_torch.ops import cpd_lle as tc
from trackdlo_tpu_torch.ops.hopper_kernels import (
    fused_estep_packed,
    fused_estep_packed_batch,
    fused_estep_packed_batch_plain,
    fused_estep_packed_plain,
    gauss_jordan_solve_batched,
    gauss_jordan_solve_batched_plain,
)
from trackdlo_tpu_torch.ops.kernels import masked_geodesic_coords

jc = importlib.import_module("trackdlo_tpu.ops.cpd_lle")

M = 45
M_PAD = 48
N = 256
B = 3
PARAMS = live_params()
# The JAX package's own E-step kernel test bound (tests/test_pallas.py).
RTOL, ATOL = 2e-4, 1e-6
# Three EM iterations of two float32 implementations of the same loop.
TOL_M = 1e-6


def _cloud(rng, t, n_valid):
    curve = SyntheticRope().curve(t)
    x = np.zeros((N, 3), np.float32)
    x[:n_valid] = curve[rng.integers(0, len(curve), n_valid)] + rng.normal(0, 0.002, (n_valid, 3))
    return x, np.arange(N) < n_valid


def _estep_inputs(seed, v_counts, gates):
    """Per stream: nodes (a prefix of v_count valid), coords, a cloud,
    normalised visibility weights and the eight E-step scalars."""
    rng = np.random.default_rng(seed)
    ys, coords, nms, pvs, xs, xms, scal = [], [], [], [], [], [], []
    for b, (v, g) in enumerate(zip(v_counts, gates)):
        nm = np.arange(M) < v
        y = np.where(nm[:, None], SyntheticRope().nodes(0.01 * b, M), 0.0).astype(np.float32)
        coord = masked_geodesic_coords(torch.from_numpy(y), torch.from_numpy(nm)).numpy()
        x, xm = _cloud(rng, 1 / 15.0 + 0.01 * b, 200 - 30 * b)
        # The EM feeds the E-step pruned points only (within 0.1 m of a valid
        # node). Far points' first memberships can fall among float32's
        # subnormals, which the JAX package's CPU and TPU backends flush to
        # zero and the port keeps (IEEE): their first argmax then differs.
        d2 = ((x[:, None] - y[None]) ** 2).sum(-1)
        xm = xm & (np.where(nm[None], d2, np.inf).min(1) < PARAMS.prune_radius ** 2)
        pv = rng.random(M).astype(np.float32) * nm
        pv /= pv.sum()
        s2 = np.float32(1e-3 * (1 + b))
        c_base = (2 * np.pi * s2) ** 1.5 * PARAMS.mu / (1 - PARAMS.mu)
        n_safe = float(xm.sum())
        scal.append([s2, c_base * v / n_safe, c_base / n_safe, g, v, PARAMS.k_vis,
                     PARAMS.visibility_threshold, 0.0])
        ys.append(y), coords.append(coord), nms.append(nm.astype(np.float32)), pvs.append(pv)
        xs.append(x), xms.append(xm.astype(np.float32))
    return tuple(np.asarray(a, np.float32) for a in (scal, ys, coords, nms, pvs, xs, xms))


def _pad_rows(a, fill=0.0):
    out = np.full(a.shape[:-1] + (M_PAD,), fill, np.float32)
    out[..., :M] = a
    return out


def _jax_batch(scal, y, coord, nm, pv, x, xm, two_phase):
    """The JAX package's batched kernel on its own layout (interpreted)."""
    n_pad = 512
    sc = np.broadcast_to(scal[:, :, None], scal.shape + (128,))
    yp = np.zeros((len(y), M_PAD, 3), np.float32)
    yp[:, :M] = y
    col = lambda a, fill=0.0: _pad_rows(a, fill)[..., None]
    xt = np.zeros((len(x), 3, n_pad), np.float32)
    xt[:, :, :N] = x.transpose(0, 2, 1)
    xmp = np.zeros((len(x), 1, n_pad), np.float32)
    xmp[:, 0, :N] = xm
    out = jp.fused_estep_packed_batch(
        *(jnp.asarray(a) for a in (sc, yp, col(coord), col(nm), col(pv, 1.0), xt, xmp)),
        two_phase=two_phase, interpret=True,
    )
    p1, px, st, short = (np.asarray(o) for o in out)
    return p1[:, :M, 0], px[:, :M], st[:, 0], short[:, :M, 0]


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL, err_msg=what)


@pytest.mark.parametrize("two_phase", [True, False])
@pytest.mark.parametrize("gates", [(1.0, 0.0, 1.0), (0.0, 0.0, 0.0)], ids=["gates_mixed", "gates_off"])
def test_batched_estep_plain_matches_jax_kernel(two_phase, gates):
    """B7: v_count 45, 3 and 2 (the anchor fallbacks' row-select edge)."""
    args = _estep_inputs(0, (45, 3, 2), gates)
    got = fused_estep_packed_batch_plain(*(torch.from_numpy(a) for a in args), two_phase=two_phase)
    want = _jax_batch(*args, two_phase)
    for g, w, what in zip(got[:3], want[:3], ("p1", "px", "np_tr")):
        _close(g.numpy(), w, what)
    assert float(got[0].sum()) > 0
    nm = args[3] > 0
    if two_phase and any(gates):
        # Defined for every valid node; invalid nodes keep the sentinel.
        _close(got[3].numpy()[nm], want[3][nm], "shortest_sq")
        assert (got[3].numpy()[~nm] == 1e5).all()
    else:
        assert (got[3].numpy() == 1e5).all() and (want[3] == 1e5).all()


@pytest.mark.parametrize("two_phase", [True, False])
@pytest.mark.parametrize("v_count", [45, 3, 2])
def test_single_estep_plain_matches_jax_kernel(two_phase, v_count):
    """B6: one stream, its own gate on."""
    scal, y, coord, nm, pv, x, xm = (a[0] for a in _estep_inputs(1, (v_count,), (1.0,)))
    got = fused_estep_packed_plain(*(torch.from_numpy(a) for a in (scal, y, coord, nm, pv, x, xm)),
                                   two_phase=two_phase)
    yp = np.zeros((M_PAD, 3), np.float32)
    yp[:M] = y
    col = lambda a, fill=0.0: _pad_rows(a, fill)[:, None]
    xt = np.zeros((3, 512), np.float32)
    xt[:, :N] = x.T
    xmp = np.zeros((1, 512), np.float32)
    xmp[0, :N] = xm
    sc = np.broadcast_to(scal[:, None], (8, 128)).copy()
    sc[7] = 1.0 if two_phase else 0.0
    out = jp.fused_estep_packed(*(jnp.asarray(a) for a in (sc, yp, col(coord), col(nm), col(pv, 1.0),
                                                           xt, xmp)),
                                two_phase=two_phase, interpret=True)
    p1, px, st, short = (np.asarray(o) for o in out)
    _close(got[0].numpy(), p1[:M, 0], "p1")
    _close(got[1].numpy(), px[:M], "px")
    _close(got[2].numpy(), st[0], "np_tr")
    if two_phase:
        valid = nm > 0
        _close(got[3].numpy()[valid], short[:M, 0][valid], "shortest_sq")


def test_estep_wrappers_take_plain_versions_on_cpu():
    args = tuple(torch.from_numpy(a) for a in _estep_inputs(2, (45, 45, 3), (1.0, 0.0, 0.0)))
    for u, v in zip(fused_estep_packed_batch(*args, two_phase=True),
                    fused_estep_packed_batch_plain(*args, two_phase=True)):
        assert torch.equal(u, v)
    one = tuple(a[1] for a in args)
    for u, v in zip(fused_estep_packed(*one, two_phase=False),
                    fused_estep_packed_plain(*one, two_phase=False)):
        assert torch.equal(u, v)


def _spd_systems():
    """perf/tpu_kernel_numerics.py's solve fixture (seed 0)."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((8, 48, 48)).astype(np.float32)
    a = a @ a.transpose(0, 2, 1) + 48 * np.eye(48, dtype=np.float32)
    b = rng.standard_normal((8, 48, 3)).astype(np.float32)
    return a, b


def _pivoting_systems():
    """Well-conditioned systems whose rows are permuted so the diagonal is
    tiny or zero: the elimination must pivot."""
    rng = np.random.default_rng(1)
    a = rng.standard_normal((4, 45, 45)).astype(np.float32) + 8 * np.eye(45, dtype=np.float32)
    a = a[:, rng.permutation(45)]
    a[:, np.arange(45), np.arange(45)] = 0.0
    a[1] *= np.float32(1e3) ** np.linspace(-1, 1, 45, dtype=np.float32)[:, None]
    b = rng.standard_normal((4, 45, 3)).astype(np.float32)
    return a, b


@pytest.mark.parametrize("systems", [_spd_systems, _pivoting_systems], ids=["spd", "pivoting"])
def test_gj_plain_matches_float64_and_jax_kernel(systems):
    a, b = systems()
    w64 = np.linalg.solve(a.astype(np.float64), b.astype(np.float64))
    got = gauss_jordan_solve_batched_plain(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    ref = np.asarray(jp.gauss_jordan_solve_batched(jnp.asarray(a), jnp.asarray(b), interpret=True))
    scale = np.abs(w64).max()
    if systems is _spd_systems:
        # gj_solve_vs_f64_max of perf/tpu_kernel_numerics.py.
        assert np.abs(got - w64).max() <= 2e-8
        assert np.abs(ref - w64).max() <= 2e-8
    else:
        assert np.abs(got - w64).max() <= 1e-5 * scale
        assert np.abs(ref - w64).max() <= 1e-5 * scale
    assert np.abs(got - ref).max() <= 2 * max(2e-8, 1e-5 * scale if systems is _pivoting_systems else 0)
    assert torch.equal(gauss_jordan_solve_batched(torch.from_numpy(a), torch.from_numpy(b)),
                       torch.from_numpy(got))


def test_gj_on_live_prereg_system():
    """A pre-registration M-step system of a live frame (cond 2.4e6), with
    kernel G's solution on the card and the plain version's, as
    ``chip_smoke.py`` saves them (``chiprun_out/gj_prereg_system.npz``).
    At this conditioning a float32 solve is at best cond(A)·u from float64,
    and the TPU function's own algorithm (interpreted) is no nearer: kernel G
    is held to its backward error and to within 4x of B8's forward error."""
    data = np.load(Path(__file__).parent / "data" / "gj_prereg_system.npz")
    a, b = data["a"], data["b"]
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    cond = np.linalg.cond(a64)
    assert 1e6 < cond < 1e7
    w64 = np.linalg.solve(a64, b64)
    u = 2.0 ** -24

    def forward(w):
        return np.abs(w - w64).max() / np.abs(w64).max()

    def backward(w):
        w = w.astype(np.float64)
        return np.abs(b64 - a64 @ w).max() / (
            np.abs(a64).sum(1).max() * np.abs(w).max() + np.abs(b64).max())

    ref = np.asarray(jp.gauss_jordan_solve_batched(jnp.asarray(a[None]), jnp.asarray(b[None]),
                                                   interpret=True))[0]
    plain = gauss_jordan_solve_batched_plain(torch.from_numpy(a[None]), torch.from_numpy(b[None]))
    solves = {"jax_b8": ref, "kernel_g": data["w_kernel"], "plain_card": data["w_plain"],
              "plain_cpu": plain[0].numpy()}
    for name, w in solves.items():
        assert backward(w) <= 4 * u, name
        assert forward(w) <= cond * u, name
    assert forward(data["w_kernel"]) <= 4 * forward(ref)


def _em_inputs(seed, n_valid=200):
    rng = np.random.default_rng(seed)
    y = SyntheticRope().nodes(0.0, M).astype(np.float32)
    x, xm = _cloud(rng, 1 / 15.0, n_valid)
    return y, x, xm


def _base(**kw):
    p = PARAMS
    base = dict(beta=p.beta, lam=p.lam, lle_weight=p.lle_weight, mu=p.mu, max_iter=3, tol=0.0,
                include_lle=False, visibility_threshold=p.visibility_threshold,
                prune_radius=p.prune_radius, use_visibility=True, k_vis=p.k_vis)
    base.update(kw)
    return base


@pytest.mark.parametrize("solver", ["lstsq", "normal_cholesky", "svd_lstsq", "xla_lu"])
@pytest.mark.parametrize("priors", [False, True], ids=["plain", "priors_gate"])
def test_per_iteration_solvers_match_jax(solver, priors):
    """The single-stream per-iteration route (E-step for one stream, torch
    M-step, the named solve) against JAX cpd_lle with the same solver, on its
    XLA iteration and on its interpreted per-iteration kernel route."""
    y, x, xm = _em_inputs(3)
    nm = np.ones(M, bool)
    extra, kw_t, kw_j = {}, {}, {}
    if priors:
        extra = {"use_priors": True, "alpha": PARAMS.alpha}
        pp, pm = (y + 0.004).astype(np.float32), np.arange(M) < 12
        kw_t = dict(prior_pos=torch.from_numpy(pp), prior_mask=torch.from_numpy(pm))
        kw_j = dict(prior_pos=jnp.asarray(pp), prior_mask=jnp.asarray(pm))
    kw = _base(solver=solver, **extra)
    t = torch.from_numpy
    got = tc.cpd_lle(t(x), t(xm), t(y), t(nm), torch.tensor(PARAMS.sigma2_init), tc.CpdParams(**kw),
                     visible_count=torch.tensor(30), **kw_t)
    for use_pallas in (False, True):
        ref = jc.cpd_lle(jnp.asarray(x), jnp.asarray(xm), jnp.asarray(y), jnp.asarray(nm),
                         jnp.float32(PARAMS.sigma2_init), jc.CpdParams(**kw, use_pallas=use_pallas),
                         visible_count=jnp.int32(30), **kw_j)
        assert int(got.iterations) == int(ref.iterations) == 3
        assert np.abs(got.y.numpy() - np.asarray(ref.y)).max() <= TOL_M
        np.testing.assert_allclose(float(got.sigma2), float(ref.sigma2), rtol=0, atol=2e-7)


@pytest.mark.parametrize("solver", ["lu", "lstsq"])
def test_return_deltas_matches_jax(solver):
    """return_deltas: every one of max_iter iterations runs (no exit at tol)
    and each iteration's mean node move comes back."""
    y, x, xm = _em_inputs(4)
    nm = np.ones(M, bool)
    kw = _base(solver=solver, max_iter=4, tol=PARAMS.tol)
    t = torch.from_numpy
    got, deltas = tc.cpd_lle(t(x), t(xm), t(y), t(nm), torch.tensor(PARAMS.sigma2_init),
                             tc.CpdParams(**kw), visible_count=torch.tensor(30), return_deltas=True)
    assert deltas.shape == (4,)
    for use_pallas in (False, True):
        ref, ref_d = jc.cpd_lle(jnp.asarray(x), jnp.asarray(xm), jnp.asarray(y), jnp.asarray(nm),
                                jnp.float32(PARAMS.sigma2_init), jc.CpdParams(**kw, use_pallas=use_pallas),
                                visible_count=jnp.int32(30), return_deltas=True)
        assert int(got.iterations) == int(ref.iterations) == 4 and bool(got.converged)
        assert np.abs(got.y.numpy() - np.asarray(ref.y)).max() <= 2 * TOL_M
        np.testing.assert_allclose(deltas.numpy(), np.asarray(ref_d), rtol=1e-3, atol=1e-7)


def test_unknown_solver_raises():
    y, x, xm = _em_inputs(5)
    t = torch.from_numpy
    with pytest.raises(ValueError, match="unknown solver"):
        tc.cpd_lle(t(x), t(xm), t(y), torch.ones(M, dtype=torch.bool), torch.tensor(1e-3),
                   tc.CpdParams(**_base(solver="qr_magic")))


@pytest.mark.parametrize("n", [0, 1, 255, 256, 257, 700, 1024, 2001, 2048, 4096, 16384])
def test_cluster_shape_covers_every_row_once(n):
    """Kernels E and S split n rows over a cluster whose shape depends on n
    alone: 1 to 8 CTAs of at most 2048 rows, about 256 rows each, the CTAs'
    ranges covering every row exactly once (the card test holds the launch
    to this shape)."""
    from trackdlo_tpu_torch.ops.hopper_kernels import cluster_shape

    c, rows = cluster_shape(n)
    assert 1 <= c <= 8 and rows <= 2048
    assert c == min(max(-(-n // 256), 1), 8)
    covered = np.zeros(n, int)
    for r in range(c):
        covered[min(n, r * rows):min(n, (r + 1) * rows)] += 1
    assert (covered == 1).all()
