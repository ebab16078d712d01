"""Kernel F's plain version (one whole EM iteration with the one-hot
Gauss-Jordan M-step) and the routes of the port's ``cpd_lle`` that the JAX
package runs outside its whole-loop kernel, on the CPU:

- the plain kernel F against the JAX package's ``fused_em_iteration`` run in
  interpret mode, and its one-hot solve against ``_onehot_gauss_jordan`` on
  systems whose pivot columns tie;
- ``cpd_lle(use_fused_mstep=True)`` and ``cpd_lle_batched`` against JAX's
  ``cpd_lle(use_pallas=True, use_fused_mstep=True)`` and its ``jax.vmap``,
  and ``return_deltas`` on that route;
- the prototype E-step variants (Gaussian kernels, no geodesic
  re-distance) against JAX's XLA iteration.

Inputs are seeded numpy arrays handed to both packages."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trackdlo_tpu_torch.config import live_params
from trackdlo_tpu_torch.io.sequence import SyntheticRope
from trackdlo_tpu_torch.ops import cpd_lle as tc
from trackdlo_tpu_torch.ops.hopper_kernels import (
    fused_em_iteration,
    fused_em_iteration_plain,
    onehot_gauss_jordan_plain,
)

jc = importlib.import_module("trackdlo_tpu.ops.cpd_lle")
jk = importlib.import_module("trackdlo_tpu.ops.pallas_kernels")

M = 45
N_CAP = 256
PARAMS = live_params()
# One to three EM iterations of two float32 implementations of the same
# function: the bound the chip check holds kernel F to (em3_fusedmstep_*).
TOL_M = 1e-6
# The live tolerance loop: more iterations, the rounding differences compound.
TOL_LIVE_M = 1e-5
# σ² is a difference of traces near 100 m² over ~600 weighted points, summed
# in another order: float32 cancellation leaves a few 1e-8 m² (2.5e-8 here,
# 8e-5 of σ² itself), the bound of tests/test_torch_em.py.
SIGMA2_ATOL = 2e-7


def _inputs(seed, n_valid=200):
    """Nodes of the rope at t=0 and a noisy cloud along it at t=1/15."""
    rng = np.random.default_rng(seed)
    rope = SyntheticRope()
    y = rope.nodes(0.0, M).astype(np.float32)
    curve = rope.curve(1 / 15.0)
    pick = rng.integers(0, len(curve), n_valid)
    x = np.zeros((N_CAP, 3), np.float32)
    x[:n_valid] = curve[pick] + rng.normal(0, 0.002, (n_valid, 3))
    xm = np.arange(N_CAP) < n_valid
    return y, x, xm


def _base(**kw):
    p = PARAMS
    base = dict(beta=p.beta, lam=p.lam, lle_weight=p.lle_weight, mu=p.mu, max_iter=3,
                tol=0.0, include_lle=False, visibility_threshold=p.visibility_threshold,
                prune_radius=p.prune_radius)
    base.update(kw)
    return base


# name: (CpdParams changes, with priors and the visibility gate)
CONFIGS = {
    "plain": ({}, False),
    "lle": ({"include_lle": True}, False),
    "priors_gate": ({"use_priors": True, "alpha": PARAMS.alpha, "use_visibility": True,
                     "k_vis": PARAMS.k_vis}, True),
}


def _priors(y, visible_count=30):
    return dict(prior_pos=(y + 0.004).astype(np.float32), prior_mask=np.arange(M) < 12,
                visible_count=visible_count)


def _run_both(x, xm, y, nm, kw, priors=None, **call):
    t = lambda a: None if a is None else torch.from_numpy(np.asarray(a))
    j = lambda a: None if a is None else jnp.asarray(a)
    pr = priors or {}
    vc = pr.get("visible_count")
    got = tc.cpd_lle(t(x), t(xm), t(y), t(nm), torch.tensor(PARAMS.sigma2_init), tc.CpdParams(**kw),
                     prior_pos=t(pr.get("prior_pos")), prior_mask=t(pr.get("prior_mask")),
                     visible_count=None if vc is None else torch.tensor(vc), **call)
    ref = jc.cpd_lle(j(x), j(xm), j(y), j(nm), jnp.float32(PARAMS.sigma2_init),
                     jc.CpdParams(**kw, use_pallas=True), prior_pos=j(pr.get("prior_pos")),
                     prior_mask=j(pr.get("prior_mask")),
                     visible_count=None if vc is None else jnp.int32(vc), **call)
    return got, ref


def _kernel_f_inputs(config, v_count=M, seed=11):
    """One iteration's inputs of kernel F, from the port's staging."""
    extra, priors = CONFIGS[config]
    y, x, xm = _inputs(seed)
    nm = np.arange(M) < v_count
    y = np.where(nm[:, None], y, 0.0).astype(np.float32)
    pr = _priors(y, visible_count=v_count - 15) if priors else {}  # the gate on
    params = tc.CpdParams(**_base(**extra, use_fused_mstep=True))
    t = torch.from_numpy
    st = tc.em_staging(t(x), t(xm), t(y), t(nm), torch.tensor(PARAMS.sigma2_init), params,
                       prior_pos=None if not pr else t(pr["prior_pos"]),
                       prior_mask=None if not pr else t(pr["prior_mask"]),
                       visible_count=None if not pr else torch.tensor(pr["visible_count"]))
    dyn, y0, coord, nmf, g, hg, hy0, jg, pd, xx, xmf = st.args
    s2 = dyn[0]
    c_base = (tc._TWO_PI * s2) ** 1.5 * params.mu / (1 - params.mu)
    # The iterate a little away from the origin, as after one iteration.
    yc = y0 + torch.from_numpy(np.random.default_rng(seed).normal(0, 1e-3, (M, 3)).astype(np.float32))
    yc = torch.where(nmf[:, None] > 0, yc, 0.0)
    args = (yc, y0, nmf > 0, coord, g, hg, hy0, jg, pd, xx, xmf > 0, s2, c_base * dyn[1] / dyn[2],
            c_base / dyn[2], dyn[3] > 0, dyn[1].to(torch.int32))
    kw = {k: st.kwargs[k] for k in ("k_vis", "tau_vis", "lam", "coef_lle", "alpha")}
    return args, kw


@pytest.mark.parametrize("config,v_count", [("plain", M), ("lle", M), ("priors_gate", M),
                                            ("priors_gate", 30), ("lle", 3)])
def test_plain_kernel_f_matches_interpreted_jax(config, v_count):
    """One iteration: t within 1e-6 m, the mean move within rtol 1e-5, σ²
    within SIGMA2_ATOL. v_count < M leaves padded (inactive) nodes with
    identity rows."""
    args, kw = _kernel_f_inputs(config, v_count)
    got = fused_em_iteration(*args, **kw)
    ref = jk.fused_em_iteration(*(jnp.asarray(a.numpy()) for a in args), **kw, interpret=True)
    if config == "priors_gate":
        assert bool(args[14])  # the visibility gate is on
    nm = args[2].numpy()
    err = np.abs(got[0].numpy() - np.asarray(ref[0]))
    assert err[nm].max() <= TOL_M, err[nm].max()
    np.testing.assert_array_equal(got[0].numpy()[~nm], np.asarray(ref[0])[~nm])
    np.testing.assert_allclose(float(got[1]), float(ref[1]), rtol=0, atol=SIGMA2_ATOL)
    np.testing.assert_allclose(float(got[2]), float(ref[2]), rtol=1e-5)


def _tie_systems():
    """Systems whose pivot columns tie: equal |A[r, k]| in two unused rows
    (opposite signs), an all-zero column, and identity rows of inactive
    nodes."""
    rng = np.random.default_rng(5)
    m = 12
    a = rng.standard_normal((3, m, m)).astype(np.float32) + 4 * np.eye(m, dtype=np.float32)
    a[0, 1, 0] = a[0, 0, 0] = 2.0
    a[0, 5, 0] = -2.0
    a[1, :, 3] = 0.0  # a zero column: the first unused row takes it
    a[2, 4:7] = 0.0
    a[2, :, 4:7] = 0.0
    a[2, 4:7, 4:7] = np.eye(3, dtype=np.float32)
    a[2, 0, 0] = a[2, 3, 0] = 3.0
    b = rng.standard_normal((3, m, 3)).astype(np.float32)
    b[2, 4:7] = 0.0
    return a, b


def test_onehot_solve_matches_jax_on_ties():
    a, b = _tie_systems()
    got = onehot_gauss_jordan_plain(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    for i in range(len(a)):
        ref = np.asarray(jk._onehot_gauss_jordan(jnp.asarray(a[i]), jnp.asarray(b[i]),
                                                 jnp.ones(a.shape[1]), a.shape[1]))
        scale = np.abs(ref).max()
        assert np.abs(got[i] - ref).max() <= 1e-5 * scale, i
        if i != 1:  # the zero column leaves system 1 singular
            w64 = np.linalg.solve(a[i].astype(np.float64), b[i].astype(np.float64))
            assert np.abs(got[i] - w64).max() <= 1e-4 * np.abs(w64).max()


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_cpd_lle_fused_three_iterations_match_jax(config):
    extra, priors = CONFIGS[config]
    y, x, xm = _inputs(3)
    nm = np.ones(M, bool)
    got, ref = _run_both(x, xm, y, nm, _base(**extra, use_fused_mstep=True),
                         _priors(y) if priors else None)
    assert int(got.iterations) == int(ref.iterations) == 3
    assert np.abs(got.y.numpy() - np.asarray(ref.y)).max() <= TOL_M
    np.testing.assert_allclose(float(got.sigma2), float(ref.sigma2), rtol=0, atol=SIGMA2_ATOL)


def test_cpd_lle_fused_live_tolerance_matches_jax():
    """The live tolerance (max_iter 50): the same iteration count."""
    y, x, xm = _inputs(7)
    nm = np.ones(M, bool)
    kw = _base(max_iter=PARAMS.max_iter, tol=PARAMS.tol, use_fused_mstep=True)
    got, ref = _run_both(x, xm, y, nm, kw)
    assert int(got.iterations) == int(ref.iterations)
    assert bool(got.converged) == bool(ref.converged)
    assert np.abs(got.y.numpy() - np.asarray(ref.y)).max() <= TOL_LIVE_M


def test_cpd_lle_fused_return_deltas_matches_jax():
    y, x, xm = _inputs(8)
    nm = np.ones(M, bool)
    (got, d_got), (ref, d_ref) = _run_both(x, xm, y, nm, _base(max_iter=3, use_fused_mstep=True),
                                           return_deltas=True)
    assert d_got.shape == (3,) and int(got.iterations) == 3
    # Each delta is a mean node move: it differs by at most the two
    # iterates' own distance, 2 x TOL_M.
    np.testing.assert_allclose(d_got.numpy(), np.asarray(d_ref), rtol=0, atol=2 * TOL_M)
    assert np.abs(got.y.numpy() - np.asarray(ref.y)).max() <= TOL_M


def test_cpd_lle_batched_fused_matches_jax_vmap():
    """Three streams (one gated, one with 30 valid nodes) in lockstep
    through kernel F's plain version against jax.vmap of JAX cpd_lle."""
    ys, xs, xms, nms, vcs = [], [], [], [], []
    for b in range(3):
        y, x, xm = _inputs(20 + b, n_valid=150 + 30 * b)
        nm = np.arange(M) < (30 if b == 2 else M)
        ys.append(np.where(nm[:, None], y, 0.0).astype(np.float32))
        xs.append(x), xms.append(xm), nms.append(nm), vcs.append(30 if b == 1 else M)
    st = lambda a: np.stack(a)
    kw = _base(use_fused_mstep=True, use_visibility=True, k_vis=PARAMS.k_vis)
    s2 = np.full(3, PARAMS.sigma2_init, np.float32)
    got = tc.cpd_lle_batched(*(torch.from_numpy(st(a)) for a in (xs, xms, ys, nms)),
                             torch.from_numpy(s2), tc.CpdParams(**kw),
                             visible_count=torch.tensor(vcs))
    jparams = jc.CpdParams(**kw, use_pallas=True)
    ref = jax.vmap(lambda x, xm, y, nm, s, vc: jc.cpd_lle(x, xm, y, nm, s, jparams, visible_count=vc))(
        *(jnp.asarray(st(a)) for a in (xs, xms, ys, nms)), jnp.asarray(s2), jnp.asarray(vcs))
    np.testing.assert_array_equal(got.iterations.numpy(), np.asarray(ref.iterations))
    # em10_batched_vs_single_max_m, the JAX package's bound for a batched EM
    # route against another (perf/tpu_kernel_numerics.py).
    assert np.abs(got.y.numpy() - np.asarray(ref.y)).max() <= 2e-6
    # Each stream equals its own single-stream run.
    for b in range(3):
        one = tc.cpd_lle(*(torch.from_numpy(a[b]) for a in (xs, xms, ys, nms)),
                         torch.tensor(s2[b]), tc.CpdParams(**kw), visible_count=torch.tensor(vcs[b]))
        assert torch.equal(one.y, got.y[b])


# name: CpdParams changes
VARIANTS = {
    "gaussian_geodesic": {"kernel": "gaussian_geodesic"},
    "gaussian_euclidean": {"kernel": "gaussian_euclidean"},
    "no_geodesic_redistance": {"use_geodesic_redistance": False},
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_prototype_variants_match_jax(variant):
    """Three iterations, with the visibility gate on, against the JAX
    package's XLA iteration (which its use_pallas route takes for them)."""
    y, x, xm = _inputs(12)
    nm = np.ones(M, bool)
    kw = _base(**VARIANTS[variant], use_visibility=True, k_vis=PARAMS.k_vis, use_priors=True,
               alpha=PARAMS.alpha)
    got, ref = _run_both(x, xm, y, nm, kw, _priors(y))
    assert int(got.iterations) == int(ref.iterations) == 3
    assert np.abs(got.y.numpy() - np.asarray(ref.y)).max() <= TOL_M
    np.testing.assert_allclose(float(got.sigma2), float(ref.sigma2), rtol=0, atol=SIGMA2_ATOL)


def test_prototype_variant_batched_equals_single():
    kw = tc.CpdParams(**_base(kernel="gaussian_euclidean", include_lle=True))
    ins = [_inputs(30 + b) for b in range(2)]
    t = lambda k: torch.stack([torch.from_numpy(i[k]) for i in ins])
    nm = torch.ones((2, M), dtype=torch.bool)
    s2 = torch.full((2,), PARAMS.sigma2_init)
    got = tc.cpd_lle_batched(t(1), t(2), t(0), nm, s2, kw)
    for b in range(2):
        one = tc.cpd_lle(*(torch.from_numpy(a) for a in (ins[b][1], ins[b][2], ins[b][0])), nm[b],
                         s2[b], kw)
        torch.testing.assert_close(one.y, got.y[b], rtol=0, atol=1e-7)


def test_kernel_f_wrapper_takes_plain_version_on_cpu():
    """A single stream and a stream axis of one give the same iteration."""
    args, kw = _kernel_f_inputs("priors_gate")
    one = fused_em_iteration(*args, **kw)
    batched = fused_em_iteration_plain(
        *(a.unsqueeze(0) if a.ndim else a.reshape(1) for a in args), **kw)
    for u, v in zip(one, batched):
        assert torch.equal(u, v[0])


@pytest.mark.parametrize("gate", [False, True])
def test_fused_iteration_c_from_dyn_matches_interpreted_jax(gate):
    """The route's entry: fused_iteration computes no c's, the iteration
    takes them from the staging's dyn as kernel F does on the card
    (em_iteration_c), against the JAX package's fused_em_iteration
    (interpret mode) with the c's as its cpd_lle computes them. t within
    1e-6 m, σ² within SIGMA2_ATOL, the move within rtol 1e-5."""
    from trackdlo_tpu_torch.ops.hopper_kernels import em_iteration_c

    y, x, xm = _inputs(13)
    nm = np.ones(M, bool)
    params = tc.CpdParams(**_base(use_fused_mstep=True, use_visibility=True, k_vis=PARAMS.k_vis))
    one = lambda a: torch.from_numpy(np.asarray(a))[None]
    st = tc.em_staging(one(x), one(xm), one(y), one(nm), torch.tensor([PARAMS.sigma2_init]), params,
                       visible_count=torch.tensor([30 if gate else M]))
    dyn, y0, coord, nmf, g, hg, hy0, jg, pd, xx, xmf = st.args
    assert bool(dyn[0, 3] > 0) == gate
    yc = y0 + torch.from_numpy(np.random.default_rng(13).normal(0, 1e-3, (1, M, 3)).astype(np.float32))
    s2 = dyn[:, 0]
    got = tc.fused_iteration(st, yc, s2, params)
    j = lambda a: jnp.asarray(a[0].numpy())
    c_base = (jc._TWO_PI * j(s2)) ** 1.5 * params.mu / (1 - params.mu)
    c_ref = (c_base * j(dyn[:, 1]) / j(dyn[:, 2]), c_base / j(dyn[:, 2]))
    c_got = em_iteration_c(s2, dyn, st.kwargs["muf"])
    np.testing.assert_allclose([float(c[0]) for c in c_got], [float(c) for c in c_ref], rtol=1e-6)
    kw = {k: st.kwargs[k] for k in ("k_vis", "tau_vis", "lam", "coef_lle", "alpha")}
    ref = jk.fused_em_iteration(
        j(yc), j(y0), j(nmf) > 0, j(coord), j(g), j(hg), j(hy0), j(jg), j(pd), j(xx), j(xmf) > 0,
        j(s2), *c_ref, j(dyn[:, 3]) > 0, j(dyn[:, 1]).astype(jnp.int32), **kw, interpret=True)
    assert np.abs(got[0][0].numpy() - np.asarray(ref[0])).max() <= TOL_M
    np.testing.assert_allclose(float(got[1][0]), float(ref[1]), rtol=0, atol=SIGMA2_ATOL)
    np.testing.assert_allclose(float(got[2][0]), float(ref[2]), rtol=1e-5)


def test_plain_kernel_f_near_saved_card_outputs():
    """F's plain version on the CPU, on the inputs saved from the card
    (tests/data/em_iter_bits.npz, perf/em_iter_bits.py: chip_smoke.py's
    kernel-F configurations on its live cloud, the design before the
    cluster E-step): t within 1e-6 m of the card's, σ² within SIGMA2_ATOL."""
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root / "perf"))
    import em_iter_bits

    saved = em_iter_bits.load(root / "tests" / "data" / "em_iter_bits.npz")
    assert len(saved) == 9
    for case, (fargs, kw, (t0, s0, d0)) in saved.items():
        t, s2, delta = fused_em_iteration_plain(*(torch.from_numpy(a) for a in fargs), **kw)
        assert np.abs(t.numpy() - t0).max() <= TOL_M, case
        np.testing.assert_allclose(s2.numpy(), s0, rtol=0, atol=SIGMA2_ATOL, err_msg=case)
        np.testing.assert_allclose(delta.numpy(), d0, rtol=1e-5, err_msg=case)
