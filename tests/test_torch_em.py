"""The port's EM pass (trackdlo_tpu_torch.ops.cpd_lle, kernel E's plain
version on the CPU) against the JAX package's cpd_lle: its XLA iteration
(use_pallas=False) and its whole-loop Pallas kernel run in interpret mode
(use_pallas=True, which takes fused_em_loop(interpret=True) off the TPU).

Inputs are seeded numpy arrays handed to both packages."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trackdlo_tpu_torch.config import live_params
from trackdlo_tpu_torch.io.sequence import SyntheticRope
from trackdlo_tpu_torch.ops import cpd_lle as tc
from trackdlo_tpu_torch.ops.hopper_kernels import fused_em_loop, fused_em_loop_plain

jc = importlib.import_module("trackdlo_tpu.ops.cpd_lle")

M = 45
N_CAP = 256
PARAMS = live_params()
# Three EM iterations of two float32 implementations of the same loop: the
# bound the chip check holds the kernel to as well.
TOL_M = 1e-6
# The pre-registration pass (beta 3, lambda 1, LLE) solves systems with
# cond(A) near 4e6: there the JAX package's own two routes (XLA and the
# interpreted kernel) differ by 1.7e-5 m after three iterations, so the port
# is held to a bound above that spread.
TOL_PREREG_M = 5e-5


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


def _run_both(x, xm, y, nm, sigma2, kw, prior_pos=None, prior_mask=None,
              visible_count=None, point_min_sq=None):
    t = lambda a: None if a is None else torch.from_numpy(np.asarray(a))
    j = lambda a: None if a is None else jnp.asarray(a)
    got = tc.cpd_lle(
        t(x), t(xm), t(y), t(nm), torch.tensor(sigma2, dtype=torch.float32), tc.CpdParams(**kw),
        prior_pos=t(prior_pos), prior_mask=t(prior_mask),
        visible_count=None if visible_count is None else torch.tensor(visible_count),
        point_min_sq=t(point_min_sq),
    )
    refs = []
    for use_pallas in (False, True):
        refs.append(jc.cpd_lle(
            j(x), j(xm), j(y), j(nm), jnp.float32(sigma2), jc.CpdParams(**kw, use_pallas=use_pallas),
            prior_pos=j(prior_pos), prior_mask=j(prior_mask),
            visible_count=None if visible_count is None else jnp.int32(visible_count),
            point_min_sq=j(point_min_sq),
        ))
    return got, refs


def _assert_match(got, refs, nm, tol=TOL_M):
    for ref in refs:
        assert int(got.iterations) == int(ref.iterations)
        assert bool(got.converged) == bool(ref.converged)
        err = np.abs(got.y.numpy() - np.asarray(ref.y))
        assert err[nm].max() <= tol, err[nm].max()
        # Rows outside the node mask are carried through unchanged.
        np.testing.assert_array_equal(got.y.numpy()[~nm], np.asarray(ref.y)[~nm])
        # sigma2 is a difference of traces near 100 m² over ~600 weighted
        # points: float32 cancellation leaves a few 1e-8 m² of rounding.
        np.testing.assert_allclose(float(got.sigma2), float(ref.sigma2), rtol=0, atol=2e-7)


PREREG = {"include_lle": True, "beta": PARAMS.beta_pre_proc, "lam": PARAMS.lambda_pre_proc}
# name: (CpdParams changes, with priors and the visibility gate, bound)
CONFIGS = {
    "plain": ({}, False, TOL_M),
    "lle": ({"include_lle": True}, False, TOL_M),
    "priors_gate": ({"use_priors": True, "alpha": PARAMS.alpha, "use_visibility": True,
                     "k_vis": PARAMS.k_vis}, True, TOL_M),
    "prereg": (PREREG, False, TOL_PREREG_M),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("with_point_min", [False, True])
def test_three_iterations_match_jax(name, with_point_min):
    extra, priors, tol = CONFIGS[name]
    y, x, xm = _inputs(3)
    nm = np.ones(M, bool)
    kw = {}
    if priors:
        kw = dict(prior_pos=(y + 0.004).astype(np.float32), prior_mask=np.arange(M) < 12,
                  visible_count=30)
    pmin = None
    if with_point_min:
        pmin = ((y[:, None] - x[None]) ** 2).sum(-1).min(0).astype(np.float32)
    got, refs = _run_both(x, xm, y, nm, PARAMS.sigma2_init, _base(**extra), point_min_sq=pmin, **kw)
    _assert_match(got, refs, nm, tol)


def test_sigma2_zero_starts_from_mean_distance():
    y, x, xm = _inputs(4)
    nm = np.ones(M, bool)
    got, refs = _run_both(x, xm, y, nm, 0.0, _base())
    _assert_match(got, refs, nm)


def test_empty_cloud_leaves_state_unchanged():
    y, x, _ = _inputs(5)
    xm = np.zeros(N_CAP, bool)
    nm = np.ones(M, bool)
    got, refs = _run_both(x, xm, y, nm, PARAMS.sigma2_init, _base(include_lle=True))
    np.testing.assert_array_equal(got.y.numpy(), y)
    assert float(got.sigma2) == np.float32(PARAMS.sigma2_init)
    for ref in refs:
        np.testing.assert_array_equal(np.asarray(ref.y), y)
        assert float(ref.sigma2) == float(got.sigma2)


@pytest.mark.parametrize("v_count", [1, 2, 3])
def test_few_valid_nodes_match_jax(v_count):
    """v_count < 3 sends the geodesic anchor's second candidate to a negative
    row. The kernel's row select gives 0 there, and the port keeps that; the
    JAX package's XLA iteration gathers with numpy indexing, which wraps -1
    to the last row, so at v_count == 2 the port is held to the kernel only."""
    y, x, xm = _inputs(6)
    nm = np.arange(M) < v_count
    guides = np.where(nm[:, None], y, 0.0).astype(np.float32)
    got, refs = _run_both(x, xm, guides, nm, PARAMS.sigma2_init, _base(**PREREG))
    if v_count == 2:
        refs = refs[1:]
    _assert_match(got, refs, nm, TOL_PREREG_M)


def test_to_convergence_matches_jax():
    """The live tolerance (max_iter 50): same iteration count and result."""
    y, x, xm = _inputs(7)
    nm = np.ones(M, bool)
    kw = _base(max_iter=PARAMS.max_iter, tol=PARAMS.tol)
    got, refs = _run_both(x, xm, y, nm, PARAMS.sigma2_init, kw)
    for ref in refs:
        assert int(got.iterations) == int(ref.iterations)
        # More iterations than the 3-iteration bound: the float32 rounding
        # differences compound, still far below a millimetre.
        assert np.abs(got.y.numpy() - np.asarray(ref.y)).max() <= 1e-5


@pytest.fixture(scope="module")
def one_rank_group(tmp_path_factory):
    """A process group of this process alone: the point axis of one rank."""
    import torch.distributed as dist

    store = dist.FileStore(str(tmp_path_factory.mktemp("gloo") / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    yield dist.group.WORLD
    dist.destroy_process_group()


@pytest.mark.parametrize("change", [{"use_geodesic_redistance": False}, {"use_fused_mstep": True},
                                    {"kernel": "gaussian_geodesic"}, {"axis_name": "model"}])
def test_formerly_unported_options_run(change, request):
    """No option of ``cpd_lle`` raises. The ones that once did run and match the
    JAX package's same route (tests/test_torch_fused_mstep.py holds them to
    it); point-axis sharding (``axis_name``, here a process group of one
    rank) takes the per-iteration route, bit-equal on the CPU to the
    unsharded per-iteration route (tests/test_torch_shard_em.py holds two
    ranks to the JAX package's ``shard_map``)."""
    y, x, xm = _inputs(8)
    t = torch.from_numpy
    change = dict(change)
    axis_name = request.getfixturevalue("one_rank_group") if change.pop("axis_name", None) else None
    call = lambda: tc.cpd_lle(t(x), t(xm), t(y), torch.ones(M, dtype=torch.bool), torch.tensor(1e-3),
                              tc.CpdParams(**_base(), **change), axis_name=axis_name)
    got, refs = _run_both(x, xm, y, np.ones(M, bool), 1e-3, _base(**change))
    _assert_match(got, refs[:1], np.ones(M, bool))
    if axis_name is not None:
        periter = tc.cpd_lle(t(x), t(xm), t(y), torch.ones(M, dtype=torch.bool), torch.tensor(1e-3),
                             tc.CpdParams(**_base(solver="xla_lu")))
        assert torch.equal(call().y, periter.y)
        return
    assert torch.equal(call().y, got.y)


def test_cpd_params_have_no_kernel_switch():
    """The device alone picks kernel or plain version: no field selects it."""
    with pytest.raises(TypeError):
        tc.CpdParams(**_base(), use_pallas=True)


def test_return_deltas_on_point_axis(one_rank_group):
    """return_deltas on the point-sharded EM. With one rank
    and the visibility prior on, the sharded main pass (kernel N, the
    shards' minimum, the one-phase E-step) matches the unsharded
    per-iteration pass (the two-phase E-step, which sums the visibility
    weights over its 48 padded rows), deltas included."""
    y, x, xm = _inputs(8)
    t = torch.from_numpy
    params = tc.CpdParams(**_base(use_priors=True, alpha=PARAMS.alpha, use_visibility=True,
                                  k_vis=PARAMS.k_vis))
    kw = dict(prior_pos=t((y + 0.004).astype(np.float32)), prior_mask=torch.arange(M) < 12,
              visible_count=torch.tensor(30), return_deltas=True)
    args = (t(x), t(xm), t(y), torch.ones(M, dtype=torch.bool), torch.tensor(1e-3), params)
    sharded, d_sharded = tc.cpd_lle(*args, axis_name=one_rank_group, **kw)
    plain, d_plain = tc.cpd_lle(*args, **kw)
    assert d_sharded.shape == (3,)
    assert float((sharded.y - plain.y).abs().max()) <= TOL_M
    torch.testing.assert_close(d_sharded, d_plain, rtol=0, atol=TOL_M)


def test_wrapper_takes_plain_version_on_cpu():
    y, x, xm = _inputs(9)
    st = tc.em_staging(torch.from_numpy(x), torch.from_numpy(xm), torch.from_numpy(y),
                       torch.ones(M, dtype=torch.bool), torch.tensor(1e-3), tc.CpdParams(**_base()))
    a = fused_em_loop(*st.args, **st.kwargs)
    b = fused_em_loop_plain(*st.args, **st.kwargs)
    for u, v in zip(a, b):
        torch.testing.assert_close(u, v, rtol=0, atol=0)


PREREG_FRAMES = (3, 9, 24, 25)
_STAGED = ("dyn", "y0", "coord", "nm", "g", "hg", "hy0", "jg", "pd", "x", "xm")


def _prereg_frame(frame):
    """Kernel E's staged inputs of one pre-registration pass (saved by
    perf/port_em_probes.py phases --save-frames) and its loop constants."""
    from pathlib import Path

    d = np.load(Path(__file__).parent / "data" / "prereg_frames.npz")
    kw = dict(zip([str(k) for k in d["kwarg_names"]], d[f"f{frame}_kwargs"].tolist()))
    kw["max_iter"] = int(kw["max_iter"])
    return d, [d[f"f{frame}_{k}"] for k in _STAGED], kw


def _b1_trips(args, kw):
    """The JAX package's B1 (fused_em_loop, interpreted) on staged inputs,
    padded as its own staging pads them; its trips."""
    from trackdlo_tpu.ops.pallas_kernels import fused_em_loop as b1_loop, pack_points

    dyn, y0, coord, nm, g, hg, hy0, jg, pd, x, xm = (jnp.asarray(a) for a in args)
    m = y0.shape[0]
    m_pad = (m + 7) // 8 * 8
    pad = lambda v, cols: jnp.zeros((m_pad, cols), jnp.float32).at[:m, :v.shape[1]].set(v)
    sigma2, v_count, n_safe, gate = dyn
    muf = jnp.float32(kw["muf"])
    scal = jnp.broadcast_to(jnp.stack([sigma2, muf * v_count / n_safe, muf / n_safe, gate, v_count,
                                       0.0, 0.0, 0.0])[:, None], (8, 128))
    xt, xmp = pack_points(x, xm > 0)
    _, stats = b1_loop(scal, pad(y0, 3), pad(coord[:, None], 1), pad(nm[:, None], 1), pad(g, m_pad),
                       pad(hg, m_pad), pad(hy0, 3), pad(jg, m_pad), pad(pd, 3), xt, xmp,
                       k_vis=kw["k_vis"], tau_vis=kw["tau_vis"], lam=kw["lam"],
                       coef_lle=kw["coef_lle"], alpha=kw["alpha"], tol=kw["tol"],
                       max_iter=kw["max_iter"], interpret=True)
    return int(np.asarray(stats)[0, 1])


@pytest.mark.parametrize("frame", PREREG_FRAMES)
def test_prereg_frame_trips_of_plain_and_b1_follow_the_oracle(frame):
    """Kernel E's staged pre-registration inputs of frames 3, 9, 24 and 25 of
    chip_smoke.py's occluded loop, staged on the card from the float64
    oracle's state: the port's plain version and the JAX package's B1
    (interpreted) each take within one trip of the oracle's, and B1 the trips
    recorded beside the inputs."""
    d, args, kw = _prereg_frame(frame)
    oracle = int(d[f"f{frame}_oracle_trips"])
    plain = int(fused_em_loop_plain(*(torch.from_numpy(a) for a in args), **kw)[1][1])
    b1 = _b1_trips(args, kw)
    assert abs(plain - oracle) <= 1, (plain, oracle)
    assert abs(b1 - oracle) <= 1, (b1, oracle)
    assert b1 == int(d[f"f{frame}_b1_trips"])
