"""The port's point-sharded EM on the CPU: kernel N's plain version against
the JAX package's ``nearest_point_sq`` (interpret mode), and ``cpd_lle``
with its cloud split over 2 gloo ranks (spawned processes,
tests/torch_shard_workers.py) against the JAX package's ``cpd_lle`` under
``jax.shard_map`` over 2 of the 8 virtual CPU devices, on both of its
routes: the interpreted kernels (``use_pallas=True``: kernel B9, then the
one-phase E-step B6) and the XLA iteration.

Inputs are seeded numpy arrays handed to both packages."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import torch_shard_workers as workers
from trackdlo_tpu_torch.config import live_params
from trackdlo_tpu_torch.io.sequence import SyntheticRope
from trackdlo_tpu_torch.ops import collectives
from trackdlo_tpu_torch.ops.hopper_kernels import nearest_point_sq, nearest_point_sq_plain
from trackdlo_tpu_torch.parallel.launch import run_ranks

jc = importlib.import_module("trackdlo_tpu.ops.cpd_lle")
jpk = importlib.import_module("trackdlo_tpu.ops.pallas_kernels")

M = 45
N_CAP = 256
PARAMS = live_params()
# Three EM iterations, two float32 implementations: the em3 bound.
TOL_M = 1e-6
# The pre-registration systems (cond(A) near 4e6) amplify any rounding
# difference: the JAX package's own two routes differ by 1.7e-5 m after three
# iterations (tests/test_torch_em.py), and its sharded pass differs from its
# unsharded one by up to 7e-5 m on these inputs. The port is held to 5e-5 m
# or, where the JAX package's four realisations (sharded or not, kernels or
# XLA) spread wider on the same input, to that spread.
TOL_PREREG_M = 5e-5
# The live pre-registration pass runs on the extended-visible guide nodes,
# prefix-packed: the "guides30" cases hold 30 of the 45. That pass has a
# branch within rounding of its input: under 1e-7 m nudges of the cloud the
# JAX package's own sharded pass lands either within 2e-5 m of the float64
# solution or ~1.5e-4 m from it, as the port's does on the cloud itself. The
# port is held to the nearest of the reference's realisations on the cloud
# and on its nudges, and float64 runs of both packages witness that the
# sharded sums are exact but for rounding.
GUIDES = 30
NUDGES = 4
NUDGE_M = 1e-7
RANK_TIMEOUT_S = 45.0


def _inputs(seed, n_valid=200):
    """Nodes of the rope at t=0 and a noisy cloud along it at t=1/15; the
    valid points fill the first shard and part of the second."""
    rng = np.random.default_rng(seed)
    rope = SyntheticRope()
    y = rope.nodes(0.0, M).astype(np.float32)
    curve = rope.curve(1 / 15.0)
    x = np.zeros((N_CAP, 3), np.float32)
    x[:n_valid] = curve[rng.integers(0, len(curve), n_valid)] + rng.normal(0, 0.002, (n_valid, 3))
    return y, x, np.arange(N_CAP) < n_valid


# ---------------------------------------------------------------------------
# Kernel N's plain version against the JAX package's kernel.
# ---------------------------------------------------------------------------


def _nearest_case(seed, case):
    y, x, xm = _inputs(seed)
    nm = np.ones(M, bool)
    if case in ("masked_nodes", "stream_axis"):
        nm[30:] = False
        nm[3] = False
    if case == "empty_cloud":
        xm = np.zeros_like(xm)
    if case == "far_points":
        x = x + np.float32(400.0)  # beyond the 1e5 m² sentinel
    return y, nm, x, xm


@pytest.mark.parametrize("case", ["rope", "masked_nodes", "empty_cloud", "far_points"])
def test_nearest_plain_matches_jax_kernel(case):
    y, nm, x, xm = _nearest_case(1, case)
    got = nearest_point_sq_plain(*(torch.from_numpy(a) for a in (y, nm, x, xm)))
    ref = np.asarray(jpk.nearest_point_sq(jnp.asarray(y), jnp.asarray(nm), jnp.asarray(x),
                                          jnp.asarray(xm), interpret=True))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=0)
    assert (got.numpy()[~nm] == 1e5).all()
    if case in ("empty_cloud", "far_points"):
        assert (got.numpy() == 1e5).all()


def test_nearest_stream_axis_matches_jax_vmap():
    cases = [_nearest_case(s, c) for s, c in ((2, "rope"), (3, "stream_axis"), (4, "empty_cloud"))]
    y, nm, x, xm = (np.stack(a) for a in zip(*cases))
    got = nearest_point_sq(*(torch.from_numpy(a) for a in (y, nm, x, xm)))
    kern = jax.vmap(lambda *a: jpk.nearest_point_sq(*a, interpret=True))
    ref = np.asarray(kern(*(jnp.asarray(a) for a in (y, nm, x, xm))))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=0)
    for b in range(3):
        one = nearest_point_sq(*(torch.from_numpy(a[b]) for a in (y, nm, x, xm)))
        assert torch.equal(one, got[b])


def test_collectives_without_a_group_are_the_identity():
    t = torch.arange(6.0).reshape(2, 3)
    assert collectives.psum(t, None) is t
    assert collectives.pmin(t, None) is t
    assert collectives.shard_slice(7, None) == slice(0, 7)


# ---------------------------------------------------------------------------
# Sharded cpd_lle over 2 gloo ranks against jax.shard_map.
# ---------------------------------------------------------------------------


def _base(**kw):
    p = PARAMS
    base = dict(beta=p.beta, lam=p.lam, lle_weight=p.lle_weight, mu=p.mu, max_iter=3, tol=0.0,
                include_lle=False, visibility_threshold=p.visibility_threshold,
                prune_radius=p.prune_radius)
    base.update(kw)
    return base


PRIORS_GATE = dict(use_priors=True, alpha=PARAMS.alpha, use_visibility=True, k_vis=PARAMS.k_vis)


def _case(name):
    """name -> (case dict for the ranks, bound)."""
    y, x, xm = _inputs(11)
    nm = np.ones(M, bool)
    if name.startswith("prereg_guides30"):
        nm = np.arange(M) < GUIDES
        y = np.where(nm[:, None], y, 0).astype(np.float32)
    case = dict(x=x, xm=xm, y=y, nm=nm, sigma2=PARAMS.sigma2_init, prior_pos=None,
                prior_mask=None, visible_count=None, return_deltas=False,
                point_min_sq=((y[nm][:, None] - x[None]) ** 2).sum(-1).min(0).astype(np.float32))
    tol = TOL_M
    if name.startswith("prereg"):
        # The pre-registration pass's parameters, as tests/test_torch_em.py
        # holds the unsharded pass to them.
        case.update(params=_base(include_lle=True, beta=PARAMS.beta_pre_proc,
                                 lam=PARAMS.lambda_pre_proc))
        tol = TOL_PREREG_M
    elif name == "lle":
        case.update(params=_base(include_lle=True))
    elif name in ("priors_gate", "priors_gate_deltas"):
        case.update(params=_base(**PRIORS_GATE), prior_pos=(y + 0.004).astype(np.float32),
                    prior_mask=np.arange(M) < 12, visible_count=30,
                    return_deltas=name.endswith("deltas"))
    elif name == "gaussian":
        # A prototype E-step variant: the XLA iteration, with the gate on.
        case.update(params=_base(kernel="gaussian_geodesic", **PRIORS_GATE),
                    prior_pos=(y + 0.004).astype(np.float32), prior_mask=np.arange(M) < 12,
                    visible_count=30)
    elif name == "sigma2_zero":
        # No point minima and σ² = 0: the σ² init's sum crosses the shards.
        case.update(params=_base(), sigma2=0.0, point_min_sq=None)
    if name.endswith("_f64"):
        case.update({k: case[k].astype(np.float64) for k in ("x", "y", "point_min_sq")})
    return case, tol


CASES = ["prereg", "prereg_guides30", "lle", "priors_gate", "priors_gate_deltas", "gaussian",
         "sigma2_zero"]
# Run on the ranks for the float64 witness only.
WITNESSES = ["prereg_guides30_f64"]


@pytest.fixture(scope="module")
def sharded():
    """Every case through the port on 2 gloo ranks (one launch of the
    ranks): {name: [rank 0 result, rank 1 result]}."""
    names = CASES + WITNESSES
    cases = [_case(n)[0] for n in names]
    per_rank = run_ranks(workers.cpd_cases, 2, device="cpu", timeout_s=RANK_TIMEOUT_S, args=(cases,))
    return {n: [r[i] for r in per_rank] for i, n in enumerate(names)}


def _jax_sharded(case, use_pallas):
    """The JAX package's cpd_lle under shard_map, the points split over a
    2-device ``model`` axis."""
    from jax import shard_map

    mesh = Mesh(np.array(jax.devices()[:2]), ("model",))
    j = lambda a: None if a is None else jnp.asarray(a)
    params = jc.CpdParams(**case["params"], use_pallas=use_pallas)
    vc = None if case["visible_count"] is None else jnp.int32(case["visible_count"])

    def local(x, xm, *pmin):
        return jc.cpd_lle(x, xm, j(case["y"]), j(case["nm"]), jnp.float32(case["sigma2"]), params,
                          prior_pos=j(case["prior_pos"]), prior_mask=j(case["prior_mask"]),
                          visible_count=vc, axis_name="model",
                          point_min_sq=pmin[0] if pmin else None,
                          return_deltas=case["return_deltas"])

    args = [j(case["x"]), j(case["xm"])]
    if case["point_min_sq"] is not None:
        args.append(j(case["point_min_sq"]))
    fn = shard_map(local, mesh=mesh, in_specs=tuple(P("model") for _ in args), out_specs=P(),
                   check_vma=False)
    out = jax.jit(fn)(*args)
    return out if case["return_deltas"] else (out, None)


def _nudged(case):
    """The case with its cloud nudged by NUDGE_M, NUDGES times (seeded)."""
    rng = np.random.default_rng(0)
    return [dict(case, x=(case["x"] + rng.normal(0, NUDGE_M, case["x"].shape)).astype(np.float32))
            for _ in range(NUDGES)]


@pytest.fixture(scope="module")
def guides30_jax():
    """The JAX package's sharded 30-guide pass on each route, on the cloud
    and on its nudges: {route: [(result, deltas), ...]}."""
    case, _ = _case("prereg_guides30")
    return {route: [_jax_sharded(c, route != "xla") for c in [case] + _nudged(case)]
            for route in ("xla", "interpreted_kernels")}


def _jax_spread(case):
    """The largest distance between the JAX package's four realisations of
    the pass: sharded or not, kernels or XLA."""
    j = jnp.asarray
    ys = [np.asarray(_jax_sharded(case, up)[0].y) for up in (False, True)]
    for up in (False, True):
        ys.append(np.asarray(jc.cpd_lle(
            j(case["x"]), j(case["xm"]), j(case["y"]), j(case["nm"]), jnp.float32(case["sigma2"]),
            jc.CpdParams(**case["params"], use_pallas=up),
            point_min_sq=j(case["point_min_sq"])).y))
    return max(float(np.abs(a - b).max()) for a in ys for b in ys)


@pytest.mark.parametrize("jax_route", ["xla", "interpreted_kernels"])
@pytest.mark.parametrize("name", CASES)
def test_sharded_cpd_lle_matches_jax_shard_map(sharded, name, jax_route, request):
    case, tol = _case(name)
    got = sharded[name][0]
    nm = case["nm"]
    if name == "prereg_guides30":
        refs = request.getfixturevalue("guides30_jax")[jax_route]
        ref, ref_deltas = min(refs, key=lambda r: np.abs(got["y"] - np.asarray(r[0].y))[nm].max())
    else:
        ref, ref_deltas = _jax_sharded(case, jax_route != "xla")
    assert got["iterations"] == int(ref.iterations) == 3
    assert got["converged"] == bool(ref.converged)
    if name == "prereg":
        tol = max(tol, _jax_spread(case))
    err = np.abs(got["y"] - np.asarray(ref.y))
    assert err[nm].max() <= tol, (err[nm].max(), tol)
    np.testing.assert_array_equal(got["y"][~nm], np.asarray(ref.y)[~nm])
    # As tests/test_torch_em.py: σ² is a difference of traces near 100 m².
    np.testing.assert_allclose(float(got["sigma2"]), float(ref.sigma2), rtol=0, atol=2e-7)
    if case["return_deltas"]:
        assert got["deltas"].shape == (3,)
        # Each mean node move is within the nodes' own bound.
        np.testing.assert_allclose(got["deltas"], np.asarray(ref_deltas), rtol=0, atol=TOL_M)


@pytest.mark.parametrize("name", CASES)
def test_sharded_cpd_lle_is_bit_equal_across_ranks(sharded, name):
    a, b = sharded[name]
    for k in ("y", "sigma2", "deltas"):
        if a[k] is not None:
            assert np.array_equal(a[k], b[k]), k
    assert a["iterations"] == b["iterations"]


def test_sharded_cpd_lle_matches_the_unsharded_port(sharded):
    """The sharded main pass (kernel N, the shards' minimum, the one-phase
    E-step) against the port's unsharded per-iteration route (the two-phase
    E-step) on the whole cloud, with return_deltas."""
    from trackdlo_tpu_torch.ops import cpd_lle as tc

    case, _ = _case("priors_gate_deltas")
    t = lambda a: torch.from_numpy(np.asarray(a))
    res, deltas = tc.cpd_lle(t(case["x"]), t(case["xm"]), t(case["y"]), t(case["nm"]),
                             torch.tensor(case["sigma2"]), tc.CpdParams(**case["params"]),
                             prior_pos=t(case["prior_pos"]), prior_mask=t(case["prior_mask"]),
                             visible_count=torch.tensor(30), point_min_sq=t(case["point_min_sq"]),
                             return_deltas=True)
    got = sharded["priors_gate_deltas"][0]
    assert np.abs(got["y"] - res.y.numpy()).max() <= TOL_M
    np.testing.assert_allclose(got["deltas"], deltas.numpy(), rtol=0, atol=TOL_M)


def test_sharded_prereg_on_30_guides_against_float64(sharded, guides30_jax):
    """The witness for the 30-guide pass, after three iterations: float64
    plain versions of both packages agree, and the port's sharded pass in
    float64 matches them, so splitting the sums over the ranks is exact but
    for rounding. In float32 the port's unsharded per-iteration route is
    within TOL_PREREG_M of float64, and the JAX package's own sharded pass
    lands 1e-4 m or more from float64 on a nudge of the cloud, as the
    port's does on the cloud itself (1.5e-4 m): a branch of the pass under
    rounding, not a fault of the sharding."""
    from trackdlo_tpu_torch.ops import cpd_lle as tc

    case, _ = _case("prereg_guides30")
    nm = case["nm"]
    d = lambda a, b: float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))[nm].max())
    f64 = lambda a: np.asarray(a, np.float64)
    with jax.enable_x64(True):
        ref64 = jc.cpd_lle(jnp.asarray(f64(case["x"])), jnp.asarray(case["xm"]),
                           jnp.asarray(f64(case["y"])), jnp.asarray(nm),
                           jnp.float64(case["sigma2"]),
                           jc.CpdParams(**case["params"], use_pallas=False),
                           point_min_sq=jnp.asarray(f64(case["point_min_sq"]))).y
        assert ref64.dtype == jnp.float64
    t = lambda a: torch.from_numpy(np.asarray(a))
    port64 = tc.cpd_lle(t(f64(case["x"])), t(case["xm"]), t(f64(case["y"])), t(nm),
                        torch.tensor(case["sigma2"], dtype=torch.float64),
                        tc.CpdParams(**dict(case["params"], solver="xla_lu")),
                        point_min_sq=t(f64(case["point_min_sq"]))).y
    assert port64.dtype == torch.float64
    assert d(port64, ref64) <= 1e-12
    assert d(sharded["prereg_guides30_f64"][0]["y"], ref64) <= 1e-9
    # The port's unsharded per-iteration route (return_deltas takes it).
    periter, _ = tc.cpd_lle(t(case["x"]), t(case["xm"]), t(case["y"]), t(nm),
                            torch.tensor(case["sigma2"]), tc.CpdParams(**case["params"]),
                            point_min_sq=t(case["point_min_sq"]), return_deltas=True)
    assert d(periter.y, ref64) <= TOL_PREREG_M
    jax_far = max(d(r[0].y, ref64) for refs in guides30_jax.values() for r in refs)
    assert jax_far >= 1e-4
