"""The port's shared numerics (trackdlo_tpu_torch.ops.kernels) against the
JAX twins and the float64 oracle, on seeded numpy inputs."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trackdlo_tpu.io.sequence import SyntheticRope
from trackdlo_tpu.oracle.lle import calc_lle_weights
from trackdlo_tpu_torch.ops import kernels as tk

jk = importlib.import_module("trackdlo_tpu.ops.kernels")

M = 45


def _chain(seed):
    rng = np.random.default_rng(seed)
    y = SyntheticRope().nodes(0.3 * seed, M) + rng.normal(0, 0.002, (M, 3))
    return y.astype(np.float32)


def _mask(valid):
    return np.arange(M) < valid


@pytest.mark.parametrize("seed", [0, 1])
def test_pairwise_and_geodesic_match_jax(seed):
    rng = np.random.default_rng(seed)
    y = _chain(seed)
    x = rng.uniform(-0.4, 0.4, (200, 3)).astype(np.float32)
    got = tk.pairwise_sq_dists(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    ref = np.asarray(jk.pairwise_sq_dists(jnp.asarray(y), jnp.asarray(x)))
    # Same difference form; the sum of three squares may round in another
    # order (1 ulp of ~0.5 m²).
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-7)
    g_t = tk.geodesic_coords(torch.from_numpy(y)).numpy()
    g_j = np.asarray(jk.geodesic_coords(jnp.asarray(y)))
    np.testing.assert_allclose(g_t, g_j, rtol=0, atol=1e-6)


@pytest.mark.parametrize("valid", [45, 30, 4])
def test_masked_geodesic_and_mct_match_jax(valid):
    y = _chain(valid)
    nm = _mask(valid)
    c_t = tk.masked_geodesic_coords(torch.from_numpy(y), torch.from_numpy(nm)).numpy()
    c_j = np.asarray(jk.masked_geodesic_coords(jnp.asarray(y), jnp.asarray(nm)))
    np.testing.assert_allclose(c_t, c_j, rtol=0, atol=1e-6)
    dis = np.abs(c_j[:, None] - c_j[None, :]).astype(np.float32)
    for beta in (0.35, 3.0):
        g_t = tk.mct_kernel(torch.from_numpy(dis), beta).numpy()
        g_j = np.asarray(jk.mct_kernel(jnp.asarray(dis), beta))
        # exp of the same argument: a few float32 ulps of G's scale.
        np.testing.assert_allclose(g_t, g_j, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("valid", [45, 20, 3])
def test_chain_lle_weights_match_jax_and_oracle(valid):
    y = _chain(valid + 7)
    nm = _mask(valid)
    w_t = tk.chain_lle_weights(torch.from_numpy(y), torch.from_numpy(nm)).numpy()
    w_j = np.asarray(jk.chain_lle_weights(jnp.asarray(y), jnp.asarray(nm)))
    # Same unrolled Gauss-Jordan on the same (M, 7, 7) systems, but the Gram
    # entries may sum their three products in another order (1 ulp), and the
    # 1e-5 ridge leaves the systems' condition near 1e2-1e3: weights of
    # order 1 agree to a few 1e-5.
    np.testing.assert_allclose(w_t, w_j, rtol=0, atol=5e-5)
    assert np.all(w_t[valid:] == 0)
    if valid >= 7:
        # The f64 oracle (its neighbourhoods need a chain of at least 2k+1
        # nodes): f32 solves of the Gram + 1e-5·I systems agree to ~1e-3 of
        # weights of order 1.
        w_o = calc_lle_weights(6, y[:valid].astype(np.float64))
        np.testing.assert_allclose(w_t[:valid, :valid], w_o, rtol=0, atol=2e-3)


def test_lle_regularizer_matches_jax():
    y = _chain(5)
    nm = _mask(38)
    h_t = tk.lle_regularizer(torch.from_numpy(y), torch.from_numpy(nm)).numpy()
    h_j = np.asarray(jk.lle_regularizer(jnp.asarray(y), jnp.asarray(nm)))
    np.testing.assert_allclose(h_t, h_j, rtol=0, atol=1e-4)
