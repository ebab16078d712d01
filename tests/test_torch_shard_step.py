"""The port's mesh on the CPU: the DP × SP step over 4 gloo ranks (2 data × 2
model) against the JAX package's ``build_parallel_step_fn`` on its virtual
8-device mesh, the pure-DP batched step against the unsharded one, the
shards of the cloud, the JAX package's slice clamp (which the port does not
copy), the launcher and the dry run.

The ranks are spawned processes running tests/torch_shard_workers.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_shard_workers as workers
from trackdlo_tpu_torch.config import live_params
from trackdlo_tpu_torch.io.sequence import SyntheticRope
from trackdlo_tpu_torch.models.trackdlo import Tracker
from trackdlo_tpu_torch.parallel import make_tracking_mesh
from trackdlo_tpu_torch.parallel.launch import dryrun_multichip, pick_model_parallel, run_ranks

# tests/test_parallel.py's small profile.
SMALL_PROFILE = dict(max_points=256, downsample_cell_px=4)
# The small profile with a candidate capacity below max_points: the cloud is
# 128 rows long, as the live profile's (2048 of max_points 4096).
CAPPED_PROFILE = dict(SMALL_PROFILE, parity_candidate_cap=128)
# Per frame from one state, two float32 realisations of the same step
# (tests/test_torch_batched.py).
STEP_TOL_M = 5e-4
# The sharded step runs the per-iteration EM, Tracker.step kernel E's whole
# loop: the two routes' bound of tests/test_torch_batched.py.
ROUTES_TOL_M = 1e-4
RANK_TIMEOUT_S = 45.0
DP_SP_FIELDS = ("occlusion_state", "visible_mask", "extended_mask", "not_self_occluded",
                "prior_mask", "points_mask", "n_points")


@pytest.fixture(scope="module")
def dp_sp():
    """One step of 4 streams on 4 ranks, 2 data × 2 model; results in rank
    order (rank r: data r // 2, model r % 2)."""
    return run_ranks(workers.parallel_step, 4, device="cpu", timeout_s=RANK_TIMEOUT_S,
                     args=(SMALL_PROFILE, 2, 4))


def _jax_parallel_step(profile, model_parallel, batch):
    from trackdlo_tpu.config import live_params as jax_live
    from trackdlo_tpu.models.trackdlo import init_state as jax_init
    from trackdlo_tpu.parallel import build_parallel_step_fn, make_tracking_mesh, replicate_state

    params = jax_live(**profile)
    mesh = make_tracking_mesh(n_devices=batch * model_parallel, model_parallel=model_parallel)
    state = replicate_state(jax_init(SyntheticRope().nodes(0.0, params.M), params), batch)
    return build_parallel_step_fn(params, workers.SMALL, mesh)(
        state, *(jnp.asarray(a) for a in workers.small_frames(batch)))


def _jax_single_step(profile):
    from trackdlo_tpu.config import live_params as jax_live
    from trackdlo_tpu.models.trackdlo import Tracker as JaxTracker

    params = jax_live(**profile)
    tracker = JaxTracker(params, workers.SMALL)
    rgb, depth, _ = workers.small_frames(1)
    return tracker.step(tracker.init_from_nodes(SyntheticRope().nodes(0.0, params.M)), rgb[0],
                        depth[0])


def test_dp_sp_step_matches_jax(dp_sp):
    """4 ranks (2 data × 2 model) against the JAX package's DP × SP step on
    4 data × 2 model virtual devices, the same 4 streams, on its kernels'
    route (interpreted). At this profile most nodes self-occlude and the
    pre-registration pass runs on 2 guide nodes, where the JAX package's XLA
    iteration wraps an anchor row that its kernels (and the port) read as 0
    (ROADMAP §C): there its XLA route is 9e-4 m from its kernels' route,
    sharded or not."""
    js, jo = _jax_parallel_step(dict(SMALL_PROFILE, use_pallas_estep=True), 2, 4)
    for r in dp_sp:
        sl = slice(2 * r["data_rank"], 2 * r["data_rank"] + 2)
        for f in DP_SP_FIELDS:
            np.testing.assert_array_equal(r[f], np.asarray(getattr(jo, f))[sl], err_msg=f)
        assert np.abs(r["y"] - np.asarray(js.y)[sl]).max() <= STEP_TOL_M


def test_dp_sp_model_ranks_are_bit_equal(dp_sp):
    for a, b in ((dp_sp[0], dp_sp[1]), (dp_sp[2], dp_sp[3])):
        assert (a["data_rank"], a["model_rank"], b["model_rank"]) == (b["data_rank"], 0, 1)
        for f in ("y", "sigma2", "iterations", "guide_iterations"):
            assert np.array_equal(a[f], b[f]), f
    assert not np.array_equal(dp_sp[0]["y"], dp_sp[2]["y"])


def test_every_point_in_exactly_one_shard(dp_sp):
    for a, b in ((dp_sp[0], dp_sp[1]), (dp_sp[2], dp_sp[3])):
        n = a["points_mask"].shape[-1]
        assert a["shard"] == (0, n // 2) and b["shard"] == (n // 2, n)
        np.testing.assert_array_equal(a["shard_counts"] + b["shard_counts"], a["n_points"])


def test_pure_dp_mesh_is_bit_equal_to_the_unsharded_batched_step():
    out = run_ranks(workers.data_parallel_step, 2, device="cpu", timeout_s=RANK_TIMEOUT_S,
                    args=(SMALL_PROFILE, 4))
    for r in out:
        assert r["streams"] == 2
        assert all(v == 0.0 for v in r["diffs"].values()), r["diffs"]


def test_a_cloud_the_model_axis_does_not_divide_raises():
    for messages in run_ranks(workers.uneven_cloud_raises, 2, device="cpu", timeout_s=RANK_TIMEOUT_S):
        assert len(messages) == 2
        assert all("not divisible" in m for m in messages)


def test_the_port_does_not_copy_the_reference_slice_clamp():
    """The JAX package slices the cloud by max_points // n_shards
    (models/trackdlo.py:249-258). At a candidate capacity below max_points
    the cloud is shorter than that, rank 1's slice start is clamped to 0, and
    every point of rank 0's slice counts twice: the JAX sharded step moves
    far from its own unsharded step. The port slices by the cloud's length:
    each point in one shard, and the sharded step stays within the route
    bound of the port's Tracker.step."""
    gaps = {}
    for name, profile in (("capped", CAPPED_PROFILE), ("uncapped", SMALL_PROFILE)):
        js, jo = _jax_parallel_step(profile, 2, 1)
        single, _ = _jax_single_step(profile)
        gaps[name] = float(np.abs(np.asarray(js.y[0]) - np.asarray(single.y)).max())
        if name == "capped":
            assert jo.points.shape[-2] == 128
    assert gaps["capped"] >= 10 * gaps["uncapped"], gaps

    ranks = run_ranks(workers.parallel_step, 2, device="cpu", timeout_s=RANK_TIMEOUT_S,
                      args=(CAPPED_PROFILE, 2, 1))
    params = live_params(**CAPPED_PROFILE)
    tracker = Tracker(params, workers.SMALL, device="cpu")
    rgb, depth, _ = workers.small_frames(1)
    single, out = tracker.step(tracker.init_from_nodes(SyntheticRope().nodes(0.0, params.M)),
                               rgb[0], depth[0])
    assert out.points.shape[-2] == 128
    assert sum(int(r["shard_counts"][0]) for r in ranks) == int(out.n_points)
    for r in ranks:
        assert np.abs(r["y"][0] - single.y.numpy()).max() <= ROUTES_TOL_M
    assert np.array_equal(ranks[0]["y"], ranks[1]["y"])


def test_run_ranks_raises_when_a_rank_fails():
    with pytest.raises(RuntimeError, match="rank one fails on purpose"):
        run_ranks(workers.raise_on_rank_one, 2, device="cpu", timeout_s=RANK_TIMEOUT_S)


def test_run_ranks_names_the_rank_that_raised_first():
    """Rank 1 raises; rank 0's collective then fails for want of its peer.
    The message leads with rank 1, whose failure caused rank 0's."""
    with pytest.raises(RuntimeError, match="rank 1 raised first") as info:
        run_ranks(workers.raise_then_peer_fails, 2, device="cpu", timeout_s=RANK_TIMEOUT_S)
    assert "rank one fails on purpose" in str(info.value).split("then rank")[0]


def test_run_ranks_kills_a_rank_that_hangs():
    with pytest.raises(RuntimeError, match="timed out"):
        run_ranks(workers.hang_on_rank_one, 2, device="cpu", timeout_s=10.0)


def test_run_ranks_defaults_to_the_card(monkeypatch):
    """As every entry point of the port: no device named is the card, and
    without one run_ranks raises before it spawns a rank."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_ranks(workers.raise_on_rank_one, 2, timeout_s=RANK_TIMEOUT_S)


def test_make_tracking_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        make_tracking_mesh()


def test_pick_model_parallel():
    assert [pick_model_parallel(n) for n in (1, 3, 4, 6, 7, 8)] == [1, 3, 2, 2, 1, 2]


def test_dryrun_multichip(capsys):
    dryrun_multichip(4)
    assert "dryrun_multichip OK (4 gloo ranks, model_parallel 2)" in capsys.readouterr().out
