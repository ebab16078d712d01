"""Functions that run on the spawned ranks of the port's point-sharded tests
(tests/test_torch_shard_*.py, through trackdlo_tpu_torch.parallel.launch).

Each rank imports this module afresh, so it imports no JAX and nothing of
the JAX package: only torch, numpy and the port. Every function takes
(rank, world, device, ...) and returns plain numpy data."""

import sys
import time

import numpy as np
import torch

from trackdlo_tpu_torch.config import CameraIntrinsics, live_params
from trackdlo_tpu_torch.io.sequence import SyntheticRope, render_frame
from trackdlo_tpu_torch.models.trackdlo import init_state
from trackdlo_tpu_torch.ops import cpd_lle as tc
from trackdlo_tpu_torch.ops.collectives import shard_slice
from trackdlo_tpu_torch.parallel import (
    build_batched_step_fn,
    build_parallel_step_fn,
    make_tracking_mesh,
    replicate_state,
)

SMALL = CameraIntrinsics(fx=120.0, fy=120.0, cx=80.0, cy=60.0, width=160, height=120)


def _check_no_jax():
    bad = [k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib", "trackdlo_tpu")]
    if bad:
        raise RuntimeError(f"a rank imported {bad[:5]}")


def _np(t):
    return None if t is None else t.detach().cpu().numpy()


def cpd_cases(rank, world, device, cases):
    """cpd_lle on this rank's shard of each case's cloud, the point axis over
    every rank. A case is a dict of numpy inputs (x, xm, y, nm, sigma2,
    prior_pos, prior_mask, visible_count, point_min_sq; float32, or float64
    for a float64 run), ``params`` (the CpdParams fields) and
    ``return_deltas``."""
    _check_no_jax()
    group = make_tracking_mesh(model_parallel=world).model_group
    t = lambda a: None if a is None else torch.as_tensor(a, device=device)
    out = []
    for c in cases:
        sl = shard_slice(len(c["x"]), group)
        pmin, vc = c["point_min_sq"], c["visible_count"]
        res = tc.cpd_lle(
            t(c["x"][sl]), t(c["xm"][sl]), t(c["y"]), t(c["nm"]),
            torch.tensor(c["sigma2"], dtype=t(c["y"]).dtype, device=device),
            tc.CpdParams(**c["params"]), prior_pos=t(c["prior_pos"]),
            prior_mask=t(c["prior_mask"]),
            visible_count=None if vc is None else torch.tensor(vc, device=device),
            axis_name=group, point_min_sq=None if pmin is None else t(pmin[sl]),
            return_deltas=c["return_deltas"],
        )
        res, deltas = res if c["return_deltas"] else (res, None)
        out.append(dict(y=_np(res.y), sigma2=_np(res.sigma2), iterations=int(res.iterations),
                        converged=bool(res.converged), deltas=_np(deltas)))
    return out


def small_frames(batch, t=1 / 15.0):
    rope = SyntheticRope()
    fr = [render_frame(rope, t + 0.01 * b, SMALL, rope_pixel_radius=3) for b in range(batch)]
    occ = np.ones((batch, SMALL.height, SMALL.width), bool)
    return np.stack([f[0] for f in fr]), np.stack([f[1] for f in fr]), occ


_OUT_FIELDS = ("y", "sigma2", "occlusion_state", "visible_mask", "extended_mask",
               "not_self_occluded", "prior_mask", "points_mask", "n_points", "iterations",
               "guide_iterations")


def parallel_step(rank, world, device, params_kw, model_parallel, batch):
    """One step of ``build_parallel_step_fn`` on the small camera's frames,
    ``batch`` streams from the rope's first nodes, the mesh (world /
    model_parallel) × model_parallel. Returns this rank's data slice: the
    state's and outputs' fields, its place in the mesh, and per stream the
    valid points of its shard."""
    _check_no_jax()
    params = live_params(**params_kw)
    mesh = make_tracking_mesh(model_parallel=model_parallel)
    step = build_parallel_step_fn(params, SMALL, mesh, device=device)
    state0 = replicate_state(init_state(SyntheticRope().nodes(0.0, params.M), params, device), batch)
    state, out = step(state0, *small_frames(batch))
    res = {f: _np(getattr(out, f)) for f in _OUT_FIELDS}
    res.update(y=_np(state.y), sigma2=_np(state.sigma2), data_rank=mesh.data_rank,
               model_rank=mesh.model_rank)
    sl = shard_slice(out.points_mask.shape[-1], mesh.model_group)
    res["shard_counts"] = _np(out.points_mask[..., sl].sum(dim=-1))
    res["shard"] = (sl.start, sl.stop)
    return res


def uneven_cloud_raises(rank, world, device):
    """A cloud whose length the model axis does not divide: the sharded step
    raises on every rank (and so does shard_slice)."""
    _check_no_jax()
    mesh = make_tracking_mesh(model_parallel=world)
    params = live_params(max_points=255, downsample_cell_px=4)
    step = build_parallel_step_fn(params, SMALL, mesh, device=device)
    state0 = replicate_state(init_state(SyntheticRope().nodes(0.0, params.M), params, device), 1)
    messages = []
    for call in (lambda: shard_slice(255, mesh.model_group), lambda: step(state0, *small_frames(1))):
        try:
            call()
        except ValueError as e:
            messages.append(str(e))
    return messages


def data_parallel_step(rank, world, device, params_kw, batch):
    """``build_batched_step_fn`` with a pure-DP mesh over every rank against
    the unsharded batched step on the global batch: returns the largest
    difference of this rank's slice, for every state and output field."""
    _check_no_jax()
    params = live_params(**params_kw)
    mesh = make_tracking_mesh(model_parallel=1)
    frames = small_frames(batch)
    state0 = replicate_state(init_state(SyntheticRope().nodes(0.0, params.M), params, device), batch)
    ds, do = build_batched_step_fn(params, SMALL, mesh, device=device)(state0, *frames)
    gs, go = build_batched_step_fn(params, SMALL, device=device)(state0, *frames)
    per = batch // mesh.data_size
    sl = slice(mesh.data_rank * per, (mesh.data_rank + 1) * per)
    diffs = {f"state.{f}": float((getattr(ds, f) - getattr(gs, f)[sl]).abs().max())
             for f in ds._fields}
    for f in do._fields:
        a, b = getattr(do, f), getattr(go, f)[sl]
        diffs[f] = float((a.double() - b.double()).abs().max())
    return {"diffs": diffs, "streams": per}


def raise_on_rank_one(rank, world, device):
    if rank == 1:
        raise ValueError("rank one fails on purpose")
    return rank


def raise_then_peer_fails(rank, world, device):
    """Rank 1 raises at once; rank 0 then loses its peer in a collective."""
    if rank == 1:
        raise ValueError("rank one fails on purpose")
    torch.distributed.all_reduce(torch.zeros(1))
    return rank


def hang_on_rank_one(rank, world, device):
    if rank == 1:
        time.sleep(3600)
    return rank
