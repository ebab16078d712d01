"""The batched multi-stream step: many cameras or ropes on one card.

Counterpart of trackdlo_tpu/parallel/sharding.py without the mesh: the
per-frame step over a leading stream axis (the JAX package's ``jax.vmap`` of
``_step_impl``). B frames take one launch of kernel P, B·8 channel rows one
of kernel C, B streams one of kernel V, 4·B walks one of kernel W, and each
EM pass runs B streams in lockstep through the batched E-step and the
batched Gauss-Jordan solve, one launch of each per iteration.

``cohort_size`` splits the batch into convergence cohorts that run one after
another, each with its own lockstep loops: a lockstep loop runs every stream
of it to its slowest stream's trip count, and the cohorts bound that tax.
A converged stream is frozen by select, so grouping changes no stream's
math. A cohort of one takes the single-stream step (kernel E's whole loop),
as the JAX package's axis-size-1 rule does.

The device mesh, point-axis sharding and ``build_parallel_step_fn`` are not
ported yet (ROADMAP item 11): they raise.
"""

from __future__ import annotations

import numpy as np
import torch

from trackdlo_tpu_torch.config import CameraIntrinsics, TrackerParams
from trackdlo_tpu_torch.device import resolve_device, set_full_fp32
from trackdlo_tpu_torch.models.trackdlo import (
    StepOutputs,
    TrackerState,
    _track_from_points,
    host_to_device,
    preprocess_for_step,
)
from trackdlo_tpu_torch.ops.preprocess import default_cell_px


def replicate_state(state: TrackerState, batch: int) -> TrackerState:
    """Tile a single-stream state along a new leading stream axis."""
    return TrackerState(*(v.unsqueeze(0).expand((batch,) + v.shape).contiguous() for v in state))


def make_tracking_mesh(*args, **kwargs):
    raise NotImplementedError("device meshes are not ported yet (ROADMAP item 11)")


def build_parallel_step_fn(*args, **kwargs):
    raise NotImplementedError("the point-sharded step is not ported yet (ROADMAP item 11)")


def build_batched_step_fn(params: TrackerParams, intr: CameraIntrinsics,
                          cohort_size: int | None = None, device=None):
    """The batched step ``step(state, rgb (B, H, W, 3) u8, depth (B, H, W)
    u16 mm, occ (B, H, W)) -> (state, outputs)``, a leading B axis on every
    field of both results. ``occ`` nonzero keeps a pixel; ``None`` keeps
    all. ``cohort_size`` must divide B. Runs on ``device`` (the CUDA card
    unless the caller names the CPU)."""
    dev = resolve_device(device)
    set_full_fp32()
    cell_px = params.downsample_cell_px or default_cell_px(params.downsample_leaf_size, intr.fx)
    proj = torch.as_tensor(np.array(intr.proj_matrix(), np.float32), device=dev)
    h, w = intr.height, intr.width

    def run(state: TrackerState, rgb, depth, occ):
        if state.y.shape[0] == 1:
            one = TrackerState(*(v[0] for v in state))
            pc = preprocess_for_step(rgb[0], depth[0], occ[0], params=params, intr=intr,
                                     cell_px=cell_px)
            new, out = _track_from_points(one, pc, proj, params=params, intr=intr)
            return TrackerState(*(v[None] for v in new)), StepOutputs(*(v[None] for v in out))
        pc = preprocess_for_step(rgb, depth, occ, params=params, intr=intr, cell_px=cell_px)
        return _track_from_points(state, pc, proj, params=params, intr=intr)

    def step(state: TrackerState, rgb, depth, occ=None):
        b = int(np.shape(rgb)[0])
        if tuple(np.shape(rgb)) != (b, h, w, 3) or tuple(np.shape(depth)) != (b, h, w):
            raise ValueError(f"rgb must be ({b}, {h}, {w}, 3) u8 and depth ({b}, {h}, {w}) u16")
        if tuple(state.y.shape) != (b, params.num_of_nodes, 3):
            raise ValueError(f"state.y must be ({b}, {params.num_of_nodes}, 3), "
                             f"got {tuple(state.y.shape)}")
        cs = b if cohort_size is None else cohort_size
        if b % cs:
            raise ValueError(f"batch {b} not divisible by cohort_size={cs}")
        rgb_t = host_to_device(rgb, dev)
        depth_t = host_to_device(depth, dev)
        if occ is None:
            occ_t = torch.ones((b, h, w), dtype=torch.bool, device=dev)
        else:
            occ_t = host_to_device(occ, dev) != 0
            if occ_t.ndim == 4:
                occ_t = occ_t.any(dim=-1)
            occ_t = occ_t.contiguous()
        outs = []
        for i in range(0, b, cs):
            sl = slice(i, i + cs)
            outs.append(run(TrackerState(*(v[sl] for v in state)), rgb_t[sl], depth_t[sl],
                            occ_t[sl]))
        if len(outs) == 1:
            return outs[0]
        states, results = zip(*outs)
        cat = lambda parts: [torch.cat(f) for f in zip(*parts)]
        return TrackerState(*cat(states)), StepOutputs(*cat(results))

    return step
