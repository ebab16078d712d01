"""Multi-stream tracking: batched streams on one card, and the (data × model)
mesh over ``torch.distributed`` ranks.

Counterpart of trackdlo_tpu/parallel/sharding.py. The batched step is the
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
as the JAX package's axis-size-1 rule does. On the card each cohort is a
CUDA graph of its own (the JAX package jits every cohort into one
program): the cohorts share no data on the card, so cohort k's replay is
enqueued before the host writes cohort k+1's frames, and the card runs the
one while the host writes the other (:func:`replay_cohorts`).

The mesh: one process per rank, ranks laid out data-major as the JAX
package's device grid (rank r is data index r // model_parallel, model
index r % model_parallel). Streams are split over ``data``; with
:func:`build_parallel_step_fn` each stream's cloud is also split over
``model``, whose ranks reduce the EM's sums and minima with all-reduces
(:mod:`trackdlo_tpu_torch.ops.collectives`). Every step takes the global
batch of frames and returns this rank's data slice, the counterpart of the
shard a device holds. :mod:`trackdlo_tpu_torch.parallel.launch` starts the
ranks.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from trackdlo_tpu_torch.config import CameraIntrinsics, TrackerParams
from trackdlo_tpu_torch.device import resolve_device, set_full_fp32
from trackdlo_tpu_torch.models.trackdlo import (
    BATCH_EAGER_SOLVERS,
    CompiledStep,
    StepOutputs,
    TrackerState,
    _copy_outputs,
    _track_from_points,
    host_to_device,
    preprocess_for_step,
    step_shapes,
)
from trackdlo_tpu_torch.ops.preprocess import default_cell_px
from trackdlo_tpu_torch.utils import profiling


def replicate_state(state: TrackerState, batch: int) -> TrackerState:
    """Tile a single-stream state along a new leading stream axis."""
    return TrackerState(*(v.unsqueeze(0).expand((batch,) + v.shape).contiguous() for v in state))


@dataclasses.dataclass(frozen=True)
class TrackingMesh:
    """This rank's place in a (data × model) mesh of processes."""

    data_size: int
    model_size: int
    data_rank: int
    model_rank: int
    model_group: dist.ProcessGroup  # the ranks that share this rank's streams


def make_tracking_mesh(n_devices: int | None = None, model_parallel: int = 1) -> TrackingMesh:
    """A (data × model) mesh over the ranks of the initialised default
    process group (``n_devices``, when given, must be its size). Every rank
    must call it, in the same order as its other group calls."""
    if not dist.is_initialized():
        raise RuntimeError("make_tracking_mesh needs an initialised default process group "
                           "(torch.distributed.init_process_group, or parallel.launch.run_ranks)")
    world, rank = dist.get_world_size(), dist.get_rank()
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"n_devices={n_devices} but the process group has {world} ranks")
    if model_parallel < 1 or n % model_parallel:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
    model_group = None
    for d in range(n // model_parallel):
        ranks = list(range(d * model_parallel, (d + 1) * model_parallel))
        group = dist.new_group(ranks)
        if rank in ranks:
            model_group = group
    return TrackingMesh(n // model_parallel, model_parallel, rank // model_parallel,
                        rank % model_parallel, model_group)


def replay_cohorts(steps: list, state: TrackerState, rgb, depth, occ, replayed):
    """A frame set through one captured step a cohort (``steps``: each a
    :class:`~trackdlo_tpu_torch.models.trackdlo.CompiledStep` over B /
    len(steps) streams), in stream order. Cohort k's replay is enqueued
    before cohort k+1's frames are written into its host buffers, and
    nothing waits for that replay meanwhile: the host writes while the card
    runs. The states and outputs are copied out of the graphs' pools,
    concatenated in stream order (cloned where there is one cohort), and
    each step is then released. ``replayed``: an event that
    :func:`~trackdlo_tpu_torch.utils.profiling.mark` records after each
    replay while the span recorder is on, for its overlap counters
    (:func:`~trackdlo_tpu_torch.utils.profiling.overlap`). Call on the
    steps' device."""
    cs = int(np.shape(rgb)[0]) // len(steps)
    outs, behind = [], None
    for k, cohort_step in enumerate(steps):
        sl = slice(k * cs, (k + 1) * cs)
        with profiling.cohort(k):  # a capture at the first call stamps cohort k
            staged = cohort_step.load(TrackerState(*(v[sl] for v in state)), rgb[sl], depth[sl],
                                      occ[sl])
            profiling.overlap(staged, behind)
            outs.append(cohort_step.replay())
        behind = profiling.mark(replayed)
    with profiling.span("step.copy_out"):
        result = _copy_outputs(*outs)
    for cohort_step in steps:
        cohort_step.release()
    return result


def _make_step(params: TrackerParams, intr: CameraIntrinsics, cohort_size, mesh, model_axis,
               device, jit=False):
    dev = resolve_device(device)
    set_full_fp32()
    cell_px = params.downsample_cell_px or default_cell_px(params.downsample_leaf_size, intr.fx)
    proj = torch.as_tensor(np.array(intr.proj_matrix(), np.float32), device=dev)
    h, w = intr.height, intr.width
    kw = dict(params=params, intr=intr, model_axis=model_axis)
    compiled: dict[int, tuple[list[CompiledStep], torch.cuda.Event]] = {}
    ones: dict[int, torch.Tensor] = {}

    def run(state: TrackerState, rgb, depth, occ):
        if state.y.shape[0] == 1:
            one = TrackerState(*(v[0] for v in state))
            pc = preprocess_for_step(rgb[0], depth[0], occ[0], params=params, intr=intr,
                                     cell_px=cell_px)
            new, out = _track_from_points(one, pc, proj, **kw)
            return TrackerState(*(v[None] for v in new)), StepOutputs(*(v[None] for v in out))
        pc = preprocess_for_step(rgb, depth, occ, params=params, intr=intr, cell_px=cell_px)
        return _track_from_points(state, pc, proj, **kw)

    def run_cohorts(state: TrackerState, rgb_t, depth_t, occ_t, cs: int):
        """The frame set on the device, the cohorts one after another."""
        outs = []
        for i in range(0, rgb_t.shape[0], cs):
            sl = slice(i, i + cs)
            with profiling.cohort(i // cs):
                outs.append(run(TrackerState(*(v[sl] for v in state)), rgb_t[sl], depth_t[sl],
                                occ_t[sl]))
        return outs[0] if len(outs) == 1 else _copy_outputs(*outs)

    def step(state: TrackerState, rgb, depth, occ=None):
        with profiling.root():
            graph = (jit and dev.type == "cuda" and model_axis is None
                     and params.solver not in BATCH_EAGER_SOLVERS)
            with profiling.span("step.prepare"):
                state, rgb, depth, occ, b = checked(state, rgb, depth, occ)
                cs = b if cohort_size is None else cohort_size
                if graph:
                    if occ is None:
                        if b not in ones:
                            ones[b] = torch.ones((b, h, w), dtype=torch.bool, device=dev)
                        occ = ones[b]
                    if b not in compiled:  # one graph a cohort; their copies beside the replays
                        copy = torch.cuda.Stream(dev) if b > cs else None
                        compiled[b] = ([CompiledStep(run, dev, step_shapes(params, intr, cs), copy)
                                        for _ in range(b // cs)], torch.cuda.Event())
            if graph:  # the masks as given: made bool in the graph step's copy
                with torch.cuda.device(dev):
                    return replay_cohorts(compiled[b][0], state, rgb, depth, occ, compiled[b][1])
            rgb_t = host_to_device(rgb, dev)
            depth_t = host_to_device(depth, dev)
            if occ is None:
                occ_t = torch.ones((b, h, w), dtype=torch.bool, device=dev)
            else:
                occ_t = host_to_device(occ, dev) != 0
                if occ_t.ndim == 4:
                    occ_t = occ_t.any(dim=-1)
                occ_t = occ_t.contiguous()
            return run_cohorts(state, rgb_t, depth_t, occ_t, cs)

    def checked(state: TrackerState, rgb, depth, occ):
        """The shapes checked, and with a mesh this rank's data slice."""
        b = int(np.shape(rgb)[0])
        if tuple(np.shape(rgb)) != (b, h, w, 3) or tuple(np.shape(depth)) != (b, h, w):
            raise ValueError(f"rgb must be ({b}, {h}, {w}, 3) u8 and depth ({b}, {h}, {w}) u16")
        if mesh is not None:
            if b % mesh.data_size:
                raise ValueError(f"batch {b} not divisible by the mesh's data size {mesh.data_size}")
            per = b // mesh.data_size
            sl = slice(mesh.data_rank * per, (mesh.data_rank + 1) * per)
            rgb, depth = rgb[sl], depth[sl]
            occ = None if occ is None else occ[sl]
            if state.y.shape[0] == b:
                state = TrackerState(*(v[sl] for v in state))
            b = per
        if tuple(state.y.shape) != (b, params.num_of_nodes, 3):
            raise ValueError(f"state.y must be ({b}, {params.num_of_nodes}, 3), "
                             f"got {tuple(state.y.shape)}")
        if b % (b if cohort_size is None else cohort_size):
            raise ValueError(f"batch {b} not divisible by cohort_size={cohort_size}")
        return state, rgb, depth, occ, b

    return step


def build_batched_step_fn(params: TrackerParams, intr: CameraIntrinsics,
                          mesh: TrackingMesh | None = None, cohort_size: int | None = None,
                          device=None, jit: bool = True):
    """The batched step ``step(state, rgb (B, H, W, 3) u8, depth (B, H, W)
    u16 mm, occ (B, H, W)) -> (state, outputs)``, a leading B axis on every
    field of both results. ``occ`` nonzero keeps a pixel; ``None`` keeps
    all. ``cohort_size`` must divide B (with a mesh, this rank's slice).
    Runs on ``device`` (the CUDA card unless the caller names the CPU).

    With a ``mesh`` (pure data parallelism): the frames are the global batch
    and this rank steps its data slice of it, B / data size streams, and
    returns their state and outputs; ``state`` is the global batch's or this
    slice's. Ranks of one model group step the same streams.

    On a CUDA device with ``jit`` (the default, as the JAX package's
    ``jax.jit``): each cohort is captured at the first call for each batch
    size as a CUDA graph of its own
    (:class:`~trackdlo_tpu_torch.models.trackdlo.CompiledStep`, its EM loops
    conditional WHILE nodes whose trips the card decides) over static
    (C, H, W, 3), (C, H, W) and (C, …) state buffers of the cohort's C
    streams, and the cohorts are replayed one after another, each enqueued
    before the host writes the next one's frames (:func:`replay_cohorts`;
    with more than one cohort, the copies of the frames run on a stream of
    their own, beside the previous cohort's replay); the results are copies
    out of the graphs' pools, concatenated in stream order. One cohort is
    one graph over the whole batch. With a mesh the slice is taken on the
    host before the copy in. ``jit=False``, the CPU or a solver of
    ``models.trackdlo.BATCH_EAGER_SOLVERS``: the eager step."""
    return _make_step(params, intr, cohort_size, mesh, None, device, jit)


def build_parallel_step_fn(params: TrackerParams, intr: CameraIntrinsics, mesh: TrackingMesh,
                           device=None):
    """The DP × SP step: as :func:`build_batched_step_fn` with a mesh, and
    each stream's cloud split over the mesh's ``model`` ranks, whose EM
    passes reduce with all-reduces. Every rank of the model group returns
    the same state and outputs. The cloud's length (``params.max_points``,
    or the candidate capacity below it) must be divisible by the model
    size. It runs eagerly: its all-reduces go through gloo on the host
    (:mod:`~trackdlo_tpu_torch.ops.collectives`), which no CUDA graph
    holds."""
    return _make_step(params, intr, None, mesh, mesh.model_group, device)
