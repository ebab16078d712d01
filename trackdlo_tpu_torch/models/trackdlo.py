"""The TrackDLO tracker on PyTorch: RGB-D frame → tracked node chain.

Counterpart of trackdlo_tpu/models/trackdlo.py. Per frame, ``Tracker.step``
runs: preprocessing (kernel P, compaction with kernel C, voxel snap) → visibility
(kernel V) → pre-registration EM over the extended-visible guide nodes
(kernel E) → occlusion dispatch and prior walks (kernel W) → main EM
(kernel E). Every stage stays on the tracker's device; nothing is read back
to the host inside a step. On the card, :func:`build_step_fn` captures the
whole step once as one CUDA graph and replays it every frame (the
counterpart of the JAX package's one jitted step); ``Tracker`` steps through
it. The same stages run over a leading stream axis in the batched step, and
with the cloud sharded over a process group in the point-sharded step
(:mod:`trackdlo_tpu_torch.parallel`).
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import numpy as np
import torch

from trackdlo_tpu_torch import _build
from trackdlo_tpu_torch.config import CameraIntrinsics, TrackerParams
from trackdlo_tpu_torch.device import resolve_device, set_full_fp32
from trackdlo_tpu_torch.ops import graph_loop
from trackdlo_tpu_torch.ops.collectives import shard_slice
from trackdlo_tpu_torch.ops.cpd_lle import CpdParams, cpd_lle, cpd_lle_batched
from trackdlo_tpu_torch.ops.kernels import geodesic_coords
from trackdlo_tpu_torch.ops.preprocess import (
    PointCloud,
    compact_sums,
    default_cell_px,
    exact_frame,
)
from trackdlo_tpu_torch.ops.preprocess_kernel import cell_sums
from trackdlo_tpu_torch.ops.priors import correspondence_priors
from trackdlo_tpu_torch.ops.visibility_kernel import fused_visibility
from trackdlo_tpu_torch.utils import profiling


class TrackerState(NamedTuple):
    y: torch.Tensor  # (M, 3) node positions
    sigma2: torch.Tensor  # () GMM variance
    geodesic_coord: torch.Tensor  # (M,) rest arc-length coordinates


class StepOutputs(NamedTuple):
    y: torch.Tensor
    sigma2: torch.Tensor
    guide_nodes: torch.Tensor  # (M, 3) prefix-packed pre-registered guides
    guide_count: torch.Tensor
    prior_pos: torch.Tensor  # (M, 3)
    prior_mask: torch.Tensor  # (M,)
    occlusion_state: torch.Tensor  # code, see ops.priors
    visible_mask: torch.Tensor  # (M,)
    extended_mask: torch.Tensor  # (M,)
    not_self_occluded: torch.Tensor  # (M,)
    points: torch.Tensor  # (N_cap, 3) downsampled cloud
    points_mask: torch.Tensor
    n_points: torch.Tensor
    converged: torch.Tensor
    iterations: torch.Tensor
    guide_iterations: torch.Tensor  # the pre-registration pass's EM iterations


def init_state(init_nodes, params: TrackerParams, device=None) -> TrackerState:
    """State from initial nodes: rest arc lengths and the initial σ², on
    ``device`` (the CUDA card unless the caller names the CPU)."""
    y = torch.tensor(np.asarray(init_nodes, np.float32), device=resolve_device(device))
    return TrackerState(
        y=y,
        sigma2=torch.tensor(params.sigma2_init, dtype=torch.float32, device=y.device),
        geodesic_coord=geodesic_coords(y),
    )


def _host_tensor(a, device: torch.device) -> torch.Tensor:
    """A numpy frame as a tensor to copy to ``device``: u16 depth as its
    bits in int16 (the kernels read them as u16), in pinned memory for a
    CUDA device. Its bytes count as ``pinned_bytes`` (span ``step.pin``)."""
    with profiling.span("step.prepare"):
        arr = np.ascontiguousarray(a)
        t = torch.from_numpy(arr.view(np.int16) if arr.dtype == np.uint16 else arr)
    with profiling.span("step.pin"):
        profiling.count("pinned_bytes", arr.nbytes)
        return t.pin_memory() if device.type == "cuda" else t


def host_to_device(a, device: torch.device) -> torch.Tensor:
    """A frame (numpy or tensor) on ``device``, through pinned memory to a
    CUDA device."""
    if not isinstance(a, torch.Tensor):
        a = _host_tensor(a, device)
    with profiling.span("step.copy_in"):
        return a.to(device, non_blocking=True)


def preprocess_for_step(rgb, depth, occlusion_mask, *, params: TrackerParams,
                        intr: CameraIntrinsics, cell_px: int) -> PointCloud:
    """Kernel P's raw cell sums, then the compaction, in the JAX package's
    three branches:

    - parity split (the default profile), on its exact route: kernel C's
      channel compaction, divide-after-pack, kernel X's voxels of the split
      channel-cells (exits at once on a frame without any) and the
      channel-batched voxel snap;
    - coarse two-stage (``parity_split=False``): one channel with the floor
      votes, the sort compaction and the vote-keyed snap;
    - cells only (``exact_voxels=False``): one channel, the sort compaction
      with even-stride thinning, no snap.

    Frames with a leading stream axis give a batched cloud: kernel P runs
    once for the B frames, and every later step is row-local."""
    voxel_leaf = params.downsample_leaf_size if params.exact_voxels else None
    parity = params.parity_split and voxel_leaf is not None
    with profiling.device_span("preprocess", rgb.device):
        args = (rgb, depth, occlusion_mask, intr.fx, intr.fy, intr.cx, intr.cy,
                params.hsv_lower, params.hsv_upper, params.multi_color_dlo, cell_px, voxel_leaf)
        sums = cell_sums(*args, parity_split=parity,
                         with_votes=not parity and voxel_leaf is not None, exact=parity)
        return compact_sums(sums, params.max_points, voxel_leaf, params.candidate_cap(), parity,
                            exact_frame(args, sums) if parity else None)


def _track_from_points(state: TrackerState, pc: PointCloud, proj: torch.Tensor, *,
                       params: TrackerParams, intr: CameraIntrinsics, model_axis=None):
    """Visibility → pre-registration → priors → main EM on a prepared cloud;
    a state and cloud with a leading stream axis run every stage batched
    (the EM passes through :func:`cpd_lle_batched`).

    ``model_axis``: a process group over which the cloud is sharded. Every
    rank of it runs the preprocessing and visibility on the whole cloud and
    keeps its slice of the points and of the per-point minima
    (:func:`~trackdlo_tpu_torch.ops.collectives.shard_slice` of the cloud's
    own length, so each point lands in exactly one shard); both EM passes
    reduce over the shards. ``StepOutputs.points`` stays the whole cloud."""
    m = params.num_of_nodes
    dev = state.y.device
    lead = state.y.shape[:-2]
    em = cpd_lle_batched if lead else cpd_lle
    with profiling.device_span("visibility", dev):
        vis = fused_visibility(
            state.y, pc.points, pc.mask, proj, state.geodesic_coord,
            intr.height, intr.width, params.visibility_threshold,
            params.dlo_pixel_width, params.d_vis,
        )
    shard = shard_slice(pc.points.shape[-2], model_axis)
    em_points, em_mask = pc.points[..., shard, :], pc.mask[..., shard]
    with profiling.device_span("em.pre", dev):
        iota = torch.arange(m, device=dev)
        guide_node_mask = iota < vis.vis_ext_count[..., None]
        picked = state.y.gather(-2, vis.vis_ext_idx[..., None].expand(*lead, m, 3))
        guide0 = torch.where(guide_node_mask[..., None], picked, 0.0)
        pre = em(
            em_points, em_mask, guide0, guide_node_mask, state.sigma2,
            CpdParams(
                beta=params.beta_pre_proc, lam=params.lambda_pre_proc,
                lle_weight=params.lle_weight, mu=params.mu, max_iter=params.max_iter,
                tol=params.tol, include_lle=True, prune_radius=params.prune_radius,
                visibility_threshold=params.visibility_threshold, solver=params.solver,
            ),
            point_min_sq=vis.point_min_sq_ext[..., shard],
            axis_name=model_axis,
        )
    guide_nodes = pre.y
    with profiling.device_span("priors", dev):
        priors = correspondence_priors(
            state.y, state.geodesic_coord, guide_nodes, vis.vis_ext_idx,
            vis.vis_ext_count, vis.vis_idx, vis.vis_count,
        )
    profiling.count_occlusion_states(priors.state)
    with profiling.device_span("em.main", dev):
        main = em(
            em_points, em_mask, state.y, torch.ones((*lead, m), dtype=torch.bool, device=dev),
            state.sigma2,
            CpdParams(
                beta=params.beta, lam=params.lam, lle_weight=params.lle_weight,
                mu=params.mu, max_iter=params.max_iter, tol=params.tol,
                include_lle=False, alpha=params.alpha, k_vis=params.k_vis,
                visibility_threshold=params.visibility_threshold,
                prune_radius=params.prune_radius, use_priors=True,
                use_visibility=True, solver=params.solver,
            ),
            prior_pos=priors.prior_pos,
            prior_mask=priors.prior_mask,
            visible_count=vis.vis_ext_count,
            point_min_sq=vis.point_min_sq_all[..., shard],
            axis_name=model_axis,
        )
    new_state = TrackerState(y=main.y, sigma2=main.sigma2, geodesic_coord=state.geodesic_coord)
    outputs = StepOutputs(
        y=main.y,
        sigma2=main.sigma2,
        guide_nodes=guide_nodes,
        guide_count=vis.vis_ext_count,
        prior_pos=priors.prior_pos,
        prior_mask=priors.prior_mask,
        occlusion_state=priors.state,
        visible_mask=vis.visible_mask,
        extended_mask=vis.extended_mask,
        not_self_occluded=vis.not_self_occluded,
        points=pc.points,
        points_mask=pc.mask,
        n_points=pc.count,
        converged=main.converged,
        iterations=main.iterations,
        guide_iterations=pre.iterations,
    )
    return new_state, outputs


def _step_impl(state: TrackerState, rgb, depth, occ, *, params: TrackerParams,
               intr: CameraIntrinsics, cell_px: int, proj: torch.Tensor):
    """The eager per-frame step on ``proj``'s device: the frame to the
    device, preprocessing, then :func:`_track_from_points`."""
    dev = proj.device
    with profiling.root():
        pc = preprocess_for_step(
            host_to_device(rgb, dev), host_to_device(depth, dev),
            host_to_device(occ, dev).contiguous(), params=params, intr=intr, cell_px=cell_px,
        )
        return _track_from_points(state, pc, proj, params=params, intr=intr)


def _tree_map(fn, *trees):
    """``fn`` of the tensors at each place of nested (named) tuples of one
    structure."""
    tree = trees[0]
    if isinstance(tree, torch.Tensor):
        return fn(*trees)
    if isinstance(tree, tuple):
        parts = [_tree_map(fn, *vs) for vs in zip(*trees)]
        return type(tree)(*parts) if hasattr(tree, "_fields") else tuple(parts)
    return tree


def _copy_outputs(*trees):
    """A copy of every tensor of ``trees``, the outputs of one step (cloned)
    or of one step a cohort (concatenated along the leading stream axis, in
    order); a tensor that appears twice (the state's y and the outputs' y)
    is copied once and stays one tensor."""
    copies: dict = {}

    def copy_once(*ts):
        key = tuple(map(id, ts))
        if key not in copies:
            copies[key] = ts[0].clone() if len(ts) == 1 else torch.cat(ts)
        return copies[key]

    return _tree_map(copy_once, *trees)


def _is_mask(buf: torch.Tensor, shape: tuple) -> bool:
    """Whether an input of ``shape`` goes into ``buf`` as a mask: ``buf`` is
    bool (nonzero keeps), and the input has its shape or one trailing
    channel axis more (any channel nonzero keeps)."""
    return buf.dtype == torch.bool and shape[:buf.ndim] == tuple(buf.shape) and (
        len(shape) - buf.ndim in (0, 1))


def _shape_error(name: str, buf: torch.Tensor, shape, dtype) -> ValueError:
    return ValueError(f"{name} must be {tuple(buf.shape)} {buf.dtype}, got {tuple(shape)} {dtype}")


def _stage(buf: torch.Tensor, src, name: str) -> None:
    """Write a host input (a numpy array or a CPU tensor) into the host
    buffer ``buf`` in one pass, at the strides it comes with: of the same
    shape and dtype (u16 depth as its int16 bits), or for a bool ``buf`` a
    mask of any dtype (:func:`_is_mask`), written as canonical bools
    (0 or 1) without a widened temporary. The span ``step.pin`` times the
    write; its bytes count as ``staged_bytes``."""
    arr = src.numpy() if isinstance(src, torch.Tensor) else np.asarray(src)
    if arr.dtype == np.uint16:
        arr = arr.view(np.int16)
    out = buf.numpy()
    mask = _is_mask(buf, arr.shape)
    if not mask and (arr.shape != out.shape or arr.dtype != out.dtype):
        raise _shape_error(name, buf, arr.shape, arr.dtype)
    if mask and arr.dtype == np.bool_:
        arr = arr.view(np.uint8)  # a bool's byte may be any nonzero value
    with profiling.span("step.pin"):
        profiling.count("staged_bytes", buf.nbytes)
        if min(arr.strides, default=0) < 0:  # no torch tensor has a negative stride
            if not mask:
                np.copyto(out, arr)
            elif arr.ndim > out.ndim:
                np.any(arr, axis=-1, out=out)
            else:
                np.not_equal(arr, 0, out=out)
            return
        t = torch.from_numpy(arr)
        if not mask:
            buf.copy_(t)
            return
        out_t = buf.view(torch.uint8) if t.dtype == torch.uint8 else buf
        if t.ndim > buf.ndim:
            torch.any(t, dim=-1, out=out_t)  # 0 or 1, as uint8 for uint8 input
        elif t.dtype == torch.uint8:
            torch.clamp_max(t, 1, out=out_t)  # x != 0 as 0 or 1, vectorised
        else:
            torch.ne(t, 0, out=out_t)


def _on_card(src) -> bool:
    return isinstance(src, torch.Tensor) and src.device.type == "cuda"


def _copy_into(dst: torch.Tensor, src, name: str, staging: torch.Tensor, stream=None) -> int:
    """``src`` into the static buffer ``dst`` without a host
    synchronisation; returns the bytes written on the host. A tensor on the
    card is copied directly, on the current stream (to a bool ``dst``, a
    mask of another dtype or with a channel axis made bool on the card
    first); anything else is written into the host buffer ``staging``
    (:func:`_stage`), then copied from there on ``stream`` (the current
    stream where None)."""
    if _on_card(src):
        if src.dtype == torch.uint16 and dst.dtype == torch.int16:
            src = src.view(torch.int16)
        if _is_mask(dst, tuple(src.shape)) and (src.dtype != torch.bool or src.ndim > dst.ndim):
            src = src != 0
            if src.ndim > dst.ndim:
                src = src.any(dim=-1)
        if tuple(src.shape) != tuple(dst.shape) or src.dtype != dst.dtype:
            raise _shape_error(name, dst, src.shape, src.dtype)
        with profiling.span("step.copy_in"):
            dst.copy_(src, non_blocking=True)
        return 0
    _stage(staging, src, name)
    with profiling.span("step.copy_in"), torch.cuda.stream(stream):
        dst.copy_(staging, non_blocking=True)
    return staging.nbytes


# Solvers whose M-step no CUDA graph holds, so that their step stays eager:
# the SVD reads its convergence status on the host; over a batch of streams
# the Cholesky factorisation runs through MAGMA, which synchronises (and
# aborts the process under capture), and the QR through cuBLAS' batched
# geqrf, which a conditional loop body does not hold (PERF.md §6).
EAGER_SOLVERS = ("svd_lstsq",)
BATCH_EAGER_SOLVERS = ("svd_lstsq", "normal_cholesky", "lstsq")


def step_shapes(params: TrackerParams, intr: CameraIntrinsics, batch: int | None = None) -> dict:
    """The static buffers of a frame step, name → (shape, dtype): the
    state's fields, then rgb (u8), depth (its int16 bits) and the occlusion
    mask (bool); every one with a leading stream axis of ``batch`` when
    given."""
    lead = () if batch is None else (batch,)
    h, w, m = intr.height, intr.width, params.num_of_nodes
    return dict(y=(lead + (m, 3), torch.float32), sigma2=(lead, torch.float32),
                geodesic_coord=(lead + (m,), torch.float32), rgb=(lead + (h, w, 3), torch.uint8),
                depth=(lead + (h, w), torch.int16), occ=(lead + (h, w), torch.bool))


def points_shapes(params: TrackerParams) -> dict:
    """The static buffers of a points step: the state's fields, then the
    (max_points, 3) cloud and its (max_points,) mask."""
    m, cap = params.num_of_nodes, params.max_points
    return dict(y=((m, 3), torch.float32), sigma2=((), torch.float32),
                geodesic_coord=((m,), torch.float32), points=((cap, 3), torch.float32),
                mask=((cap,), torch.bool))


class CompiledStep:
    """A step ``fn(state, *inputs) -> outputs`` captured once as one CUDA
    graph over static buffers (``shapes``, name → (shape, dtype): the
    state's three fields, then one buffer per input, as
    :func:`step_shapes` or :func:`points_shapes` give them) and replayed
    every call.

    The first call warms ``fn`` up eagerly on a side stream, the one its EM
    loops' bodies are later captured on (the kernel library loads, every
    launcher sets its attributes, every cache and library workspace fills),
    then captures it into one ``torch.cuda.CUDAGraph``; an EM loop inside
    becomes a conditional WHILE node whose trips the card decides
    (:mod:`~trackdlo_tpu_torch.ops.graph_loop`). Each call copies the
    state and the inputs into the static buffers (:meth:`load`), replays
    the graph (:meth:`replay`), and returns copies of the outputs taken out
    of the graph's memory pool: what one call returns is never overwritten
    by the next, so streams can interleave their states through one step.
    A caller that copies the outputs itself (the batched step, one
    ``CompiledStep`` a cohort) calls the three parts and :meth:`release`.

    A tensor on the card is copied from where it is, on the current stream.
    Any other input (a numpy array or a CPU tensor) is written in one pass
    into a pinned host buffer of the static buffer's shape and dtype,
    allocated at the capture and held as long as the step (:func:`_stage`:
    u16 depth as its int16 bits; into a bool buffer, a mask of any dtype,
    nonzero keeping, a trailing channel axis any-reduced), then copied from
    there on ``copy_stream`` (the current stream where None). A call may
    return before its copies have run, so the next call waits for an event
    recorded after them before it writes a host buffer again (counted as
    ``staging_waits`` where it had to wait). On a ``copy_stream`` of its
    own the copies run beside what the current stream has queued (another
    cohort's replay); the replay waits for them, and they wait for the last
    :meth:`release` before they overwrite the static buffers. The kernel
    wrappers count their launches in Python, so once while capturing: that
    count is recorded and added to ``_build``'s counters at each replay;
    the launches of the loops' trips are counted on the card and reach the
    counters at ``_build.settle_counts()``. Nothing falls back: a capture
    that fails raises. Calls must not overlap (callers serialise them, as
    the TCP server's device lock does).

    Each call reports to the span recorder (:mod:`~trackdlo_tpu_torch.utils.profiling`)
    as host spans ``step`` (the root), ``step.pin`` (the writes into the
    host buffers), ``step.copy_in``, ``step.replay`` and ``step.copy_out``,
    and the counters ``staged_bytes`` and ``staging_waits``. The graph
    holds device stamps (the ``replay`` span around the whole step and one
    span a layer inside it) only if the recorder is on when the graph is
    captured, at the first call: a graph captured while it is off has no
    stamp node, and one captured while it is on stamps every replay."""

    def __init__(self, fn: Callable, device: torch.device, shapes: dict, copy_stream=None):
        self.fn, self.device = fn, device
        self._shapes = shapes
        self.copy_stream = copy_stream
        self.graph = None
        self.counts = None
        self.loops = None
        self.stamped = False
        self._inputs = None
        self._staging = None
        self._staged = None  # recorded after the last call's copies
        self._released = None  # recorded once the last call's outputs were copied
        self._outputs = None

    def _load(self, state, inputs) -> int:
        srcs = (*state, *inputs)
        if not all(map(_on_card, srcs)) and not self._staged.query():
            profiling.count("staging_waits", 1)
            self._staged.synchronize()
        copy = self.copy_stream
        if copy is not None:
            copy.wait_event(self._released)
        staged = sum(_copy_into(self._inputs[name], src, name, self._staging[name], copy)
                     for name, src in zip(self._inputs, srcs))
        self._staged.record(copy)
        if copy is not None:
            torch.cuda.current_stream(self.device).wait_event(self._staged)
        return staged

    def _args(self):
        b = list(self._inputs.values())
        return (TrackerState(*b[:3]), *b[3:])

    def _capture(self, state, inputs) -> None:
        dev = self.device
        self._inputs = {k: torch.empty(shape, dtype=dt, device=dev)
                        for k, (shape, dt) in self._shapes.items()}
        self._staging = {k: torch.empty(shape, dtype=dt, pin_memory=True)
                         for k, (shape, dt) in self._shapes.items()}
        self._staged, self._released = torch.cuda.Event(), torch.cuda.Event()
        self._load(state, inputs)
        graph_loop.warm(dev)
        loops = graph_loop.GraphLoops(dev)
        side = loops.body_stream  # the warm-up's stream is the loops' body stream
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.fn(*self._args())
        torch.cuda.current_stream(dev).wait_stream(side)
        self._released.record()  # the warm-up has read the static buffers
        stamped = profiling.prepare(dev)
        graph = torch.cuda.CUDAGraph()
        before = dict(_build.launch_counts)
        try:
            with graph_loop.recording(loops):
                with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                    with profiling.device_span(profiling.REPLAY, dev):
                        outputs = self.fn(*self._args())
        finally:
            after = dict(_build.launch_counts)
            counts = {k: after[k] - before[k] for k in after}
            _build.add_counts({k: -v for k, v in counts.items()})
        loops.captured()
        self.graph, self.counts, self.loops, self._outputs = graph, counts, loops, outputs
        self.stamped = stamped

    def load(self, state, *inputs) -> int:
        """The state and the inputs into the static buffers, the graph
        captured first at the first call; returns the bytes written into
        the host buffers. Call on the step's device."""
        if self.graph is None:
            self._capture(state, inputs)
        return self._load(state, inputs)

    def replay(self):
        """The graph replayed on the current stream over what :meth:`load`
        put in; returns the outputs as they lie in the graph's pool, which
        the next replay overwrites."""
        with profiling.span("step.replay"):
            self.graph.replay()
        if self.stamped:
            profiling.replayed(self.device)
        _build.add_counts(self.counts)
        return self._outputs

    def release(self) -> None:
        """The last replay's outputs are copied (on the current stream): the
        next call's copies on a copy stream may overwrite the static buffers
        once the current stream's work so far has run."""
        if self.copy_stream is not None:
            self._released.record()

    def __call__(self, state, *inputs):
        with profiling.root(), torch.cuda.device(self.device):
            self.load(state, *inputs)
            outputs = self.replay()
            with profiling.span("step.copy_out"):
                outputs = _copy_outputs(outputs)
            self.release()
            return outputs


def build_step_fn(params: TrackerParams, intr: CameraIntrinsics, jit: bool = True,
                  device=None):
    """The per-frame step ``(state, rgb u8 (H, W, 3), depth u16 (H, W), occ
    bool (H, W)) -> (state, outputs)`` on ``device`` (the CUDA card unless
    the caller names the CPU); the frame may be numpy arrays or tensors.

    On a CUDA device with ``jit`` (the default, as the JAX package's
    ``jax.jit``): a :class:`CompiledStep`, the whole step captured at the
    first call as one CUDA graph and replayed every frame, with every
    solver but ``"svd_lstsq"`` (the per-iteration EM loop's trips decided on
    the card). ``torch.linalg.svd`` reads its convergence status on the host
    and has no variant that does not, so the ``"svd_lstsq"`` step is the
    eager one. With ``jit=False`` or on the CPU, the eager step. Either way
    the hyperparameters are fixed when the step is built."""
    dev = resolve_device(device)
    set_full_fp32()
    cell_px = params.downsample_cell_px or default_cell_px(params.downsample_leaf_size, intr.fx)
    proj = torch.as_tensor(np.array(intr.proj_matrix(), np.float32), device=dev)
    fn = functools.partial(_step_impl, params=params, intr=intr, cell_px=cell_px, proj=proj)
    if jit and dev.type == "cuda" and params.solver not in EAGER_SOLVERS:
        return CompiledStep(fn, dev, step_shapes(params, intr))
    return fn


def _points_step_impl(state: TrackerState, points, mask, *, params: TrackerParams,
                      intr: CameraIntrinsics, proj: torch.Tensor):
    """The step from a (max_points, 3) cloud and its (max_points,) mask on
    ``proj``'s device: :func:`_track_from_points`, no preprocessing."""
    dev = proj.device
    with profiling.root():
        pts, msk = host_to_device(points, dev), host_to_device(mask, dev)
        pc = PointCloud(points=pts, mask=msk, count=msk.to(torch.int64).sum())
        return _track_from_points(state, pc, proj, params=params, intr=intr)


def build_points_step_fn(params: TrackerParams, intr: CameraIntrinsics, jit: bool = True,
                         device=None):
    """The step from a caller's cloud ``(state, points f32 (max_points, 3),
    mask bool (max_points,)) -> (state, outputs)`` on ``device`` (the card
    unless the caller names the CPU), the counterpart of the JAX package's
    jitted ``Tracker.step_from_points``. On a CUDA device with ``jit``: a
    :class:`CompiledStep` over a static cloud and mask (but for
    :data:`EAGER_SOLVERS`); else eager."""
    dev = resolve_device(device)
    set_full_fp32()
    proj = torch.as_tensor(np.array(intr.proj_matrix(), np.float32), device=dev)
    fn = functools.partial(_points_step_impl, params=params, intr=intr, proj=proj)
    if jit and dev.type == "cuda" and params.solver not in EAGER_SOLVERS:
        return CompiledStep(fn, dev, points_shapes(params))
    return fn


class Tracker:
    """Tracking API on one device.

    Usage::

        tracker = Tracker(live_params(), CameraIntrinsics(), device="cuda")
        state = tracker.init_from_frame(rgb, depth)     # or init_from_nodes
        for rgb, depth in frames:
            state, out = tracker.step(state, rgb, depth)

    ``device="cuda"`` without a GPU raises; it never falls back to the CPU.
    On a CUDA device every former TPU kernel of the step runs as a
    hand-written CUDA kernel at any node count and cloud size (its narrow,
    wide or node-unbounded build, ``hopper_kernels.NODE_BUILDS``), and
    ``step`` and ``step_from_points`` each replay
    their CUDA graph (:func:`build_step_fn`, :func:`build_points_step_fn`;
    every solver but ``"svd_lstsq"``); on the CPU the plain versions run
    eagerly."""

    def __init__(self, params: TrackerParams, intrinsics: CameraIntrinsics, device=None):
        self.params = params
        self.intrinsics = intrinsics
        self.device = resolve_device(device)
        self._step = build_step_fn(params, intrinsics, device=self.device)
        self._step_points = None
        self._full_occ = None

    def init_from_nodes(self, nodes) -> TrackerState:
        nodes = np.asarray(nodes, np.float32)
        if nodes.shape != (self.params.num_of_nodes, 3):
            raise ValueError(f"expected ({self.params.num_of_nodes}, 3) nodes, got {nodes.shape}")
        return init_state(nodes, self.params, self.device)

    def init_from_frame(self, rgb, depth) -> TrackerState:
        """First-frame initialisation through the skeleton + spline fit
        (falling back to cold-start registration)."""
        from trackdlo_tpu_torch.dlo_init import initialize_nodes

        nodes = initialize_nodes(np.asarray(rgb), np.asarray(depth), self.params, self.intrinsics)
        return self.init_from_nodes(nodes)

    def step(self, state: TrackerState, rgb, depth, occlusion_mask=None):
        """One tracking update: rgb (H, W, 3) u8, depth (H, W) u16 mm, an
        optional occlusion mask (nonzero = keep)."""
        with profiling.root():
            return self._step(state, rgb, depth, self._occ(state, rgb, depth, occlusion_mask))

    def _occ(self, state, rgb, depth, occlusion_mask):
        """The shapes checked; the occlusion mask as the step takes it: the
        graph step as given (:class:`CompiledStep` makes it bool in its
        copy), the eager step on the device as (H, W) bool."""
        h, w = self.intrinsics.height, self.intrinsics.width
        with profiling.span("step.prepare"):
            rgb_shape, depth_shape = tuple(np.shape(rgb)), tuple(np.shape(depth))
            if rgb_shape != (h, w, 3):
                raise ValueError(f"rgb must be ({h}, {w}, 3) u8 for these intrinsics, "
                                 f"got {rgb_shape}")
            if depth_shape != (h, w):
                raise ValueError(f"depth must be ({h}, {w}) u16 millimetres, got {depth_shape}")
            y_shape = tuple(np.shape(state.y))
            if y_shape != (self.params.num_of_nodes, 3):
                raise ValueError(f"state.y must be ({self.params.num_of_nodes}, 3), got {y_shape}")
            if occlusion_mask is None:
                if self._full_occ is None:
                    self._full_occ = torch.ones((h, w), dtype=torch.bool, device=self.device)
                return self._full_occ
        if isinstance(self._step, CompiledStep):
            return occlusion_mask
        occ = host_to_device(occlusion_mask, self.device)
        with profiling.span("step.prepare"):
            occ = occ != 0
            return occ.any(dim=-1) if occ.ndim == 3 else occ

    def step_from_points(self, state: TrackerState, points):
        """One update from a caller-supplied (N, 3) cloud, skipping the RGB-D
        preprocessing; points beyond ``params.max_points`` are dropped. On
        the card the step replays its own CUDA graph
        (:func:`build_points_step_fn`), built at the first call."""
        if self._step_points is None:
            self._step_points = build_points_step_fn(self.params, self.intrinsics,
                                                     device=self.device)
        with profiling.root():
            with profiling.span("step.prepare"):
                cap = self.params.max_points
                pts = np.zeros((cap, 3), np.float32)
                msk = np.zeros((cap,), bool)
                arr = np.asarray(points, np.float32)[:cap]
                pts[: len(arr)] = arr
                msk[: len(arr)] = True
            return self._step_points(state, pts, msk)
