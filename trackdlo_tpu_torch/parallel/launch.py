"""Start the ranks of a mesh as processes on one host, and a dry run of both
multi-rank paths.

:func:`run_ranks` spawns one process per rank
(``torch.multiprocessing.start_processes``, ``spawn``, so each starts from a
fresh import), joins them into one ``gloo`` process group through a
``FileStore`` in a temporary directory (no TCP port, so concurrent launches
cannot collide), runs ``fn(rank, world, device, *args)`` on each and returns
each rank's result. ``fn`` and ``args`` are pickled: ``fn`` must be a
module-level function of an importable module, and the results plain data
(numpy arrays, numbers), not CUDA tensors.

The device defaults to the card, as every entry point of the port does; the
CPU only where the caller names it (``device="cpu"``). Every rank may share
one card: ``gloo`` reduces CUDA tensors through the host, where NCCL refuses
two ranks on one GPU.

:func:`dryrun_multichip` is the counterpart of the repository's
``__graft_entry__.dryrun_multichip`` on CPU ranks::

    python -c "from trackdlo_tpu_torch.parallel.launch import dryrun_multichip; dryrun_multichip(4)"
"""

from __future__ import annotations

import datetime
import os
import queue
import tempfile
import time
import traceback
from typing import NamedTuple

import numpy as np


class RankFailure(NamedTuple):
    """What a rank that raised reports: when (``time.monotonic``, one clock
    for every process of the host) and its traceback."""

    at: float
    traceback: str


def _rank_main(rank, fn, world, store_path, timeout_s, device, args, results):
    failed_at = None
    try:
        import torch
        import torch.distributed as dist

        if torch.device(device).type == "cpu":
            # The ranks share the host's cores.
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                                world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
        try:
            # Every rank has joined the group before any runs fn: a rank that
            # fails at once cannot tear the group down under a peer that is
            # still connecting.
            dist.barrier()
            out = fn(rank, world, device, *args)
        except BaseException:
            # Timed before this rank's teardown, so before any failure it
            # causes on a peer.
            failed_at = time.monotonic()
            raise
        finally:
            dist.destroy_process_group()
    except BaseException:
        at = time.monotonic() if failed_at is None else failed_at
        results.put((rank, RankFailure(at, traceback.format_exc())))
        raise
    results.put((rank, out))


def _failure_message(failures: dict, fallback: str) -> str:
    """The rank that raised first, then every other rank that raised (a
    peer's lost connection comes after the failure that caused it)."""
    if not failures:
        return f"run_ranks failed: {fallback}"
    order = sorted(failures, key=lambda r: failures[r].at)
    first = order[0]
    msg = f"run_ranks failed: rank {first} raised first:\n{failures[first].traceback}"
    for r in order[1:]:
        msg += f"\nthen rank {r}:\n{failures[r].traceback}"
    return msg


def run_ranks(fn, world: int, *, device=None, timeout_s: float = 120.0, args: tuple = ()) -> list:
    """Run ``fn(rank, world, device, *args)`` on ``world`` spawned ranks of
    one ``gloo`` process group; returns the results in rank order.
    ``device`` is resolved as every entry point's (``None`` → the card; a
    card that is not there raises). Raises if a rank raises (with its
    traceback), exits nonzero or has not finished ``timeout_s`` seconds
    after the start (every rank still running is then killed); the
    collectives time out after ``timeout_s`` as well. Where several ranks
    raised, the message leads with the one that raised first (time.monotonic,
    one clock for the host): a peer that lost its connection because of it
    comes after."""
    import torch.multiprocessing as mp

    from trackdlo_tpu_torch.device import resolve_device

    device = str(resolve_device(device))
    results = mp.get_context("spawn").Queue()
    got: dict = {}

    def drain(wait_s=0.0):
        while len(got) < world:
            try:
                rank, out = results.get(timeout=wait_s) if wait_s else results.get_nowait()
            except queue.Empty:
                return
            got[rank] = out

    deadline = time.monotonic() + timeout_s
    with tempfile.TemporaryDirectory(prefix="trackdlo_ranks_") as tmp:
        ctx = mp.start_processes(
            _rank_main, args=(fn, world, os.path.join(tmp, "store"), timeout_s, device, args,
                              results),
            nprocs=world, join=False, daemon=True, start_method="spawn")
        try:
            # A rank's result must leave the queue's pipe before it can exit.
            while True:
                try:
                    done = ctx.join(timeout=0.5)
                except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
                    # join has ended every rank: what they reported is queued.
                    drain(wait_s=5.0)
                    failures = {r: v for r, v in got.items() if isinstance(v, RankFailure)}
                    raise RuntimeError(_failure_message(
                        failures, f"rank {e.error_index}: {e}")) from None
                drain()
                if done:
                    break
                if time.monotonic() > deadline:
                    raise RuntimeError(f"run_ranks failed: timed out after {timeout_s} s with "
                                       f"ranks {sorted(set(range(world)) - set(got))} unfinished")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10.0)
    drain(wait_s=5.0)
    failures = {r: v for r, v in got.items() if isinstance(v, RankFailure)}
    if failures:
        raise RuntimeError(_failure_message(failures, ""))
    if len(got) < world:
        raise RuntimeError(f"run_ranks failed: ranks {sorted(set(range(world)) - set(got))} "
                           "exited without a result")
    return [got[r] for r in range(world)]


def pick_model_parallel(n_devices: int) -> int:
    """The model (point-sharding) axis of the dry run: 2 or 3 where it
    divides ``n_devices``, else 1 (pure data parallelism)."""
    for mp in (2, 3):
        if n_devices % mp == 0 and n_devices >= mp:
            return mp
    return 1


def _dryrun_rank(rank: int, world: int, device: str) -> dict:
    """Both multi-rank paths at tiny shapes: pure DP over every rank, then
    DP × SP with the point axis over ``pick_model_parallel(world)`` ranks."""
    from trackdlo_tpu_torch.config import CameraIntrinsics, live_params
    from trackdlo_tpu_torch.io.sequence import SyntheticRope, render_frame
    from trackdlo_tpu_torch.models.trackdlo import init_state
    from trackdlo_tpu_torch.parallel.sharding import (
        build_batched_step_fn, build_parallel_step_fn, make_tracking_mesh, replicate_state,
    )

    intr = CameraIntrinsics(fx=120.0, fy=120.0, cx=80.0, cy=60.0, width=160, height=120)
    rope = SyntheticRope()

    def inputs(params, batch):
        frames = [render_frame(rope, 1.0 / 15.0 + 0.01 * b, intr, rope_pixel_radius=3)
                  for b in range(batch)]
        state = replicate_state(init_state(rope.nodes(0.0, params.M), params, device), batch)
        return state, np.stack([f[0] for f in frames]), np.stack([f[1] for f in frames])

    def check(state, out, path):
        if not bool(state.y.isfinite().all()) or int(out.n_points.min()) <= 0:
            raise RuntimeError(f"dry run, {path}: non-finite nodes or an empty cloud")

    mp = pick_model_parallel(world)
    params = live_params(max_points=64, downsample_cell_px=4)
    fn = build_batched_step_fn(params, intr, make_tracking_mesh(model_parallel=1), device=device)
    check(*fn(*inputs(params, world)), "data parallel")
    if mp > 1:
        params = live_params(max_points=64 * mp, downsample_cell_px=4)
        fn = build_parallel_step_fn(params, intr, make_tracking_mesh(model_parallel=mp),
                                    device=device)
        check(*fn(*inputs(params, world // mp)), "data x model parallel")
    return {"model_parallel": mp}


def dryrun_multichip(n_devices: int, timeout_s: float = 300.0) -> None:
    """One step of the multi-stream tracker over ``n_devices`` CPU ranks
    (gloo): pure data parallelism over all of them, then data × model
    parallelism with the cloud split over the model axis and the EM's
    all-reduces (skipped where ``n_devices`` is prime)."""
    out = run_ranks(_dryrun_rank, n_devices, device="cpu", timeout_s=timeout_s)
    print(f"dryrun_multichip OK ({n_devices} gloo ranks, model_parallel "
          f"{out[0]['model_parallel']})")
