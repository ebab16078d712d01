"""The EM's tolerance loop inside a CUDA graph, its trips decided on the card.

The JAX package's per-iteration EM is a ``lax.while_loop`` whose condition
runs on the device. The port's lockstep loop (``ops.cpd_lle.em_loop_lockstep``)
runs one in-place trip body; eagerly, a host ``while`` reads the loop's flag
before each trip. While a stream is being captured into a CUDA graph
(:class:`~trackdlo_tpu_torch.models.trackdlo.CompiledStep`),
:func:`device_while` records the same body as the body graph of a
conditional WHILE node instead (csrc/loop_flag.cu): kernel L, launched once
before the node and at the end of every trip, sets the node's condition to
"some stream is not done and below max_iter" on the card, so a replay reads
nothing on the host.

The body is captured on a second stream into the node's body graph. Its
temporaries come from a memory pool of their own (the capturing graph's
pool cannot take a second capture), which lives as long as the recorder
that owns the graph. A capture counts each kernel wrapper's launch once,
but a replay runs the body as many trips as the card decides: kernel L
counts the trips into a device tally, and ``_build.settle_counts()`` turns
it into launches (the body's launches a trip, times the trips).
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
import weakref
from typing import Callable

import torch

from trackdlo_tpu_torch import _build

_local = threading.local()
# EM loops one graph may hold: two a cohort (pre-registration and main pass).
MAX_LOOPS = 256
# One body stream a device for the whole process: cuSOLVER keeps state tied
# to the stream a body was captured on, and a body with a cuSOLVER call
# captured on another stream than an earlier one fails at capture_end
# ("invalid argument"); bodies captured one after another on one stream do
# not.
_body_streams: dict = {}
_body_lock = threading.Lock()


def body_stream(device: torch.device) -> torch.cuda.Stream:
    """The stream every loop body on ``device`` is captured on."""
    index = torch.cuda._get_device_index(device, optional=True)
    with _body_lock:
        if index not in _body_streams:
            _body_streams[index] = torch.cuda.Stream(index)
        return _body_streams[index]


def loop_flag_plain(done: torch.Tensor, it: torch.Tensor, max_iter: int) -> torch.Tensor:
    """Kernel L's plain version: 1 (int32) while some stream is active, not
    ``done`` and below ``max_iter`` trips, else 0."""
    return (~done & (it < max_iter)).any().to(torch.int32)


def _launch(done, it, max_iter, dev, *, handle=None, flag=None, trips=None, opening=0):
    code = _build.lib().trackdlo_loop_flag(
        done.data_ptr(), it.data_ptr(), done.shape[0], int(max_iter), int(handle or 0),
        int(handle is not None), None if flag is None else flag.data_ptr(),
        None if trips is None else trips.data_ptr(), int(opening), _build.stream_ptr(dev))
    _build.check(code, "trackdlo_loop_flag")
    _build.count_launch("loop_flag")


def loop_flag(done: torch.Tensor, it: torch.Tensor, max_iter: int) -> torch.Tensor:
    """Kernel L alone: the flag of :func:`loop_flag_plain` for (B,) bool
    ``done`` and (B,) int32 ``it``, as a 0-dim int32 tensor (the plain
    version on the CPU)."""
    if done.device.type == "cpu":
        return loop_flag_plain(done, it, max_iter)
    dev = _build.require_cuda("loop_flag", dict(done=done, it=it),
                              dict(done=torch.bool, it=torch.int32))
    if done.shape != it.shape or done.ndim != 1:
        raise ValueError("loop_flag: done and it must be (B,)")
    flag = torch.empty((), dtype=torch.int32, device=dev)
    _launch(done, it, max_iter, dev, flag=flag)
    return flag


class _LoopTrips:
    """One captured loop's device tally (trips run, loops opened) and its
    body's launches a trip; counted once its graph is captured."""

    def __init__(self, trips: torch.Tensor, per_trip: dict):
        self.trips, self.per_trip = trips, per_trip

    def settle(self) -> dict:
        trips, opened = self.trips.tolist()
        self.trips.zero_()
        out = {k: v * trips for k, v in self.per_trip.items()}
        out["loop_flag"] = out.get("loop_flag", 0) + opened
        return out


def _release_pool(index: int, pool, begun: list) -> None:
    for _ in range(begun[0]):
        torch._C._cuda_releasePool(index, pool)


class GraphLoops:
    """The loops captured into one CUDA graph: the body stream (the
    device's, :func:`body_stream`), the body pool and each loop's trip
    tally. Open it around the capture (:func:`recording`) and keep it as
    long as the graph. Run the eager warm-up before the capture on
    ``body_stream``: the libraries' per-stream state (cuBLAS and cuSOLVER
    workspaces) must exist before a body is captured on it."""

    def __init__(self, device: torch.device):
        self.index = torch.cuda._get_device_index(device, optional=True)
        self.body_stream = body_stream(device)
        self.pool = torch.cuda.graph_pool_handle()
        self.loops: list[_LoopTrips] = []
        # The trip tallies outlive every replay, so they are allocated here,
        # outside the graph's pool: memory the capture allocates is the
        # graph's scratch, which its earlier nodes write before a later
        # allocation's lifetime starts.
        self._tallies = torch.zeros((MAX_LOOPS, 2), dtype=torch.int64, device=device)
        self._begun = [0]  # the body pool's uses, released with the recorder
        weakref.finalize(self, _release_pool, self.index, self.pool, self._begun)

    def tally(self) -> torch.Tensor:
        """The next loop's (trips, loops opened) tally."""
        if len(self.loops) >= self._tallies.shape[0]:
            raise RuntimeError(f"more than {self._tallies.shape[0]} EM loops in one graph")
        return self._tallies[len(self.loops)]

    def captured(self) -> None:
        """After a capture that succeeded: zero the trip tallies and count
        them from now on."""
        self._tallies.zero_()
        for loop in self.loops:
            _build.register_device_counter(loop)


@contextlib.contextmanager
def recording(loops: GraphLoops):
    """Record the loops of a capture on this thread into ``loops``."""
    outer = getattr(_local, "loops", None)
    _local.loops = loops
    try:
        yield loops
    finally:
        _local.loops = outer


def capturing(device: torch.device) -> bool:
    """Whether work on ``device``'s current stream is being captured."""
    return device.type == "cuda" and torch.cuda.is_current_stream_capturing()


def warm(device: torch.device) -> None:
    """Load kernel L before a capture (its first launch, eagerly)."""
    z = torch.zeros(1, dtype=torch.int32, device=device)
    loop_flag(z.bool(), z, 0)


def device_while(done: torch.Tensor, it: torch.Tensor, max_iter: int, body: Callable[[], None]):
    """Capture ``body()`` as a conditional WHILE node that runs while some
    stream is active (``~done & (it < max_iter)``, (B,) bool and int32),
    decided by kernel L before the first trip and after each one. ``body``
    updates ``done`` and ``it`` in place; every tensor it must leave behind
    it writes in place too (its temporaries live only within a trip). Only
    while capturing, inside :func:`recording`."""
    loops = getattr(_local, "loops", None)
    if loops is None:
        raise RuntimeError("device_while: capture the step through CompiledStep "
                           "(graph_loop.recording around the capture)")
    dev = done.device
    lib = _build.lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    handle = ctypes.c_ulonglong(0)
    _build.check(lib.trackdlo_while_handle(stream, ctypes.addressof(handle)),
                 "trackdlo_while_handle")
    trips = loops.tally()
    before = dict(_build.launch_counts)
    _launch(done, it, max_iter, dev, handle=handle.value, trips=trips, opening=1)
    body_stream = loops.body_stream
    _build.check(lib.trackdlo_while_open(stream, handle.value, body_stream.cuda_stream),
                 "trackdlo_while_open")
    torch._C._cuda_beginAllocateCurrentThreadToPool(loops.index, loops.pool)
    loops._begun[0] += 1
    try:
        with torch.cuda.stream(body_stream):
            body()
            _launch(done, it, max_iter, dev, handle=handle.value, trips=trips)
    finally:
        torch._C._cuda_endAllocateToPool(loops.index, loops.pool)
        code = lib.trackdlo_while_close(body_stream.cuda_stream)
    _build.check(code, "trackdlo_while_close")
    after = dict(_build.launch_counts)
    counted = {k: after[k] - before[k] for k in after}
    _build.add_counts({k: -v for k, v in counted.items()})
    per_trip = {k: v for k, v in counted.items() if v}
    per_trip["loop_flag"] -= 1  # the launch before the node opens the loop
    loops.loops.append(_LoopTrips(trips, per_trip))
