"""The span recorder: host spans, counters and device stamps on one clock,
and the per-frame log line.

Counterpart of trackdlo_tpu/utils/profiling.py. Reference: hand-rolled
std::chrono timers around pre-processing / tracking / publish with running
averages (trackdlo_node.cpp:83-86, 249-252, 371-375, 518-528); here one
recorder that the step's layers report to, whose :func:`report` prints the
same "Avg ..." block.

Off by default. While off, :func:`span` (and :func:`root`,
:func:`device_span`, :func:`cohort`) make one test of a module-level bool
and return one shared no-op context: no allocation, no clock read, no torch
call. :func:`enable` turns it on:

- **Host spans.** Each ``with span(name):`` records a :class:`Span` (name,
  start and end on ``time.perf_counter_ns``, the enclosing span's name, and
  the id of the step call it belongs to: every span opened inside one root
  span shares its ``call``). While a ``torch.profiler`` is active, a span
  also enters ``torch.profiler.record_function(name)``, so that it shows
  among the trace's host events (a user annotation) and names the
  device's idle gaps.
- **Counters** (:func:`count`): ``pinned_bytes``, the bytes of numpy inputs
  an eager step pins afresh for its copy to the device (``_host_tensor``;
  none on a graph step); ``staged_bytes``, the bytes a graph step
  (``CompiledStep``) writes into its persistent pinned host buffers;
  ``staging_waits``, the graph steps' calls whose writes had to wait for the
  previous call's copies out of those buffers; ``overlap_staged_bytes``,
  ``overlap_hidden_writes`` and ``overlap_exposed_writes``
  (:func:`overlap`), the batched step's writes made while an earlier
  cohort of the same call had its replay enqueued, and whether that replay
  was still running when each ended. The kernels' launch counters stay in
  ``_build.launch_counts``.
- **Device counters** (:func:`device_counters`, :data:`DEVICE_COUNTERS`),
  added on the card by a graph captured with the recorder on and read at
  :func:`drain` (no read a call): ``dropout_points``, the masked pixels
  without depth that kernel P's exact route kept as the point at the
  origin; ``split_cells``, the image cells in which a parity channel's
  pixels spanned more than one voxel (kernel X regroups them);
  ``occlusion_states.<s>``, the frames (stream-frames) whose step ended in
  occlusion state ``s`` (:func:`count_occlusion_states`).
- **Device stamps.** While a CUDA graph is captured with the recorder on,
  each ``with device_span(name, device):`` puts a stamp kernel
  (``csrc/stamp.cu``) before and after the work it encloses: the kernel
  writes ``%globaltimer`` and a tag into a buffer on the card, at a slot it
  takes from the buffer's cursor. The stamps run inside the graph (inside
  a conditional body too) at every replay and ask nothing of the host. A
  graph captured while the recorder is off holds no stamp. :func:`enable`
  calibrates ``%globaltimer`` against the host clock (the narrowest of 20
  stamps each bracketed by two synchronisations), :func:`drain` again, and
  device times are placed on the host clock between the two, with the
  calibration's error stated.

Nothing is written out: :func:`drain` hands what was recorded since the
last drain to the caller (and reads the card, so call it outside timed
work).
"""

from __future__ import annotations

import itertools
import logging
import threading
import time
from collections import defaultdict
from typing import NamedTuple

import torch

from trackdlo_tpu_torch import _build

logger = logging.getLogger("trackdlo_tpu_torch")

# The one test a span makes while the recorder is off.
_on = False

# Slots of a device's stamp buffer (8 + 4 bytes each); stamps past it are
# dropped and counted until the next drain.
STAMP_CAPACITY = 1 << 20
CALIBRATION_STAMPS = 20
# The root device span of every replay of a graph captured with stamps.
REPLAY = "replay"
# The device counters' slots, in order (kernel P adds to the first two).
DEVICE_COUNTERS = ("dropout_points", "split_cells") + tuple(
    f"occlusion_states.{s}" for s in range(6))


class Span(NamedTuple):
    """A host span: ``start_ns`` and ``end_ns`` on ``time.perf_counter_ns``;
    ``parent`` the enclosing span's name (None for a root); ``call`` the id
    shared by every span of one root span."""

    name: str
    start_ns: int
    end_ns: int
    parent: str | None
    call: int


class DeviceSpan(NamedTuple):
    """A device span between two stamps of one replay, placed on the host
    clock: ``call`` the host call that replayed the graph, ``cohort`` the
    lockstep cohort of a batched step (None outside one)."""

    name: str
    start_ns: int
    end_ns: int
    call: int
    cohort: int | None


class Drained(NamedTuple):
    """What :func:`drain` hands over: the host spans, the counters, the
    device spans, the stamps dropped by a full buffer, and per device index
    its calibration (``offset_ns``: host minus device clock, ``error_ns``:
    the largest half-width of the brackets used, ``timer_step_ns`` and
    ``timer_mean_step_ns``: the smallest and mean advance of
    ``%globaltimer``)."""

    spans: list
    counters: dict
    device: list
    lost: int
    calibration: dict


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _Noop()


class _Ring:
    """One device's stamp buffer, its calibrations and the calls whose
    replays stamped it (in order). Lives as long as the process: the graphs
    captured with stamps hold its addresses."""

    def __init__(self, device: torch.device):
        self.device = device
        self.lib = _build.lib()
        self.header = torch.zeros(2, dtype=torch.int64, device=device)
        self.counters = torch.zeros(len(DEVICE_COUNTERS), dtype=torch.int64, device=device)
        self.times = torch.zeros(STAMP_CAPACITY, dtype=torch.int64, device=device)
        self.tags = torch.zeros(STAMP_CAPACITY, dtype=torch.int32, device=device)
        self._cal = [torch.zeros(n, dtype=dt, device=device)
                     for n, dt in ((2, torch.int64), (CALIBRATION_STAMPS, torch.int64),
                                   (CALIBRATION_STAMPS, torch.int32))]
        self.calibrations: list = []  # (device ns, offset ns, error ns)
        self.replays: list = []
        step = torch.zeros(2, dtype=torch.int64, device=device)
        _build.check(self.lib.trackdlo_timer_step(step.data_ptr(), 64, self._stream()),
                     "trackdlo_timer_step")
        self.timer_step_ns, self.timer_mean_step_ns = step.tolist()

    def _stream(self):
        return torch.cuda.current_stream(self.device).cuda_stream

    def stamp(self, tag: int) -> None:
        _build.check(self.lib.trackdlo_stamp(self.header.data_ptr(), self.times.data_ptr(),
                                             self.tags.data_ptr(), STAMP_CAPACITY, tag,
                                             self._stream()), "trackdlo_stamp")

    def calibrate(self) -> None:
        """One more (device ns, host minus device ns, error ns) from the
        narrowest of the sync-bracketed stamps."""
        header, times, tags = self._cal
        header.zero_()
        brackets = []
        for i in range(CALIBRATION_STAMPS):
            torch.cuda.synchronize(self.device)
            h0 = time.perf_counter_ns()
            _build.check(self.lib.trackdlo_stamp(header.data_ptr(), times.data_ptr(),
                                                 tags.data_ptr(), CALIBRATION_STAMPS, i,
                                                 self._stream()), "trackdlo_stamp")
            torch.cuda.synchronize(self.device)
            brackets.append((h0, time.perf_counter_ns()))
        dev_ns = times.tolist()
        (h0, h1), d = min(zip(brackets, dev_ns), key=lambda hd: hd[0][1] - hd[0][0])
        self.calibrations.append((d, (h0 + h1) // 2 - d, (h1 - h0 + 1) // 2))

    def reset(self) -> None:
        torch.cuda.synchronize(self.device)
        self.header.zero_()
        self.replays = []

    def to_host(self, d: int) -> int:
        """Device ns on the host clock: the offset interpolated between the
        first and the last calibration."""
        (d0, o0, _), (d1, o1, _) = self.calibrations[0], self.calibrations[-1]
        off = o0 if d1 == d0 else o0 + (o1 - o0) * (d - d0) / (d1 - d0)
        return int(round(d + off))

    def drain(self, tag_names: list) -> tuple[list, int, dict]:
        """The device spans since the last reset, the stamps dropped, and the
        device counters that moved (zeroed)."""
        torch.cuda.synchronize(self.device)
        counts = dict(zip(DEVICE_COUNTERS, self.counters.tolist()))
        self.counters.zero_()
        cursor, lost = self.header.tolist()
        n = min(cursor, STAMP_CAPACITY)
        times, tags = self.times[:n].tolist(), self.tags[:n].tolist()
        replays = self.replays
        self.reset()
        return (group_stamps(times, tags, tag_names, replays, self.to_host), lost,
                {k: v for k, v in counts.items() if v})


def group_stamps(times: list, tags: list, tag_names: list, replays: list, to_host) -> list:
    """Device spans from stamps in the order the card took them: each
    ``replay`` opening stamp starts the next replay, which belongs to the
    next call of ``replays``; inside it each closing stamp pairs with the
    opening one of its name and cohort. Replays past ``replays`` and stamps
    before the first replay are left out; ``to_host`` places a device time
    on the host clock."""
    out, opened, call, g = [], {}, None, -1
    for t, tag in zip(times, tags):
        name, cohort_, end = tag_names[tag]
        if name == REPLAY and not end:
            g += 1
            call = replays[g] if g < len(replays) else None
            opened = {}
        if call is None:
            continue
        if not end:
            opened[(name, cohort_)] = t
        elif (name, cohort_) in opened:
            t0 = opened.pop((name, cohort_))
            out.append(DeviceSpan(name, to_host(t0), to_host(t), call, cohort_))
    return out


class _Recorder:
    """The recorder's state: host spans (as plain tuples until drained),
    counters, each device's stamps."""

    def __init__(self):
        self.local = threading.local()
        self.calls = itertools.count()
        self.spans: list = []
        self.counters: dict = defaultdict(int)
        self.lock = threading.Lock()
        self.rings: dict = {}
        self.tag_names: list = []  # tag -> (name, cohort, end)
        self.tags: dict = {}
        self.cohort = None

    def stack(self) -> list:
        try:
            return self.local.stack
        except AttributeError:
            self.local.stack = []
            return self.local.stack

    def tag(self, name: str, end: bool) -> int:
        key = (name, self.cohort, end)
        with self.lock:
            if key not in self.tags:
                self.tags[key] = len(self.tag_names)
                self.tag_names.append(key)
            return self.tags[key]

    def ring(self, device: torch.device) -> _Ring:
        index = torch.cuda._get_device_index(device, optional=True)
        if index not in self.rings:
            self.rings[index] = _Ring(torch.device("cuda", index))
        return self.rings[index]


_recorder = _Recorder()
_clock = time.perf_counter_ns
_autograd_profiler = torch.autograd.profiler


class _Span:
    __slots__ = ("name", "start", "parent", "call", "stack", "annotation")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.stack = stack = _recorder.stack()
        if stack:
            top = stack[-1]
            self.parent, self.call = top.name, top.call
        else:
            self.parent, self.call = None, next(_recorder.calls)
        self.annotation = None
        if _autograd_profiler._is_profiler_enabled:
            self.annotation = _autograd_profiler.record_function(self.name)
            self.annotation.__enter__()
        stack.append(self)
        self.start = _clock()
        return self

    def __exit__(self, *exc):
        end = _clock()
        self.stack.pop()
        _recorder.spans.append((self.name, self.start, end, self.parent, self.call))
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        return False


class _DeviceSpan:
    __slots__ = ("ring", "name")

    def __init__(self, ring: _Ring, name: str):
        self.ring, self.name = ring, name

    def __enter__(self):
        self.ring.stamp(_recorder.tag(self.name, False))
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            self.ring.stamp(_recorder.tag(self.name, True))
        return False


class _Cohort:
    __slots__ = ("index", "outer")

    def __init__(self, index: int):
        self.index = index

    def __enter__(self):
        self.outer, _recorder.cohort = _recorder.cohort, self.index
        return self

    def __exit__(self, *exc):
        _recorder.cohort = self.outer
        return False


def span(name: str):
    """A host span around the block (the shared no-op while off)."""
    if not _on:
        return NOOP
    return _Span(name)


def root(name: str = "step"):
    """A span that opens a call: a root span, or the no-op where a span is
    already open on this thread (a step called from another step's API)."""
    if not _on or _recorder.stack():
        return NOOP
    return _Span(name)


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name`` (nothing while off)."""
    if _on:
        with _recorder.lock:
            _recorder.counters[name] += int(n)


def mark(event):
    """Record ``event`` on the current stream and return it while the
    recorder is on (for :func:`overlap`); None while off, and nothing is
    recorded."""
    if not _on:
        return None
    event.record()
    return event


def overlap(staged_bytes: int, behind) -> None:
    """A cohort's write into its host buffers has ended, ``staged_bytes`` of
    it, after an earlier cohort of the same call had its replay enqueued
    (``behind``: :func:`mark`'s event after that replay; None for a call's
    first cohort). The bytes count as ``overlap_staged_bytes``; a
    non-blocking query of ``behind`` counts the write as
    ``overlap_hidden_writes`` where that replay was still running, else as
    ``overlap_exposed_writes`` (the card had waited for the host). Nothing
    while off, for a first cohort, or where nothing was written."""
    if not _on or behind is None or not staged_bytes:
        return
    name = "overlap_exposed_writes" if behind.query() else "overlap_hidden_writes"
    with _recorder.lock:
        _recorder.counters["overlap_staged_bytes"] += int(staged_bytes)
        _recorder.counters[name] += 1


def device_span(name: str, device: torch.device):
    """Stamps on ``device`` before and after the block's work, while a graph
    is being captured with the recorder on (after :func:`prepare` for the
    device); the no-op otherwise (eager work, the CPU)."""
    if not _on:
        return NOOP
    index = torch.cuda._get_device_index(device, optional=True) if device.type == "cuda" else None
    if index not in _recorder.rings or not torch.cuda.is_current_stream_capturing():
        return NOOP
    return _DeviceSpan(_recorder.rings[index], name)


def device_counters(device: torch.device):
    """The device counters on ``device`` (int64, :data:`DEVICE_COUNTERS`'s
    slots) while a graph is captured there with the recorder on (after
    :func:`prepare`); None otherwise, and nothing is counted."""
    if not _on or device.type != "cuda" or not torch.cuda.is_current_stream_capturing():
        return None
    ring = _recorder.rings.get(torch.cuda._get_device_index(device, optional=True))
    return None if ring is None else ring.counters


def count_occlusion_states(state: torch.Tensor) -> None:
    """Add each stream-frame's occlusion state (``state``, () or (B,)
    integers 0-5) to the ``occlusion_states.<s>`` device counters, in a
    graph captured with the recorder on."""
    counters = device_counters(state.device)
    if counters is not None:
        s = state.reshape(-1).to(torch.int64)
        counters[2:].index_add_(0, s, torch.ones_like(s))


def cohort(index: int):
    """Mark the device spans captured in the block as lockstep cohort
    ``index``'s."""
    if not _on:
        return NOOP
    return _Cohort(index)


def prepare(device: torch.device) -> bool:
    """Before a capture on ``device``: its stamp buffer exists and is
    calibrated. Returns whether the capture will hold stamps (the recorder
    is on)."""
    if not _on or device.type != "cuda":
        return False
    if torch.cuda._get_device_index(device, optional=True) not in _recorder.rings:
        ring = _recorder.ring(device)
        ring.calibrate()
    return True


def replayed(device: torch.device) -> None:
    """After a replay of a graph captured with stamps: the replay belongs to
    the call open on this thread."""
    if _on:
        stack = _recorder.stack()
        ring = _recorder.rings[torch.cuda._get_device_index(device, optional=True)]
        ring.replays.append(stack[0].call if stack else next(_recorder.calls))


def enable() -> None:
    """Turn the recorder on. With a CUDA device: the current device's stamp
    buffer is made (at the first call) and emptied, and ``%globaltimer`` is
    calibrated against the host clock anew."""
    global _on
    _on = True
    if torch.cuda.is_available():
        _recorder.ring(torch.device("cuda", torch.cuda.current_device()))
    for ring in _recorder.rings.values():
        ring.reset()
        ring.calibrations = []
        ring.calibrate()


def disable() -> None:
    """Turn the recorder off; what it holds waits for :func:`drain`."""
    global _on
    _on = False


def drain() -> Drained:
    """Everything recorded since the last drain, handed over and forgotten.
    Synchronises each device with stamps and, while the recorder is on,
    calibrates it again."""
    rec = _recorder
    spans, rec.spans = [Span(*s) for s in rec.spans], []
    with rec.lock:
        counters = dict(rec.counters)
        rec.counters.clear()
    device, lost, calibration = [], 0, {}
    for index, ring in rec.rings.items():
        if _on:
            ring.calibrate()
        got, dropped, moved = ring.drain(rec.tag_names)
        device += got
        lost += dropped
        for k, v in moved.items():
            counters[k] = counters.get(k, 0) + v
        if ring.calibrations:
            calibration[index] = dict(offset_ns=ring.calibrations[-1][1],
                                      error_ns=max(c[2] for c in ring.calibrations),
                                      timer_step_ns=ring.timer_step_ns,
                                      timer_mean_step_ns=ring.timer_mean_step_ns)
        if _on:
            ring.calibrations = ring.calibrations[-1:]
    return Drained(spans, counters, device, lost, calibration)


def self_ns(spans: list) -> list:
    """Each span's self time (ns): its duration less the part of it that its
    child spans (same call, this span's name as parent, inside its
    interval) cover."""
    kids = defaultdict(list)
    for s in spans:
        if s.parent is not None:
            kids[(s.call, s.parent)].append(s)
    out = []
    for s in spans:
        inside = [(c.start_ns, c.end_ns) for c in kids[(s.call, s.name)]
                  if c is not s and s.start_ns <= c.start_ns and c.end_ns <= s.end_ns]
        out.append(s.end_ns - s.start_ns - union_ns(inside))
    return out


def union_ns(intervals) -> int:
    """The time (ns) that the union of ``(start, end)`` intervals covers."""
    total, cur_s, cur_e = 0, None, None
    for a, b in sorted(intervals):
        if cur_e is None or a > cur_e:
            total += 0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    return total + (0 if cur_e is None else cur_e - cur_s)


def report(spans: list | None = None) -> str:
    """The reference's "Avg ..." block (trackdlo_node.cpp:525-528): each
    span name's mean ms a call (its spans in a call summed; the names in the
    order they first closed), then the root spans' ("Avg total").
    ``spans`` defaults to those recorded and not yet drained."""
    spans = [Span(*s) for s in _recorder.spans] if spans is None else spans
    totals, calls = defaultdict(int), defaultdict(set)
    for s in spans:
        totals[s.name] += s.end_ns - s.start_ns
        calls[s.name].add(s.call)
    lines = [f"Avg {k}: {totals[k] / len(calls[k]) / 1e6:.3f} ms" for k in totals]
    roots = [s for s in spans if s.parent is None]
    total = sum(s.end_ns - s.start_ns for s in roots) / max(len({s.call for s in roots}), 1) / 1e6
    lines.append(f"Avg total: {total:.3f} ms")
    return "\n".join(lines)


OCCLUSION_STATE_NAMES = {
    0: "All nodes visible",
    1: "Mid-section occluded",
    2: "Tail occluded",
    3: "Head occluded",
    4: "Both ends occluded",
    5: "No visible nodes",
}


def log_step_outputs(outputs, frame_idx: int | None = None) -> None:
    """Observability hook: the reference's per-frame ROS_INFO lines
    (occlusion state trackdlo.cpp:931-981, downsample size
    trackdlo_node.cpp:243, convergence trackdlo.cpp:426-434). Reads the
    outputs on the host."""
    state = OCCLUSION_STATE_NAMES.get(int(outputs.occlusion_state), "?")
    prefix = f"[frame {frame_idx}] " if frame_idx is not None else ""
    logger.info(
        "%s%s | points=%d | EM iterations=%d%s",
        prefix,
        state,
        int(outputs.n_points),
        int(outputs.iterations),
        "" if bool(outputs.converged) else " (did not converge)",
    )
