"""The port's span recorder (trackdlo_tpu_torch.utils.profiling) on the CPU:
off records nothing, the eager step's spans (one call id a call, parents,
self times), the spans as user annotations of a torch.profiler trace, the
pinned-bytes and staged-bytes counters, ``perf/step_spans.py``'s pin rate,
outputs unchanged by tracing, and the grouping of device stamps into
replays. The stamps themselves run only on the card
(tests/test_torch_cuda.py)."""

import gc
import os
import statistics
import time

import numpy as np
import pytest
import torch

from trackdlo_tpu_torch.config import CameraIntrinsics, live_params
from trackdlo_tpu_torch.io.sequence import SyntheticRope, render_frame
from trackdlo_tpu_torch.models.trackdlo import build_step_fn, init_state
from trackdlo_tpu_torch.utils import profiling

SMALL = CameraIntrinsics(fx=120.0, fy=120.0, cx=80.0, cy=60.0, width=160, height=120)
PARAMS = live_params(max_points=256, downsample_cell_px=4, dlo_pixel_width=5)
STEP_SPANS = {"step.prepare", "step.pin", "step.copy_in"}


@pytest.fixture
def recorder():
    """The recorder, off and empty before and after the test."""
    profiling.disable()
    profiling.drain()
    yield profiling
    profiling.disable()
    profiling.drain()


@pytest.fixture(scope="module")
def eager():
    """The eager CPU step, its start state and three frames (numpy rgb, u16
    depth and a bool mask with a band occluded)."""
    rope = SyntheticRope()
    frames = []
    for i in (1, 2, 3):
        rgb, depth = render_frame(rope, i / 15.0, SMALL, rope_pixel_radius=3)
        occ = np.ones((SMALL.height, SMALL.width), bool)
        occ[:, 60:80] = i != 2
        frames.append((rgb, depth, occ))
    state = init_state(rope.nodes(0.0, PARAMS.M), PARAMS, "cpu")
    return build_step_fn(PARAMS, SMALL, jit=False, device="cpu"), state, frames


def _run(step, state, frames):
    outs = []
    for f in frames:
        state, out = step(state, *f)
        outs.append(out)
    return state, outs


def test_off_records_nothing_and_returns_the_shared_noop(recorder, eager):
    cpu = torch.device("cpu")
    for ctx in (recorder.span("a"), recorder.root(), recorder.device_span("a", cpu),
                recorder.cohort(0)):
        assert ctx is recorder.NOOP
    recorder.count("pinned_bytes", 10)
    _run(*eager)
    drained = recorder.drain()
    assert drained.spans == [] and drained.counters == {} and drained.device == []
    assert drained.lost == 0 and recorder.prepare(cpu) is False


def test_eager_step_spans_share_one_call_id_a_call(recorder, eager):
    recorder.enable()
    _run(*eager)
    spans = recorder.drain().spans
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == ["step"] * 3
    assert len({s.call for s in roots}) == 3
    for root in roots:
        kids = [s for s in spans if s.call == root.call and s is not root]
        assert {s.name for s in kids} == STEP_SPANS
        assert all(s.parent == "step" for s in kids)
        assert all(root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns for s in kids)
        # one pin and one copy a frame array: rgb, depth, occ
        assert sum(s.name == "step.pin" for s in kids) == 3
        assert sum(s.name == "step.copy_in" for s in kids) == 3


def test_self_time_is_the_duration_less_the_children(recorder, eager):
    recorder.enable()
    _run(*eager)
    spans = recorder.drain().spans
    self_ns = dict(zip(map(id, spans), recorder.self_ns(spans)))
    for s in spans:
        kids = [k for k in spans if k.call == s.call and k.parent == s.name]
        want = s.end_ns - s.start_ns - sum(k.end_ns - k.start_ns for k in kids)
        assert self_ns[id(s)] == want  # the children do not overlap
        assert 0 <= self_ns[id(s)] <= s.end_ns - s.start_ns
    root = next(s for s in spans if s.parent is None)
    assert self_ns[id(root)] < root.end_ns - root.start_ns


# A span's host bracket (a clock read before entering it, one inside) holds
# both clock reads an offset compares. Brackets run 5-10 µs at the median
# on a quiet host; one the scheduler preempted ran 16-26 µs, its offset 5-6
# µs off the others (measured on the CPU test host). An offset whose bracket
# passes the window's median by more than PREEMPTED_US is left out.
PREEMPTED_US = 10.0
MIN_OFFSETS = 90


def _annotation_offsets(recorder) -> tuple[list, list]:
    """100 spans under a CPU torch.profiler: each one's start on the
    recorder's clock less its user annotation's on the trace's (µs), and
    each one's host bracket (µs)."""
    from torch.profiler import ProfilerActivity, profile

    gc.collect()
    gc.disable()  # a collection inside a span would delay one clock read
    brackets = []
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for i in range(3):  # the first annotations of a profile pay its set-up
                with recorder.span(f"warm{i}"):
                    pass
            os.sched_yield()
            for i in range(100):
                t0 = time.perf_counter_ns()
                with recorder.span(f"span{i}"):
                    t1 = time.perf_counter_ns()
                brackets.append((t1 - t0) / 1e3)
    finally:
        gc.enable()
    spans = {s.name: s for s in recorder.drain().spans}
    events = {e.name: e for e in prof.events() if e.name.startswith("span")}
    assert len(events) == 100
    assert all(e.is_user_annotation for e in events.values())
    offsets = [spans[f"span{i}"].start_ns / 1e3 - events[f"span{i}"].time_range.start
               for i in range(100)]
    return offsets, brackets


def test_spans_are_user_annotations_on_one_offset(recorder):
    """One constant offset between the two clocks: the spread of the
    offsets is at most 20 µs. The host's scheduler can preempt the process
    between the trace's clock read and the recorder's (tens of µs on a
    loaded machine); such a span's own host bracket shows it
    (:data:`PREEMPTED_US`), and its offset is left out. At least
    :data:`MIN_OFFSETS` of 100 must remain; a window with fewer is measured
    again, at most twice."""
    recorder.enable()
    for _ in range(3):
        offsets, brackets = _annotation_offsets(recorder)
        cut = statistics.median(brackets) + PREEMPTED_US
        kept = [o for o, b in zip(offsets, brackets) if b <= cut]
        if len(kept) >= MIN_OFFSETS:
            break
    assert len(kept) >= MIN_OFFSETS, (len(kept), sorted(brackets)[-10:])
    assert max(kept) - min(kept) <= 20.0, (max(kept) - min(kept), len(kept))


def test_pinned_bytes_count_the_frames_handed_over(recorder, eager):
    step, state, frames = eager
    recorder.enable()
    _run(step, state, frames)
    drained = recorder.drain()
    want = sum(a.nbytes for f in frames for a in f)
    assert drained.counters == {"pinned_bytes": want}


def test_tracing_leaves_the_eager_step_bit_for_bit(recorder, eager):
    state_off, outs_off = _run(*eager)
    recorder.enable()
    state_on, outs_on = _run(*eager)
    assert recorder.drain().spans
    flat = lambda state, outs: [*state, *(t for out in outs for t in out)]  # noqa: E731
    for x, y in zip(flat(state_off, outs_off), flat(state_on, outs_on), strict=True):
        assert torch.equal(x, y)


def test_batched_eager_step_opens_one_root_a_frame_set(recorder):
    from trackdlo_tpu_torch.parallel import build_batched_step_fn, replicate_state

    rope = SyntheticRope()
    step = build_batched_step_fn(PARAMS, SMALL, cohort_size=1, device="cpu", jit=False)
    state = replicate_state(init_state(rope.nodes(0.0, PARAMS.M), PARAMS, "cpu"), 2)
    rgb, depth = render_frame(rope, 1 / 15.0, SMALL, rope_pixel_radius=3)
    frames = [np.stack([a, a]) for a in (rgb, depth, np.ones(depth.shape, np.uint8))]
    recorder.enable()
    step(state, *frames)
    drained = recorder.drain()
    assert {s.call for s in drained.spans} == {drained.spans[-1].call}
    assert drained.spans[-1].name == "step" and drained.spans[-1].parent is None
    assert {s.name for s in drained.spans[:-1]} == STEP_SPANS
    assert drained.counters["pinned_bytes"] == sum(a.nbytes for a in frames)


def test_staging_write_counts_staged_bytes_under_step_pin(recorder):
    """The graph step's write into a host staging buffer (a plain CPU
    tensor here) is the span ``step.pin`` and counts the buffer's bytes as
    ``staged_bytes``; it pins nothing afresh."""
    from trackdlo_tpu_torch.models.trackdlo import _stage

    buf = torch.empty((SMALL.height, SMALL.width), dtype=torch.bool)
    mask = np.ones((SMALL.height, SMALL.width, 3), np.uint8)
    recorder.enable()
    with recorder.root():
        _stage(buf, mask, "occ")
    drained = recorder.drain()
    assert drained.counters == {"staged_bytes": buf.nbytes}
    assert [(s.name, s.parent) for s in drained.spans] == [("step.pin", "step"), ("step", None)]


def _step_spans():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "perf" / "step_spans.py"
    spec = importlib.util.spec_from_file_location("step_spans", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("counters", [{"pinned_bytes": 6_000_000},
                                      {"staged_bytes": 6_000_000, "staging_waits": 1},
                                      {"pinned_bytes": 2_000_000, "staged_bytes": 4_000_000}],
                         ids=["eager", "graph", "both"])
def test_step_spans_pin_rate_reads_pinned_and_staged_bytes(counters):
    """``perf/step_spans.py``'s ``api.pin_gb_per_s``: the bytes through
    ``step.pin`` (pinned afresh by an eager step, staged by a graph step)
    over its time; the three counters a call, 0 where never counted."""
    spans = []
    for call in (1, 2):
        t = 10_000_000 * call
        spans += [profiling.Span("step.pin", t, t + 500_000, "step", call),
                  profiling.Span("step.replay", t + 600_000, t + 700_000, "step", call),
                  profiling.Span("step", t, t + 1_000_000, None, call)]
    drained = profiling.Drained(spans, counters, [], 0, {})
    got = _step_spans().readings(drained, 2, 0.004, 0.5)
    assert got["api.pin_gb_per_s"] == pytest.approx(6.0)  # 6 MB in 1 ms
    want = {k: counters.get(k, 0) / 2 for k in ("pinned_bytes", "staged_bytes", "staging_waits")}
    assert got["counters_per_call"] == want
    assert got["api.stage_in_ms"] == pytest.approx(0.5) and got["api.replay_ms"] == pytest.approx(0.1)


def test_stamps_group_into_the_replays_of_their_calls():
    names = [("replay", None, False), ("preprocess", 0, False), ("preprocess", 0, True),
             ("preprocess", 1, False), ("preprocess", 1, True), ("replay", None, True)]
    one = [0, 1, 2, 3, 4, 5]
    times = [100 * i + t for i in range(3) for t in (0, 1, 3, 4, 7, 9)]
    spans = profiling.group_stamps(times, one * 3, names, [7, 9], lambda d: d + 1000)
    # the third replay has no call: it is left out
    assert [(s.name, s.call, s.cohort) for s in spans] == [
        ("preprocess", 7, 0), ("preprocess", 7, 1), ("replay", 7, None),
        ("preprocess", 9, 0), ("preprocess", 9, 1), ("replay", 9, None)]
    assert [(s.start_ns, s.end_ns) for s in spans[:3]] == [(1001, 1003), (1004, 1007),
                                                            (1000, 1009)]
    # stamps cut off by a full buffer: the open spans of the last replay are dropped
    cut = profiling.group_stamps(times[:9], (one * 2)[:9], names, [7, 9], lambda d: d)
    assert [(s.name, s.call) for s in cut] == [("preprocess", 7), ("preprocess", 7),
                                               ("replay", 7), ("preprocess", 9)]
