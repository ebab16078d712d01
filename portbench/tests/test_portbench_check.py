"""The check that decides ``correct``, against its control and its faults.

The control (the reference with TF32 matrix products, judged in the
program's place) and every fault a cell can have must come out not
correct, where the program's own runs come out correct. Faults: a step
that returns its state unchanged, half of a batch left out (the rest given
the mean of the half that ran), an answer altered where it is produced; and
faults confined to a few of the stream-frames the check samples: one stream
of a batch handed another stream's frame, one stream's answer altered, and
the answers altered on occluded frames alone. One card, so no exchange
between chips to leave out. These tests skip the
harness's look for a card and drive the rest of a run on the CPU (the
port's plain kernels) at a size a test run holds: a few frames, and the
batched cells with 4 streams in cohorts of 2; a window of as many calls as
the check samples, the first and three more of a batch (as the cell), the
first and eleven more of one stream (so six or more are occluded: more
than the cell lets be off). The card test runs the control at each cell's
own size.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import control, run, spec

SEED = 3 * 2 ** 31 + 17


def small(name: str) -> dict:
    """The cell at a size a CPU test run holds: an 8-frame film (a band
    occluding frames 2-5 of it, where the cell has a band), 4 streams."""
    cell = spec.cell(name)
    cell["cell"].update(warmup_calls=1)
    t = cell["traffic_file"]
    if t["occlusion"]["kind"] == "band":
        t["occlusion"]["frames"] = [2, 6]
    if t["streams"] == 1:
        cell["cell"]["check"].update(calls=11, streams=1)
        t.update(film_frames=8, positions=8)
    else:
        cell["cell"]["check"].update(calls=3, streams=4)
        cell["cell"]["cohort"] = 2
        t.update(streams=4, film_frames=24, positions=4, stream_offsets=[0, 1, 2, 3],
                 stream_films=[s % t.get("films", 1) for s in range(4)])
        if t["occlusion"]["kind"] == "gt_bbox":
            t["occlusion"]["pct"] = [0, 25, 50, 75]
    return cell


def unchanged(step):
    def broken(state, *frames):
        _, out = step(state, *frames)
        return state, out._replace(y=state.y.clone(), sigma2=state.sigma2.clone())
    return broken


def half_batch(step):
    """The second half of the streams gets the mean of the first half's
    nodes and sigma^2."""
    def broken(state, *frames):
        new, out = step(state, *frames)
        h = out.y.shape[0] // 2
        y, s2 = out.y.clone(), out.sigma2.clone()
        y[h:] = y[:h].mean(0)
        s2[h:] = s2[:h].mean(0)
        return new._replace(y=y, sigma2=s2), out._replace(y=y, sigma2=s2)
    return broken


def altered(step):
    """Every answer's first node moved 1 cm where it is produced."""
    def broken(state, *frames):
        new, out = step(state, *frames)
        y = out.y.clone()
        y[..., 0, 0] += 0.01
        return new._replace(y=y), out._replace(y=y)
    return broken


def last_stream_frame(step):
    """The last stream handed the first stream's frame and mask (a slip in
    indexing the batch)."""
    def broken(state, rgb, depth, occ):
        rgb, depth, occ = rgb.copy(), depth.copy(), occ.copy()
        rgb[-1], depth[-1], occ[-1] = rgb[0], depth[0], occ[0]
        return step(state, rgb, depth, occ)
    return broken


def last_stream_altered(step):
    """The last stream's first node moved 1 cm where it is produced."""
    def broken(state, *frames):
        new, out = step(state, *frames)
        y = out.y.clone()
        y[-1, 0, 0] += 0.01
        return new._replace(y=y), out._replace(y=y)
    return broken


def occluded_altered(step):
    """The first node moved 1 cm in the answers to occluded frames alone."""
    def broken(state, rgb, depth, occ):
        new, out = step(state, rgb, depth, occ)
        hidden = ~np.asarray(occ).reshape(*out.y.shape[:-2], -1).all(-1)
        y = out.y.clone()
        y[..., 0, 0] += 0.01 * torch.as_tensor(hidden, dtype=y.dtype)
        return new._replace(y=y), out._replace(y=y)
    return broken


def run_small(name, wrap=None):
    """A run of the small cell whose window makes the calls the check
    samples, and no more."""
    cell = small(name)
    result, lines = run.run(cell, SEED, 0.0, False, device="cpu", wrap_step=wrap,
                            calls=cell["cell"]["check"]["calls"] + 1)
    return result, lines


@pytest.mark.parametrize("name", ["live.single", "eval.single"])
def test_sound_small_run_is_correct(name):
    result, lines = run_small(name)
    assert result["correct"] is True, lines


@pytest.mark.parametrize("name,fault", [
    ("live.single", unchanged), ("live.single", altered),
    ("eval.single", unchanged), ("eval.single", altered),
    ("live.b16c8", unchanged), ("live.b16c8", half_batch), ("live.b16c8", altered),
])
def test_broken_step_is_not_correct(name, fault):
    result, lines = run_small(name, fault)
    assert result["correct"] is False, lines
    assert any(line.endswith("FAIL") for line in lines)


@pytest.mark.parametrize("name,fault", [
    ("live.b16c8", last_stream_frame), ("live.b16c8", last_stream_altered),
    ("live.b16c8", occluded_altered), ("live.single", occluded_altered),
])
def test_fault_in_a_few_stream_frames_leaves_too_many_off(name, fault):
    """One stream of the batch, or the occluded frames alone: every
    sampled stream-frame is judged, so these fail on the count of
    stream-frames off, not by the luck of a ceiling."""
    result, lines = run_small(name, fault)
    assert result["correct"] is False, lines
    off, = [line for line in lines if line.startswith("check frames_off ")]
    assert off.endswith("FAIL"), lines


@pytest.mark.parametrize("name", ["live.single", "live.b16c8"])
def test_control_is_not_correct(name):
    rec, = control.readings(small(name), [SEED + 1], 0.5, device="cpu")
    assert rec["program_correct"] is True, rec
    assert rec["control_correct"] is False, rec


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["live.single", "live.b16c8", "eval.single"])
def test_control_fails_at_the_cells_size_on_the_card(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for rec in control.readings(spec.cell(name), [SEED + 2, SEED + 3, SEED + 4], 2.0):
        assert rec["program_correct"] is True, rec
        assert rec["control_correct"] is False, rec
