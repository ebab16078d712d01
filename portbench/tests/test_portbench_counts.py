"""The copied roofline arithmetic, and the per-layer readers on made-up traces."""

from __future__ import annotations

import pytest

from portbench import roofline, spec
from portbench.layers import Context
from portbench.trace import Trace

# chip_smoke.py's kernel_bounds at the live shapes, as it recorded them on an
# H100: one 1280x720 frame at an 11 px cell for P; 10 iterations of 45 nodes
# over the 351 valid points of its cloud, 2048 rows, for E.
P_BOUND_MS = 0.001945676417910448
E_BOUND_MS = 0.00019167985074626864


def test_cell_sums_bound_is_the_chip_checks():
    n_cells = roofline.grid_cells(720, 1280, 11)
    assert n_cells == 66 * 117
    ms, what = roofline.cell_sums_bound(1, 720, 1280, n_cells, "parity")
    assert what == "bytes"
    assert ms == pytest.approx(P_BOUND_MS, rel=1e-12)
    assert roofline.cell_sums_bound(8, 720, 1280, n_cells)[0] == pytest.approx(8 * ms, rel=1e-12)


def test_em_loop_bound_at_ten_iterations_is_the_chip_checks():
    ms, what = roofline.em_loop_bound(2048, 45, 351, 10)
    assert what == "operations"
    assert ms == pytest.approx(E_BOUND_MS, rel=1e-12)
    # The frame's own trips: the operations scale with them.
    assert roofline.em_loop_bound(2048, 45, 351, 5)[0] == pytest.approx(E_BOUND_MS / 2, rel=1e-12)


def test_solve_counts():
    assert roofline.gj_solve_ops(45) == 2 * 45 ** 3 + 2 * 45 * 45 * 3 + 3 * 10 * 2 * 45 * 45 * 3
    assert roofline.em_mstep_ops(45) - roofline.gj_solve_ops(45) == 9 * 2 * 45 * 45 * 3
    assert roofline.onehot_mstep_ops(48) < roofline.gj_solve_ops(48)


def frames(calls, streams, trips):
    """Records of ``calls`` x ``streams`` stream-frames, stream ``s`` taking
    ``trips(call, s)`` = (pre, main) iterations."""
    out = []
    for k in range(calls):
        for s in range(streams):
            pre, main = trips(k, s)
            out.append(dict(call=k, stream=s, iterations=main, guide_iterations=pre,
                            guide_count=45, nodes=45, n_points=350, rows=2048,
                            in_reach_pre=350, in_reach_main=350))
    return out


def context(trace, calls=2, streams=16, cohort=8, recs=None):
    return Context(trace=trace, calls=calls, streams=streams, window_s=0.01, plain_s=0.005,
                   cohort=cohort,
                   frames=recs or [], height=720, width=1280, cell_px=11, mode="parity")


def read(name, ctx):
    return spec.reader(name)(ctx)


def test_lockstep_tax_is_one_when_every_stream_needs_the_loops_trips():
    recs = frames(2, 16, lambda k, s: (7 + k, 3))
    loops = 2 * 2 * 2  # two passes, two cohorts, two calls
    trips = sum(7 + k + 3 for k in range(2)) * 2  # every cohort: its streams' trips
    ctx = context(Trace([], [], {"loop_flag": trips + loops}), recs=recs)
    assert read("em.lockstep_tax", ctx) == pytest.approx(1.0)


def test_lockstep_tax_counts_the_slowest_stream_of_each_cohort():
    recs = frames(1, 16, lambda k, s: (4 + (s == 3) * 6, 2))  # stream 3 needs 10 pre trips
    trips = (10 + 2) + (4 + 2)  # cohort 0 runs stream 3's trips, cohort 1 its own
    ctx = context(Trace([], [], {"loop_flag": trips + 4}), calls=1, recs=recs)
    needed = 16 * (4 + 2) + 6
    assert read("em.lockstep_tax", ctx) == pytest.approx(trips * 8 / needed)
    # A tally that disagrees with the outputs is no reading.
    ctx = context(Trace([], [], {"loop_flag": trips + 5}), calls=1, recs=recs)
    assert read("em.lockstep_tax", ctx) is None


def kernel(name, start, end):
    return (f"void {name}<48>(Args)", float(start), float(end))


def test_trace_kernel_metric_left_out_where_counts_disagree():
    dev = [kernel("cell_sums_kernel", 0, 10), kernel("compact_kernel", 10, 12),
           kernel("cell_sums_kernel", 20, 30), kernel("compact_kernel", 30, 32)]
    ok = Trace(dev, [], {"cell_sums": 2, "compact": 2})
    assert read("preprocess.kernel_ms", context(ok, calls=2, streams=1, cohort=1)) \
        == pytest.approx(24e-3 / 2)
    lost = Trace(dev, [], {"cell_sums": 3, "compact": 2})
    assert read("preprocess.kernel_ms", context(lost, calls=2, streams=1, cohort=1)) is None
    assert read("kernel.cell_sums.roofline_pct", context(lost, calls=2, streams=1)) is None
    assert read("visibility.kernel_ms", context(ok, calls=2, streams=1)) is None  # V never ran


def test_idle_share_only_where_every_port_kernel_is_counted_whole():
    dev = [kernel("em_loop_kernel", 0, 400), ("Memcpy HtoD (Pinned -> Device)", 500.0, 600.0),
           kernel("em_loop_kernel", 900, 1000)]
    whole = Trace(dev, [], {"em_loop": 2})
    ctx = context(whole, calls=1, streams=1, cohort=1)
    ctx.window_s, ctx.plain_s = 5e-3, 2e-3  # the idle share counts no profiler time
    assert whole.busy_us() == 600.0
    assert read("device_idle_pct", ctx) == pytest.approx(70.0)
    ctx.plain_s = None
    assert read("device_idle_pct", ctx) is None
    part = Trace(dev, [], {"em_loop": 2, "loop_flag": 5})
    assert read("device_idle_pct", context(part, calls=1, streams=1, cohort=1)) is None


def test_em_roofline_at_each_frames_own_trips():
    recs = frames(1, 1, lambda k, s: (10, 10))
    dev = [kernel("em_loop_kernel", 0, 500), kernel("em_loop_kernel", 600, 1100)]
    ctx = context(Trace(dev, [], {"em_loop": 2}), calls=1, streams=1, cohort=1, recs=recs)
    least = 2 * roofline.em_loop_bound(2048, 45, 350, 10)[0]
    assert read("kernel.em_loop.roofline_pct", ctx) == pytest.approx(100 * least / 1.0)


def test_runtime_calls_per_call():
    host = [("cudaGraphLaunch", 0.0, 1.0), ("cudaMemcpyAsync", 1.0, 2.0),
            ("cudaLaunchKernel", 2.0, 3.0), ("aten::copy_", 0.0, 3.0),
            ("cudaStreamSynchronize", 3.0, 9.0)]
    ctx = context(Trace([], host, {}), calls=1, streams=1, cohort=1)
    assert read("api.host_launches_per_call", ctx) == 3.0
