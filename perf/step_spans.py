"""The port's step split by its own span recorder, in a benchmark cell.

Run on a machine with an NVIDIA GPU and nvcc, from the repository root:

    python3 perf/step_spans.py split --workload live.b16c8 --seed 7 [--calls N] [--profile 1]
    python3 perf/step_spans.py cost --workload live.single --seed 7 --on 1 [--seconds 10]

``split``: builds the cell's step as ``portbench`` does (its configuration,
traffic and step entry), turns the recorder (``trackdlo_tpu_torch.utils.
profiling``) on before the set-up so that the captured graph carries the
device stamps, drains the set-up's spans, then makes ``--calls`` calls (the
cell's ``trace_calls`` by default) closed loop, untraced, as the harness's
window does (numpy frames in, y and sigma^2 read back), and drains again.
It prints the readings below, and with ``--profile 1`` makes the same calls
once more under ``torch.profiler`` with the recorder on and prints the
device's longest idle gaps, each named by the shortest host event around it
(the program's spans among them; the stamp kernel left out of the device's
events). Prints one JSON line.

Readings, per call of the untraced calls:

- ``api.stage_in_ms``: host ms in ``step.prepare`` + ``step.pin`` +
  ``step.copy_in``; ``api.pin_gb_per_s``: the bytes that went through
  ``step.pin`` (the ``pinned_bytes`` an eager step pins afresh plus the
  ``staged_bytes`` a graph step writes into its persistent pinned buffers)
  over the time in ``step.pin``; ``counters_per_call``: ``pinned_bytes``,
  ``staged_bytes`` and ``staging_waits`` a call, beside
  ``handed_bytes_per_call``, the bytes of the frame arrays a call hands
  over; ``api.replay_ms``, ``api.copy_out_ms``: host ms in ``step.replay``,
  ``step.copy_out``; ``readback_ms``: the host's wait for y and sigma^2;
- ``<layer>.device_ms``: device ms between the stamps of ``preprocess``,
  ``visibility``, ``em.pre`` + ``em.main`` (``em``) and ``priors``, every
  cohort summed; ``preprocess.split_cells.device_ms``: kernel X's stamps,
  inside the preprocessing's;
- ``device_counters_per_call``: the recorder's device counters a call
  (``dropout_points``, ``split_cells``, ``occlusion_states.<s>``; those
  that moved);
- ``device.replay_idle_pct``: 100 (1 - the replays' device spans over the
  calls' host seconds), a lower bound on the idle share (gaps inside a
  replay count as busy);
- closure: the host spans and the readback over the calls' mean host ms,
  and the layers' device ms over the replays'.

``cost``: the harness's own untraced run (``portbench.run.run``, as
``--trace 0`` runs it) of the cell, with the recorder turned on before it
(``--on 1``: every call records its spans, the graph stamps every replay)
or left off; prints the result line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

STAGE_IN = ("step.prepare", "step.pin", "step.copy_in")
COUNTERS = ("pinned_bytes", "staged_bytes", "staging_waits")
LAYERS = {"preprocess": ("preprocess",), "visibility": ("visibility",),
          "em": ("em.pre", "em.main"), "priors": ("priors",)}
STAMP_KERNEL = "stamp_kernel"


def readings(drained, calls: int, host_s: float, readback_ms: float) -> dict:
    """The readings of ``calls`` calls from what the recorder drained over
    them (``host_s``: their host seconds; ``readback_ms``: the host's mean
    wait for the outputs a call). None where the spans are missing or the
    device buffer dropped stamps."""
    host = defaultdict(int)
    for s in drained.spans:
        host[s.name] += s.end_ns - s.start_ns
    ms = lambda names: sum(host[n] for n in names) / calls / 1e6  # noqa: E731
    counters = {k: drained.counters.get(k, 0) for k in COUNTERS}
    out = {"calls": calls, "host_ms_per_call": 1e3 * host_s / calls, "readback_ms": readback_ms,
           "api.stage_in_ms": ms(STAGE_IN), "api.replay_ms": ms(("step.replay",)),
           "api.copy_out_ms": ms(("step.copy_out",)),
           "api.pin_gb_per_s": (counters["pinned_bytes"] + counters["staged_bytes"])
           / host["step.pin"] if host["step.pin"] else None,
           "counters_per_call": {k: v / calls for k, v in counters.items()},
           "device_counters_per_call": {k: v / calls for k, v in sorted(drained.counters.items())
                                        if k not in COUNTERS},
           "host_span_ms": {k: v / calls / 1e6 for k, v in sorted(host.items())},
           "stamps_lost": drained.lost, "calibration": drained.calibration}
    out["closure_host"] = (out["api.stage_in_ms"] + out["api.replay_ms"] + out["api.copy_out_ms"]
                           + readback_ms) / out["host_ms_per_call"]
    # each name's spans a call in the order they ran: "step.pin#1" is the
    # second array a call wrote or pinned (a graph step: state, rgb, depth,
    # mask, those that are not on the card; the eager Tracker.step pins its
    # mask before the frame)
    nth, seen = defaultdict(int), defaultdict(int)
    for s in sorted(drained.spans, key=lambda s: s.start_ns):
        key = (s.call, s.name)
        nth[f"{s.name}#{seen[key]}"] += s.end_ns - s.start_ns
        seen[key] += 1
    out["host_span_ms_in_order"] = {k: v / calls / 1e6 for k, v in sorted(nth.items())}
    dev = defaultdict(int)
    for s in drained.device:
        dev[s.name] += s.end_ns - s.start_ns
    replays = {s.call for s in drained.device if s.name == "replay"}
    if drained.lost or len(replays) != calls:
        return {**out, **{f"{k}.device_ms": None for k in LAYERS},
                "device.replay_idle_pct": None, "closure_device": None}
    for k, names in LAYERS.items():
        out[f"{k}.device_ms"] = sum(dev[n] for n in names) / calls / 1e6
    out["preprocess.split_cells.device_ms"] = dev["preprocess.split_cells"] / calls / 1e6
    out["replay_device_ms"] = dev["replay"] / calls / 1e6
    out["device.replay_idle_pct"] = 100.0 * (1.0 - dev["replay"] / 1e9 / host_s)
    out["closure_device"] = sum(dev[n] for names in LAYERS.values() for n in names) / dev["replay"]
    cohorts = defaultdict(int)
    for s in drained.device:
        if s.cohort is not None:
            cohorts[f"{s.name}.cohort{s.cohort}"] += s.end_ns - s.start_ns
    out["device_ms_by_cohort"] = {k: v / calls / 1e6 for k, v in sorted(cohorts.items())}
    return out


def _cell(name: str, seed: int):
    """The cell's step, start state and frames, as ``portbench.run.run``
    builds them."""
    import numpy as np
    import torch

    from portbench import spec
    from portbench.reference.pipeline import Camera
    from portbench.run import program_params
    from portbench.traffic import Traffic

    cell = spec.cell(name)
    c, cfg = cell["cell"], cell["config_file"]
    params, intr = program_params(cfg)
    dev = torch.device("cuda")
    torch.set_num_threads(int(c["host_threads"]))
    traffic = Traffic(cell["traffic_file"], Camera(**cfg["camera"]), params.num_of_nodes, seed)
    init, step = spec.entry(c["entry"]).build(params, intr, c, traffic.streams, dev)
    nodes = [traffic.init_nodes(s).astype(np.float32) for s in range(traffic.streams)]
    return c, traffic, step, (lambda: init(nodes))


def _loop(step, state, traffic, calls: int):
    """``calls`` closed-loop calls: (host seconds, mean readback ms)."""
    readback = 0
    t_start = time.perf_counter_ns()
    for k in range(calls):
        state, out = step(state, *traffic.frame_set(k))
        t0 = time.perf_counter_ns()
        out.y.cpu().numpy()
        out.sigma2.cpu().numpy()
        readback += time.perf_counter_ns() - t0
    return (time.perf_counter_ns() - t_start) / 1e9, readback / calls / 1e6


def split(args) -> dict:
    import torch

    from trackdlo_tpu_torch import _build
    from trackdlo_tpu_torch.utils import profiling

    _build.lib()
    profiling.enable()
    c, traffic, step, start = _cell(args.workload, args.seed)
    calls = args.calls or int(c["trace_calls"])
    _loop(step, start(), traffic, int(c["warmup_calls"]) + 1)
    torch.cuda.synchronize()
    profiling.drain()
    host_s, readback_ms = _loop(step, start(), traffic, calls)
    handed = sum(a.nbytes for k in range(calls) for a in traffic.frame_set(k)) / calls
    result = {"cell": args.workload, "seed": args.seed,
              "device": torch.cuda.get_device_name(0), "handed_bytes_per_call": handed,
              **readings(profiling.drain(), calls, host_s, readback_ms)}
    if args.profile:
        result["traced"] = _profiled(step, start(), traffic, calls)
    return result


def _profiled(step, state, traffic, calls: int) -> dict:
    """The same calls under torch.profiler, the recorder on: the device's
    longest idle gaps named by the host events around them, and the
    readings of the traced calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from portbench.trace import LABELS, Trace, base_name
    from trackdlo_tpu_torch.utils import profiling

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        host_s, readback_ms = _loop(step, state, traffic, calls)
    device, host = [], []
    for e in prof.events():
        row = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type != torch.autograd.DeviceType.CUDA:
            host.append(row)
        elif (not getattr(e, "is_user_annotation", False) and e.name not in LABELS
              and base_name(e.name) != STAMP_KERNEL):
            device.append(row)
    trace = Trace(device, host, {})
    drained = profiling.drain()
    return {"host_s": host_s, "busy_s": trace.busy_us() / 1e6,
            "idle_gaps": trace.idle_gaps(), "device_ops": trace.top_device_ops(),
            "readings": readings(drained, calls, host_s, readback_ms)}


def cost(args) -> dict:
    from portbench import spec
    from portbench.run import cache_dirs, run
    from trackdlo_tpu_torch import _build
    from trackdlo_tpu_torch.utils import profiling

    cache_dirs()
    _build.lib()
    if args.on:
        profiling.enable()
    result, lines = run(spec.cell(args.workload), args.seed, args.seconds, False)
    for line in lines:
        print(line, file=sys.stderr)
    drained = profiling.drain()
    return {"cell": args.workload, "seed": args.seed, "recorder_on": bool(args.on),
            "spans": len(drained.spans), "stamps_lost": drained.lost, **result}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("split", "cost"))
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--calls", type=int, default=0)
    ap.add_argument("--profile", type=int, default=0)
    ap.add_argument("--on", type=int, default=0)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    result = split(args) if args.mode == "split" else cost(args)
    print(json.dumps(result, default=str), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
