"""Run one cell of the port's benchmark once, and print one JSON line.

    python -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the repository's root, on a machine with the CUDA cards the cell asks
for. In order: load the port's kernel library (built into
``build/trackdlo_tpu_torch/`` of this checkout at its first run), render the
cell's frames from the seed, warm up and capture the cell's own step, then

- ``--trace 0``: call the step for ``--seconds`` seconds, closed loop (each
  call hands the step numpy frame(s) and mask(s) once the previous call's
  nodes are on the host), timing each call on the host clock from the
  hand-over to its nodes and sigma^2 on the host as numpy, and report the
  cell's end-to-end metrics;
- ``--trace 1``: call it the cell's ``trace_calls`` times untraced, then as
  many times again under ``torch.profiler``, and report the cell's
  per-layer metrics, the device's busy and window seconds and a breakdown.

Either way, once the window has closed, a sample of its answers is checked
against the float64 reference (:mod:`portbench.check`); each number compared
is printed beside its limit as the last lines of standard error and under
the result's last key, ``checks``. The last line of standard output is the
result. Without the cards the cell asks for, or with JAX or the JAX package
loaded, the run exits non-zero and prints no result.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

from portbench import check, spec  # noqa: E402
from portbench.layers import Context  # noqa: E402
from portbench.reference.pipeline import Camera  # noqa: E402
from portbench.trace import LABELS, Trace  # noqa: E402
from portbench.traffic import Traffic  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "trackdlo_tpu")


def cache_dirs() -> None:
    """Every kernel and build cache the libraries the port loads could
    write, at fixed paths inside the checkout (the port's own build lives
    in ``build/trackdlo_tpu_torch/``)."""
    base = CHECKOUT / "build" / "portbench"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv_compute_cache")):
        os.environ[var] = str(base / sub)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({k for k in sys.modules if k.split(".")[0] in FORBIDDEN})


def page_faults() -> tuple[int, int]:
    """(minor, major) page faults of the process so far."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_minflt, ru.ru_majflt


def program_params(cfg: dict):
    from trackdlo_tpu_torch.config import CameraIntrinsics, TrackerParams

    fields = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg["tracker"].items()}
    return TrackerParams(**fields), CameraIntrinsics(**cfg["camera"])


def answers(out, s: int | None) -> dict:
    """Stream ``s``'s answer (``None``: the only stream) as numpy, in the
    reference's layout (:func:`portbench.check.reference_step`)."""
    pick = (lambda t: t) if s is None else (lambda t: t[s])
    mask = pick(out.points_mask).cpu().numpy().astype(bool)
    gc = int(pick(out.guide_count))
    return dict(points=pick(out.points).cpu().numpy()[mask],
                visible=pick(out.visible_mask).cpu().numpy(),
                extended=pick(out.extended_mask).cpu().numpy(),
                guides=pick(out.guide_nodes).cpu().numpy()[:gc],
                prior_mask=pick(out.prior_mask).cpu().numpy().astype(bool),
                prior_pos=pick(out.prior_pos).cpu().numpy(),
                occlusion_state=int(pick(out.occlusion_state)),
                y=pick(out.y).cpu().numpy(), sigma2=float(pick(out.sigma2)))


def frame_records(traced, streams: int, prune_radius: float) -> list[dict]:
    """One record a traced stream-frame (:class:`portbench.layers.Context`),
    from the kept outputs and input states, worked out after the window."""
    import torch

    rows = []
    for k, y_in, _, out in traced:
        y_in = torch.as_tensor(np.asarray(y_in), device=out.y.device).reshape(streams, -1, 3)
        pts = out.points.reshape(streams, -1, 3)
        valid = out.points_mask.reshape(streams, -1)
        ext = out.extended_mask.reshape(streams, -1)
        d2 = ((pts[:, :, None, :] - y_in[:, None, :, :]) ** 2).sum(-1)  # (B, N, M)
        reach = d2 < prune_radius ** 2
        main = (reach.any(-1) & valid).sum(-1).tolist()
        pre = ((reach & ext[:, None, :]).any(-1) & valid).sum(-1).tolist()
        per = lambda t: t.reshape(streams).tolist()  # noqa: E731
        it, git = per(out.iterations), per(out.guide_iterations)
        gc, npts = per(out.guide_count), per(out.n_points)
        for s in range(streams):
            rows.append(dict(call=k, stream=s, iterations=it[s], guide_iterations=git[s],
                             guide_count=gc[s], nodes=y_in.shape[1], n_points=npts[s],
                             rows=pts.shape[1], in_reach_pre=pre[s], in_reach_main=main[s]))
    return rows


class Window:
    """What the window leaves for the check and the report: the calls made,
    their host latencies (s), the window's seconds, the stream-frames whose
    nodes came back non-finite, and the kept calls, each (call, input nodes,
    input sigma^2, outputs): the first, a uniform sample of the rest
    (``kept``), and every call of a traced window (``traced``)."""

    def __init__(self):
        self.calls, self.lat, self.window_s, self.failed = 0, [], 0.0, 0
        self.first, self.kept, self.traced = None, [], []


def measure(step, state, traffic, start, c: dict, seed: int, seconds: float, prof, label,
            calls: int | None = None):
    """The closed loop: call ``k`` hands ``step`` frame set ``k`` and the
    previous call's state and ends once y and sigma^2 are on the host;
    for ``seconds``, or ``calls`` calls where it is given."""
    w, keep_n, streams = Window(), int(c["check"]["calls"]), traffic.streams
    rng = np.random.default_rng([seed, 1])
    y_prev, s2_prev = start
    t_start = time.perf_counter()
    deadline = t_start + seconds
    while True:
        frame_set = traffic.frame_set(w.calls)
        t0 = time.perf_counter()
        with label(LABELS[0]):
            new_state, out = step(state, *frame_set)
        with label(LABELS[1]):
            y = out.y.cpu().numpy()
            s2 = out.sigma2.cpu().numpy()
        t1 = time.perf_counter()
        w.lat.append(t1 - t0)
        w.failed += int((~np.isfinite(y.reshape(streams, -1)).all(-1)).sum()
                        + (~np.isfinite(s2.reshape(streams))).sum())
        item = (w.calls, y_prev, s2_prev, out)
        if w.calls == 0:
            w.first = item
        elif len(w.kept) < keep_n:
            w.kept.append(item)
        else:  # a uniform sample of the calls after the first
            j = int(rng.integers(w.calls))
            if j < keep_n:
                w.kept[j] = item
        if prof is not None:
            w.traced.append(item)
        state, y_prev, s2_prev = new_state, y, s2
        w.calls += 1
        if (w.calls >= calls) if calls is not None else (t1 >= deadline):
            break
    w.window_s = t1 - t_start
    return w


def sample(w: Window, traffic, nodes, cfg: dict, c: dict, seed: int):
    """The reference's tasks and the program's answers of the checked
    stream-frames: the first call's and the kept calls', each with
    ``check.streams`` streams drawn from the seed."""
    streams = traffic.streams
    one = streams == 1
    per_call = min(int(c["check"]["streams"]), streams)
    tasks, got = [], []
    for k, y_in, s2_in, out in [w.first] + sorted(w.kept, key=lambda it: it[0]):
        pick = np.random.default_rng([seed, 2, k]).choice(streams, per_call, replace=False)
        for s in sorted(int(v) for v in pick):
            rgb, depth, keep = traffic.stream_frame(k, s)
            tasks.append(dict(y=y_in if one else y_in[s], sigma2=float(s2_in if one else s2_in[s]),
                              init=nodes[s], rgb=rgb, depth=depth, keep=keep,
                              tracker=cfg["tracker"], camera=cfg["camera"], control=False))
            got.append(answers(out, None if one else s))
    return tasks, got


def run(cell: dict, seed: int, seconds: float, trace: bool, device: str = "cuda",
        control: bool = False, wrap_step=None, calls: int | None = None) -> tuple[dict, list[str]]:
    """One run of ``cell`` (:func:`portbench.spec.cell`): (the result's
    fields, the lines that compare each number with its limit).
    ``control``: judge the TF32 reference in the program's place (the
    program's numbers go under ``numbers``). ``wrap_step``: a function of
    the step that returns the step to run. ``calls``: an untraced window of
    that many calls instead of ``seconds``."""
    import torch

    from trackdlo_tpu_torch import _build

    c, cfg = cell["cell"], cell["config_file"]
    params, intr = program_params(cfg)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.set_num_threads(int(c["host_threads"]))
        _build.lib()
    traffic = Traffic(cell["traffic_file"], Camera(**cfg["camera"]), params.num_of_nodes, seed)
    streams = traffic.streams
    init, step = spec.entry(c["entry"]).build(params, intr, c, streams, dev)
    if wrap_step is not None:
        step = wrap_step(step)
    nodes = [traffic.init_nodes(s).astype(np.float32) for s in range(streams)]
    start = (nodes[0], np.float32(params.sigma2_init)) if streams == 1 else \
        (np.stack(nodes), np.full(streams, params.sigma2_init, np.float32))

    # Set-up: the graph's capture at the first call, then replays. The
    # window keeps the outputs of the calls it checks (of every call, traced),
    # so the set-up keeps as many, and the allocator holds their memory before
    # the window opens (no cudaMalloc inside it).
    held = int(c["trace_calls"]) if trace else int(c["check"]["calls"]) + 1
    state, outs = init(nodes), []
    for k in range(int(c["warmup_calls"]) + held):
        state, out = step(state, *traffic.frame_set(k))
        out.y.cpu()
        outs.append(out)
    del state, out, outs
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - _T0

    prof, label, plain_s = None, (lambda name: contextlib.nullcontext()), None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        # The same calls untraced first: the host seconds that the device's
        # busy time is set against, without the profiler's own time.
        calls = int(c["trace_calls"])
        plain_s = measure(step, init(nodes), traffic, start, c, seed, 0, None, label,
                          calls).window_s
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        prof, label = profile(activities=acts), record_function
    _build.settle_counts()
    counts0 = dict(_build.launch_counts)  # the port's launches in the window alone
    faults0 = page_faults()
    with prof if trace else contextlib.nullcontext():
        w = measure(step, init(nodes), traffic, start, c, seed, seconds, prof, label, calls)
    faults = [b - a for a, b in zip(faults0, page_faults())]
    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": int(cell.get("chips", 1)),
                   "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))
                   if dev.type == "cuda" else 0}
    _build.settle_counts()
    counts = {name: v - counts0.get(name, 0) for name, v in _build.launch_counts.items()}
    loaded = forbidden_modules()
    if loaded:
        raise RuntimeError(f"JAX or the JAX package is loaded: {loaded}")

    # The reference on the sample, once the window has closed.
    t_check = time.perf_counter()
    tasks, got = sample(w, traffic, nodes, cfg, c, seed)
    ctx = None
    if trace:
        ctx = Context(trace=Trace.from_profile(prof, counts), calls=w.calls, streams=streams,
                      window_s=w.window_s, plain_s=plain_s, cohort=int(c.get("cohort") or streams),
                      frames=frame_records(w.traced, streams, params.prune_radius),
                      height=intr.height, width=intr.width, cell_px=_cell_px(params, intr),
                      mode=_mode(params))
    del w.first, w.kept, w.traced, step
    refs = check.run_reference(tasks + [dict(t, control=True) for t in tasks if control])
    leaf = params.downsample_leaf_size
    frame_limits = c["check"]["frame_limits"]
    numbers = check.summary([check.judge(g, r, leaf) for g, r in zip(got, refs)], frame_limits)
    correct, rows = check.verdict(numbers, c["limits"])
    if control:  # the control judged in the program's place
        ctl = check.summary([check.judge(g, r, leaf) for g, r in zip(refs[len(tasks):], refs)],
                            frame_limits)
        program_rows = rows
        correct, rows = check.verdict(ctl, c["limits"])
    check_s = time.perf_counter() - t_check

    units = {m["name"]: m["unit"] for m in cell["end_to_end"] + cell["per_layer"]}
    if trace:
        values = {m["name"]: spec.reader(m["name"])(ctx) for m in cell["per_layer"]}
        device_info.update(busy_s=ctx.trace.busy_us() / 1e6, window_s=w.window_s)
    else:
        values = {"stream_frames_per_s": w.calls * streams / w.window_s,
                  "frame_ms_p50": 1e3 * statistics.median(w.lat),
                  "frame_ms_p95": 1e3 * float(np.percentile(w.lat, 95)), "setup_s": setup_s}
        values = {m["name"]: values[m["name"]] for m in cell["end_to_end"]}
    result = {"correct": bool(correct), "attempted": w.calls * streams, "failed": w.failed,
              "metrics": {k: {"value": float(v), "unit": units[k]}
                          for k, v in values.items() if v is not None},
              "device": device_info}
    if trace:
        result["breakdown"] = {"device_ops": ctx.trace.top_device_ops(),
                               "idle_gaps": ctx.trace.idle_gaps()}
    lines = [f"portbench: {cell['name']} seed {seed}: {w.calls} calls x {streams} streams in "
             f"{w.window_s:.3f} s; set-up {setup_s:.3f} s; page faults in the window {faults[0]} "
             f"minor, {faults[1]} major; checked {len(tasks)} stream-frames in {check_s:.1f} s"]
    if trace:
        lines.append(f"portbench: the same calls untraced took {plain_s:.4f} s, traced "
                     f"{w.window_s:.4f} s: the profiler's share {1 - plain_s / w.window_s:.4f}")
    lines += [f"reading {k} {_num(v)!r}" for k, v in numbers.items() if k not in rows]
    if control:
        result["numbers"] = {k: _num(v) for k, v in numbers.items()}
        result["control_numbers"] = {k: _num(v) for k, v in ctl.items()}
        lines += [f"program {k} {_num(v['value'])!r} limit {v['limit']!r}"
                  for k, v in program_rows.items()]
    result["checks"] = {k: {"value": _num(v["value"]), "limit": v["limit"]} for k, v in rows.items()}
    lines += [f"check {k} {_num(v['value'])!r} limit {v['limit']!r} "
              f"{'ok' if v['value'] <= v['limit'] else 'FAIL'}" for k, v in rows.items()]
    return result, lines


def _num(v):
    """A number for JSON: infinity as a string."""
    return v if math.isfinite(v) else str(v)


def _cell_px(params, intr) -> int:
    from trackdlo_tpu_torch.ops.preprocess import default_cell_px

    return params.downsample_cell_px or default_cell_px(params.downsample_leaf_size, intr.fx)


def _mode(params) -> str:
    if not params.exact_voxels:
        return "cells"
    return "parity" if params.parity_split else "votes"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs()
    cell = spec.cell(args.workload)
    try:
        import torch

        import trackdlo_tpu_torch  # noqa: F401  the program under test
    except ImportError as err:
        print(f"portbench: cannot import the program: {err}", file=sys.stderr)
        return 2

    want = int(cell.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < want:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {want} CUDA device(s), found {have}",
              file=sys.stderr)
        return 2
    result, lines = run(cell, args.seed, args.seconds, bool(args.trace))
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
