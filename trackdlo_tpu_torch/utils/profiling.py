"""Per-phase timing and profiler integration.

Counterpart of trackdlo_tpu/utils/profiling.py. Reference: hand-rolled
std::chrono timers around pre-processing / tracking / publish with running
averages (trackdlo_node.cpp:83-86, 249-252, 371-375, 518-528). Here: a
PhaseTimers helper emitting the same three-phase report, the per-frame log
line, and a ``torch.profiler`` trace context (the card's kernels and copies
beside the host's ops) in place of the JAX package's ``jax.profiler`` one.
"""

from __future__ import annotations

import contextlib
import logging
import os
import tempfile
import time
from collections import defaultdict

import torch

logger = logging.getLogger("trackdlo_tpu_torch")


class PhaseTimers:
    """Accumulates wall time per named phase with running averages."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = (time.perf_counter() - t0) * 1000.0
            self.totals[name] += dt
            self.counts[name] += 1
            logger.debug("%s: %.3f ms", name, dt)

    def averages(self) -> dict[str, float]:
        return {k: self.totals[k] / self.counts[k] for k in self.totals}

    def report(self) -> str:
        # Mirrors the reference's "Avg ..." log block (trackdlo_node.cpp:525-528).
        lines = [f"Avg {k}: {v:.3f} ms" for k, v in self.averages().items()]
        total = sum(self.averages().values())
        lines.append(f"Avg total: {total:.3f} ms")
        return "\n".join(lines)


@contextlib.contextmanager
def trace_step(log_dir: str | None = None):
    """A ``torch.profiler`` trace around a block, written when the block
    ends into ``log_dir`` (default: ``trackdlo_tpu_torch_trace`` in the
    temporary directory) as a TensorBoard profile (``*.pt.trace.json``, a
    Chrome trace), the form ``jax.profiler.trace`` wrote for the JAX
    package. Records the card's activity (kernels, copies, graph replays)
    where CUDA is available, the host's ops always. Yields ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "trackdlo_tpu_torch_trace")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield log_dir


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
