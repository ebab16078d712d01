"""What a per-layer metric reads (``metrics/<name>.py``: ``read(ctx)``).

A reader returns one number, or None where it finds nothing to read (a
kernel the cell does not run, or one whose trace count differs from the
port's launch counters); the harness then leaves the metric out of the
line. It never returns 0 for a share of a roofline.
"""

from __future__ import annotations

import dataclasses

from portbench import roofline
from portbench.trace import Trace


@dataclasses.dataclass
class Context:
    """The traced window of one run.

    - ``trace``: its :class:`~portbench.trace.Trace` (device and host
      events, the launch counters' change over the same calls);
    - ``calls``, ``streams``, ``window_s``: calls made, streams a call, the
      traced window's host seconds;
    - ``plain_s``: the host seconds of the same calls untraced, just before
      (None where the run made none);
    - ``cohort``: streams a lockstep cohort (``streams`` where the cell runs
      the batch as one cohort; 1 for one stream);
    - ``frames``: one record a stream-frame, from the step's outputs and its
      input state: ``iterations``, ``guide_iterations`` (the EM passes'
      trips), ``guide_count`` (nodes of the pre-registration pass),
      ``nodes``, ``n_points`` (the cloud's valid points), ``rows`` (the
      cloud's rows), ``in_reach_pre`` and ``in_reach_main`` (valid points
      within the prune radius of the pass's input nodes);
    - ``height``, ``width``, ``cell_px``, ``mode``: kernel P's frame shape,
      cell size and mode (``"parity"``, ``"votes"`` or ``"cells"``).
    """

    trace: Trace
    calls: int
    streams: int
    window_s: float
    plain_s: float | None
    cohort: int
    frames: list
    height: int
    width: int
    cell_px: int
    mode: str
    roofline = roofline

    def per_call_ms(self, kernels: tuple):
        """Summed device ms per call of the port kernels named, or None
        where one of them is not counted whole by the trace or none ran."""
        total_us, launches = 0.0, 0
        for k in kernels:
            got = self.trace.kernel_us(k)
            if got is None:
                return None
            launches += got[0]
            total_us += got[1]
        if launches == 0:
            return None
        return total_us / 1e3 / self.calls
