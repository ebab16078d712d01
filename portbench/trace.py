"""The reduction of a ``torch.profiler`` trace of the traced window.

Device events are kernels, copies and sets on the card; host events are
the CPU-side ops and CUDA runtime calls. A port kernel is known by its
function's name (``void em_loop_kernel<...>(EmArgs)`` -> ``em_loop_kernel``);
its trace count is held against the port's own launch counters before any
metric reads its device time (:meth:`Trace.kernel_us`), since the trace
loses kernels (those inside a CUDA graph's conditional nodes).
"""

from __future__ import annotations

import re

# The port's kernels: (function names in the trace, launch counters of
# trackdlo_tpu_torch._build that count them).
KERNELS = {
    "P": (("cell_sums_kernel",), ("cell_sums", "cell_sums_votes", "cell_sums_cells")),
    "C": (("compact_kernel",), ("compact",)),
    "V": (("visibility_kernel", "visibility_ub_kernel"), ("visibility",)),
    "W": (("walks_kernel", "walks_ub_kernel"), ("walks",)),
    "E": (("em_loop_kernel", "em_loop_ub_kernel"), ("em_loop",)),
    "S": (("estep_kernel", "estep_ub_kernel"), ("estep", "estep_batch")),
    "G": (("gj_solve_kernel", "gj_solve_ub_kernel"), ("gj_solve",)),
    "F": (("em_iter_kernel", "em_iter_ub_kernel"), ("em_iteration",)),
    "N": (("nearest_kernel", "nearest_ub_kernel"), ("nearest",)),
    "L": (("loop_flag_kernel",), ("loop_flag",)),
}
# The harness's own labels of a call's host phases (record_function).
LABELS = ("portbench.step", "portbench.readback")
# Host runtime calls that hand the card work: launches, copies, sets.
RUNTIME_CALLS = re.compile(r"^cu(da)?(LaunchKernel|GraphLaunch|Memcpy|Memset|LaunchCooperative)")


def base_name(name: str) -> str:
    """A kernel's function name without its return type, template
    arguments and parameter list."""
    name = name.strip().replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return re.split(r"[<(]", name, maxsplit=1)[0].split("::")[-1].strip()


class Trace:
    """A traced window: ``device`` and ``host`` as (name, start_us, end_us)
    lists on the profiler's clock, and the launch counters' change over the
    same calls (``counts``)."""

    def __init__(self, device: list, host: list, counts: dict):
        self.device = sorted(device, key=lambda e: e[1])
        self.host = host
        self.counts = counts

    @classmethod
    def from_profile(cls, prof, counts: dict) -> "Trace":
        import torch

        device, host = [], []
        for e in prof.events():
            row = (e.name, float(e.time_range.start), float(e.time_range.end))
            if e.device_type != torch.autograd.DeviceType.CUDA:
                host.append(row)
            elif not getattr(e, "is_user_annotation", False) and e.name not in LABELS:
                device.append(row)  # a host label's span on the device timeline is no work
        return cls(device, host, counts)

    # -- kernels -------------------------------------------------------------
    def kernel_events(self, kernel: str) -> list:
        names = KERNELS[kernel][0]
        return [e for e in self.device if base_name(e[0]) in names]

    def counted(self, kernel: str) -> int:
        return sum(self.counts.get(c, 0) for c in KERNELS[kernel][1])

    def kernel_matches(self, kernel: str) -> bool:
        """Whether the trace holds every launch the port counted."""
        return len(self.kernel_events(kernel)) == self.counted(kernel)

    def kernel_us(self, kernel: str):
        """(launches, summed device µs) of a port kernel, or None where the
        trace's count differs from the port's counters."""
        if not self.kernel_matches(kernel):
            return None
        ev = self.kernel_events(kernel)
        return len(ev), sum(e[2] - e[1] for e in ev)

    def all_kernels_match(self) -> bool:
        return all(self.kernel_matches(k) for k in KERNELS)

    # -- the device ----------------------------------------------------------
    def busy_us(self) -> float:
        """Length of the union of the device events' intervals."""
        total, cur_s, cur_e = 0.0, None, None
        for _, s, e in self.device:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    total += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            total += cur_e - cur_s
        return total

    def gaps(self) -> list:
        """The device's idle intervals (start_us, end_us) between its first
        and last event."""
        out, cur_e = [], None
        for _, s, e in self.device:
            if cur_e is not None and s > cur_e:
                out.append((cur_e, s))
            cur_e = e if cur_e is None else max(cur_e, e)
        return out

    def runtime_calls(self) -> int:
        return sum(1 for name, _, _ in self.host if RUNTIME_CALLS.match(name))

    # -- breakdown -----------------------------------------------------------
    def top_device_ops(self, n: int = 10) -> list:
        """[name, seconds] of the device ops with the most summed time."""
        tot: dict = {}
        for name, s, e in self.device:
            tot[name] = tot.get(name, 0.0) + (e - s)
        rows = sorted(tot.items(), key=lambda kv: kv[1], reverse=True)[:n]
        return [[name[:120], us / 1e6] for name, us in rows]

    def idle_gaps(self, n: int = 10) -> list:
        """[what the host was doing, seconds] of the longest idle gaps: the
        shortest host event that spans the gap's middle."""
        rows = []
        for s, e in sorted(self.gaps(), key=lambda g: g[1] - g[0], reverse=True)[:n]:
            mid = (s + e) / 2
            around = [h for h in self.host if h[1] <= mid <= h[2]]
            what = min(around, key=lambda h: h[2] - h[1])[0] if around else "host idle"
            rows.append([what[:120], (e - s) / 1e6])
        return rows
