"""NumPy oracle: a behavioural re-implementation of the reference C++ tracker.

This subpackage bit-follows the reference (the reference checkout's trackdlo/src/*.cpp)
in plain float64 NumPy — including its quirks where they are well-defined (see
individual docstrings). It is **not** the TPU compute path; it exists as the
parity target for the JAX/Pallas implementation in :mod:`trackdlo_tpu.ops` and
as an executable specification, mirroring the role the reference's own NumPy
prototype (utils/tracking_test.py) played for its C++ node.

Nothing here is performance-relevant; everything is written for auditability.
"""

from trackdlo_tpu_torch.oracle.geometry import (
    line_sphere_intersection,
    pt2pt_dis,
    pt2pt_dis_sq,
    sort_pts,
)
from trackdlo_tpu_torch.oracle.lle import calc_lle_weights
from trackdlo_tpu_torch.oracle.cpd_lle import cpd_lle, register_cold_start
from trackdlo_tpu_torch.oracle.traverse import traverse_euclidean
from trackdlo_tpu_torch.oracle.tracking import tracking_step

__all__ = [
    "pt2pt_dis",
    "pt2pt_dis_sq",
    "sort_pts",
    "line_sphere_intersection",
    "calc_lle_weights",
    "cpd_lle",
    "register_cold_start",
    "traverse_euclidean",
    "tracking_step",
]
