"""Multi-stream tracking on one card (see :mod:`.sharding`)."""

from trackdlo_tpu_torch.parallel.sharding import (
    build_batched_step_fn,
    build_parallel_step_fn,
    make_tracking_mesh,
    replicate_state,
)

__all__ = ["build_batched_step_fn", "build_parallel_step_fn", "make_tracking_mesh", "replicate_state"]
