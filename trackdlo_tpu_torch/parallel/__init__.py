"""Multi-stream tracking: batched streams on one card and the (data × model)
mesh over ``torch.distributed`` ranks (see :mod:`.sharding`, :mod:`.launch`)."""

from trackdlo_tpu_torch.parallel.sharding import (
    build_batched_step_fn,
    build_parallel_step_fn,
    make_tracking_mesh,
    replicate_state,
)

__all__ = ["build_batched_step_fn", "build_parallel_step_fn", "make_tracking_mesh", "replicate_state"]
