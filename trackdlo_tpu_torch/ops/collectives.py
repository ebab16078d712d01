"""The EM's reductions over a point-sharded axis.

Counterpart of the JAX package's ``jax.lax.psum``/``pmin``/``axis_index``
over a mesh axis: here the axis is a ``torch.distributed`` process group,
one process per rank. ``group=None`` means no axis: the reductions are the
identity and the shard is the whole cloud.

Every rank of a group receives the same reduced bits (an all-reduce hands
each rank one result), so replicated values computed from them stay
bit-equal across ranks.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _all_reduce(t: torch.Tensor, op, group) -> torch.Tensor:
    if group is None:
        return t
    t = t.contiguous()
    dist.all_reduce(t, op=op, group=group)
    return t


def psum(t: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``t`` over the ranks of ``group``, reduced in place on a
    contiguous tensor (a copy if ``t`` is not contiguous)."""
    return _all_reduce(t, dist.ReduceOp.SUM, group)


def pmin(t: torch.Tensor, group) -> torch.Tensor:
    """Elementwise minimum of ``t`` over the ranks of ``group``, in place as
    :func:`psum`."""
    return _all_reduce(t, dist.ReduceOp.MIN, group)


def shard_slice(n: int, group) -> slice:
    """This rank's contiguous slice of an axis of length ``n`` split evenly
    over ``group`` (rank r takes [r·n/size, (r+1)·n/size)); the whole axis
    without a group. Raises unless the size divides ``n``."""
    if group is None:
        return slice(0, n)
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    if n % size:
        raise ValueError(f"{n} points not divisible by the {size} ranks of the point axis")
    chunk = n // size
    return slice(rank * chunk, (rank + 1) * chunk)
