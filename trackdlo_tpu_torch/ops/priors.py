"""Correspondence priors: occlusion-case dispatch and the four prior walks.

Counterpart of trackdlo_tpu/ops/priors.py. The four pure-pursuit walks
(head, tail, both-ends forward, both-ends backward) share one walk-space
formulation (reversed walks run on index-flipped arrays) and go through
kernel W together (:func:`trackdlo_tpu_torch.ops.hopper_kernels.pursuit_walks`);
the five-way dispatch is a set of masked merges.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from trackdlo_tpu_torch.ops.hopper_kernels import pursuit_walks, pursuit_walks_plain

# Occlusion states, shared codes with trackdlo_tpu.ops.priors and the oracle.
ALL_VISIBLE = 0
MID_SECTION_OCCLUDED = 1
TAIL_OCCLUDED = 2
HEAD_OCCLUDED = 3
BOTH_ENDS_OCCLUDED = 4
# No extended-visible node: a state with no priors at all.
NO_VISIBLE_NODES = 5

_EPS_BETWEEN = 1e-4  # isBetween slack of the segment/sphere test


class WalkResult(NamedTuple):
    pos: torch.Tensor  # (M, 3) indexed by walk-space node position
    valid: torch.Tensor  # (M,)


class PriorResult(NamedTuple):
    prior_pos: torch.Tensor  # (M, 3)
    prior_mask: torch.Tensor  # (M,)
    state: torch.Tensor  # occlusion-state code
    alignment_idx: torch.Tensor


def pursuit_walk(guide_w, seg_len_w, start_guide, seg_hi, outer_hi, start_node_pos, guide_count) -> WalkResult:
    """One generic pure-pursuit walk in walk space (the plain version, as a
    batch of one)."""
    ints = torch.stack([start_guide, seg_hi, outer_hi, start_node_pos, guide_count]).to(torch.int64)
    pos, valid = pursuit_walks_plain(guide_w[None], seg_len_w[None], ints[None], _EPS_BETWEEN)
    return WalkResult(pos=pos[0], valid=valid[0])


def _prefix_run(flags: torch.Tensor) -> torch.Tensor:
    """Length of the True-prefix of ``flags``."""
    return torch.cumprod(flags.to(torch.int64), dim=0).sum()


class WalkInputs(NamedTuple):
    guides: torch.Tensor  # (4, M, 3) walk-space guide polylines
    seglens: torch.Tensor  # (4, M-1) look-ahead per node position
    ints: torch.Tensor  # (4, 5) int32: start_guide, seg_hi, outer_hi, start_node, count
    state: torch.Tensor
    alignment_idx: torch.Tensor


def walk_inputs(y, geodesic_coord, guide_nodes, vis_ext_idx, vis_ext_count,
                vis_idx, vis_count) -> WalkInputs:
    """Occlusion state and the four walks' inputs: head, tail (reversed
    space), both-ends forward, both-ends backward (reversed space; its inner
    scan may use every segment down to guide row 0)."""
    m = y.shape[0]
    dev = y.device
    iota = torch.arange(m, device=dev)
    v = vis_ext_count

    first_ext = vis_ext_idx[0]
    last_ext = vis_ext_idx[(v - 1).clamp(0, m - 1)]
    head_vis = first_ext == 0
    tail_vis = last_ext == m - 1
    state = torch.where(
        v == m, ALL_VISIBLE,
        torch.where(head_vis & tail_vis, MID_SECTION_OCCLUDED,
                    torch.where(head_vis, TAIL_OCCLUDED,
                                torch.where(tail_vis, HEAD_OCCLUDED, BOTH_ENDS_OCCLUDED))),
    )
    state = torch.where(v == 0, NO_VISIBLE_NODES, state)

    in_prefix = iota < v
    consec_head = _prefix_run((vis_ext_idx == iota) & in_prefix)
    rev_pos = (v - 1 - iota).clamp(0, m - 1)
    consec_tail = _prefix_run((vis_ext_idx[rev_pos] == m - 1 - iota) & in_prefix)

    # Least-moved visible node; guide rows are indexed by raw-visible
    # positions, as the reference does.
    d = y[vis_idx] - guide_nodes
    moved = torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2])
    moved = torch.where(iota < vis_count, moved, torch.inf)
    align_idx = torch.argmin(moved)

    ext_diff_ok = torch.diff(vis_ext_idx) == 1
    k = iota[:-1]
    fwd_flags = ext_diff_ok[(align_idx + k).clamp(0, m - 2)] & (align_idx + k < v - 1)
    consec_fwd = 1 + _prefix_run(fwd_flags)
    bwd_flags = ext_diff_ok[(align_idx - 1 - k).clamp(0, m - 2)] & (align_idx - 1 - k >= 0)
    consec_bwd = 1 + _prefix_run(bwd_flags)

    seg_len_fwd = torch.abs(torch.diff(geodesic_coord))
    seg_len_rev = torch.flip(seg_len_fwd, [0])
    guide_rev = guide_nodes[(v - 1 - iota).clamp(0, m - 1)]

    zero = torch.zeros((), dtype=torch.int64, device=dev)
    start_node = vis_ext_idx[align_idx.clamp(0, m - 1)]
    start_guide_rev = (v - 1 - align_idx).clamp(0, m - 1)
    walk_guides = torch.stack([guide_nodes, guide_rev, guide_nodes, guide_rev])
    walk_seglens = torch.stack([seg_len_fwd, seg_len_rev, seg_len_fwd, seg_len_rev])
    ints = torch.stack([
        torch.stack([zero, consec_head - 2, consec_head - 2, zero, v]),
        torch.stack([zero, consec_tail - 2, consec_tail - 2, zero, v]),
        torch.stack([align_idx, align_idx + consec_fwd - 2, align_idx + consec_fwd - 2, start_node, v]),
        torch.stack([start_guide_rev, zero + (m - 2), start_guide_rev + consec_bwd - 1, m - 1 - start_node, v]),
    ]).to(torch.int32)
    return WalkInputs(
        walk_guides.contiguous(), walk_seglens.contiguous(), ints.contiguous(), state, align_idx
    )


def correspondence_priors(
    y: torch.Tensor,
    geodesic_coord: torch.Tensor,
    guide_nodes: torch.Tensor,
    vis_ext_idx: torch.Tensor,
    vis_ext_count: torch.Tensor,
    vis_idx: torch.Tensor,
    vis_count: torch.Tensor,
) -> PriorResult:
    """Occlusion dispatch + prior walks.

    ``guide_nodes`` (M, 3) pre-registered guides, prefix-packed in
    extended-visible order; ``vis_ext_idx``/``vis_ext_count`` the packed
    extended-visible indices; ``vis_idx``/``vis_count`` the packed raw
    visible indices (used only by the least-moved-node anchor)."""
    wi = walk_inputs(y, geodesic_coord, guide_nodes, vis_ext_idx, vis_ext_count, vis_idx, vis_count)
    state, v = wi.state, vis_ext_count
    pos4, valid4 = pursuit_walks(wi.guides, wi.seglens, wi.ints, _EPS_BETWEEN)
    head = WalkResult(pos4[0], valid4[0])
    tail = WalkResult(torch.flip(pos4[1], [0]), torch.flip(valid4[1], [0]))
    fwd = WalkResult(pos4[2], valid4[2])
    bwd = WalkResult(torch.flip(pos4[3], [0]), torch.flip(valid4[3], [0]))

    both_hv = head.valid & tail.valid
    avg_pos = torch.where(
        both_hv[:, None], (head.pos + tail.pos) / 2.0,
        torch.where(head.valid[:, None], head.pos, tail.pos),
    )
    avg_valid = head.valid | tail.valid
    mid_pos = torch.where(tail.valid[:, None], tail.pos, head.pos)
    both_pos = torch.where(bwd.valid[:, None], bwd.pos, fwd.pos)
    both_valid = fwd.valid | bwd.valid

    def pick(all_v, mid_v, tail_occ_v, head_occ_v, both_v):
        return torch.where(
            state == ALL_VISIBLE, all_v,
            torch.where(state == MID_SECTION_OCCLUDED, mid_v,
                        torch.where(state == TAIL_OCCLUDED, tail_occ_v,
                                    torch.where(state == HEAD_OCCLUDED, head_occ_v, both_v))),
        )

    prior_pos = pick(avg_pos, mid_pos, head.pos, tail.pos, both_pos)
    prior_mask = pick(avg_valid, avg_valid, head.valid, tail.valid, both_valid) & (v > 0)
    return PriorResult(prior_pos=prior_pos, prior_mask=prior_mask, state=state, alignment_idx=wi.alignment_idx)
