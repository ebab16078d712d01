"""Correspondence-prior generation: the pure-pursuit guide-node walk.

Reference: trackdlo::traverse_euclidean (trackdlo.cpp:584-898) and the older
traverse_geodesic (trackdlo.cpp:444-582). Given the pre-registered guide nodes
(the visible subset), walk along their polyline placing one node per geodesic
segment length using segment/sphere intersections, producing (index, x, y, z)
prior rows consumed by the main EM's J / Y_extended terms.
"""

from __future__ import annotations

import numpy as np

from portbench.reference.geometry import line_sphere_intersection, pt2pt_dis


def _pursuit_step(
    guide_nodes: np.ndarray,
    cur_center: np.ndarray,
    look_ahead: float,
    seg_indices: list[tuple[int, int]],
) -> tuple[bool, int, np.ndarray]:
    """One pure-pursuit advance: scan candidate guide segments in order and
    return the first acceptable sphere intersection (trackdlo.cpp:623-655).

    ``seg_indices`` is the ordered list of (i, j) guide segment endpoint pairs
    to scan; returns (found, position_of_accepted_segment, intersection).
    """
    for pos, (i, j) in enumerate(seg_indices):
        inters = line_sphere_intersection(
            guide_nodes[i], guide_nodes[j], cur_center, look_ahead
        )
        if len(inters) == 0:
            continue
        if len(inters) == 1 and pt2pt_dis(inters[0], guide_nodes[j]) > pt2pt_dis(
            cur_center, guide_nodes[j]
        ):
            # A single backwards intersection — skip (trackdlo.cpp:630-632).
            continue
        if len(inters) == 2:
            if pt2pt_dis(inters[0], guide_nodes[j]) <= pt2pt_dis(inters[1], guide_nodes[j]):
                chosen = inters[0]
            else:
                chosen = inters[1]
        else:
            chosen = inters[0]
        return True, pos, np.asarray(chosen)
    return False, -1, cur_center


def traverse_geodesic(
    geodesic_coord: np.ndarray,
    guide_nodes: np.ndarray,
    visible_nodes: list[int],
    alignment: int,
) -> np.ndarray:
    """Older cumulative-segment-distance prior generator
    (trackdlo.cpp:444-582; still compiled in the reference but only invoked
    from commented-out call sites at trackdlo.cpp:963-978 — kept as part of
    the algorithm surface).

    Walks guide segments accumulating their chord length and places a node
    whenever the accumulated rest arc length catches up, interpolating
    linearly inside the current guide segment.
    """
    geodesic_coord = np.asarray(geodesic_coord, dtype=float)
    guide_nodes = np.asarray(guide_nodes, dtype=float)
    n_guide = len(guide_nodes)

    def pair(idx, pos):
        return np.array([float(idx), pos[0], pos[1], pos[2]])

    if n_guide == 1:
        return np.array([pair(visible_nodes[0], guide_nodes[0])])

    pairs: list[np.ndarray] = []
    guide_total = 0.0
    seg_total = 0.0

    if alignment == 0:
        pairs.append(pair(visible_nodes[0], guide_nodes[0]))
        g_it = 0
        s_it = 0
        last_s_it = s_it
        while (
            g_it + 1 <= n_guide - 1
            and visible_nodes[g_it + 1] - visible_nodes[g_it] == 1
            and s_it + 1 <= len(geodesic_coord) - 1
        ):
            guide_total += pt2pt_dis(guide_nodes[g_it], guide_nodes[g_it + 1])
            while guide_total > seg_total:
                if s_it == len(geodesic_coord) - 1:
                    break
                step = abs(geodesic_coord[s_it] - geodesic_coord[s_it + 1])
                seg_total += step
                if seg_total <= guide_total:
                    s_it += 1
                else:
                    seg_total -= step
                    break
            if s_it == len(geodesic_coord) - 1:
                break
            if g_it == 0 and s_it == 0:
                continue
            if last_s_it == s_it:
                g_it += 1
                continue
            seg_len = pt2pt_dis(guide_nodes[g_it], guide_nodes[g_it + 1])
            remaining = seg_total - (guide_total - seg_len)
            offset = (guide_nodes[g_it + 1] - guide_nodes[g_it]) * remaining / seg_len
            pairs.append(pair(s_it, guide_nodes[g_it] + offset))
            g_it += 1
            last_s_it = s_it
    else:
        pairs.append(pair(visible_nodes[-1], guide_nodes[-1]))
        g_it = n_guide - 1
        s_it = len(geodesic_coord) - 1
        last_s_it = s_it
        while (
            g_it - 1 >= 0
            and visible_nodes[g_it] - visible_nodes[g_it - 1] == 1
            and s_it - 1 >= 0
        ):
            guide_total += pt2pt_dis(guide_nodes[g_it], guide_nodes[g_it - 1])
            while guide_total > seg_total:
                if s_it == 0:
                    break
                step = abs(geodesic_coord[s_it] - geodesic_coord[s_it - 1])
                seg_total += step
                if seg_total <= guide_total:
                    s_it -= 1
                else:
                    seg_total -= step
                    break
            if s_it == 0:
                break
            if last_s_it == s_it:
                g_it -= 1
                continue
            seg_len = pt2pt_dis(guide_nodes[g_it], guide_nodes[g_it - 1])
            remaining = seg_total - (guide_total - seg_len)
            offset = (guide_nodes[g_it - 1] - guide_nodes[g_it]) * remaining / seg_len
            pairs.insert(0, pair(s_it, guide_nodes[g_it] + offset))
            g_it -= 1
            last_s_it = s_it

    return np.array(pairs)


def traverse_euclidean(
    geodesic_coord: np.ndarray,
    guide_nodes: np.ndarray,
    visible_nodes: list[int],
    alignment: int,
    alignment_node_idx: int = 0,
) -> np.ndarray:
    """Pure-pursuit walk along the guide polyline (trackdlo.cpp:584-898).

    alignment 0: anchored at the head; 1: anchored at the tail; 2: anchored at
    ``alignment_node_idx`` and walked both ways (the both-ends-occluded case,
    trackdlo.cpp:749-895).

    Returns a (P, 4) array of (node_index, x, y, z) rows. The reference's
    backwards consecutive-run count in the alignment-2 head-direction walk
    reads out of bounds (`i++` in a decreasing loop, trackdlo.cpp:828); here
    the intended backward run count is used instead (documented deviation,
    SURVEY.md §5).
    """
    geodesic_coord = np.asarray(geodesic_coord, dtype=float)
    guide_nodes = np.asarray(guide_nodes, dtype=float)
    m_total = len(geodesic_coord)
    n_guide = len(guide_nodes)
    pairs: list[np.ndarray] = []

    def pair(idx: int, pos: np.ndarray) -> np.ndarray:
        return np.array([float(idx), pos[0], pos[1], pos[2]])

    if n_guide == 1:
        return np.array([pair(visible_nodes[0], guide_nodes[0])])

    if alignment == 0:
        pairs.append(pair(visible_nodes[0], guide_nodes[0]))

        # Prefix run where position == node index (trackdlo.cpp:603-611).
        consecutive = 0
        for i in range(len(visible_nodes)):
            if i == visible_nodes[i]:
                consecutive += 1
            else:
                break

        last_found = 0
        seg_it = 0
        cur_center = guide_nodes[0].copy()
        while last_found + 1 <= consecutive - 1 and seg_it + 1 <= m_total - 1:
            look_ahead = abs(geodesic_coord[seg_it + 1] - geodesic_coord[seg_it])
            segs = [(i, i + 1) for i in range(last_found, consecutive - 1)]
            found, pos, inter = _pursuit_step(guide_nodes, cur_center, look_ahead, segs)
            if not found:
                break
            last_found = last_found + pos
            cur_center = inter
            pairs.append(pair(seg_it + 1, inter))
            seg_it += 1

    elif alignment == 1:
        pairs.append(pair(visible_nodes[-1], guide_nodes[-1]))

        # Suffix run anchored at the tail (trackdlo.cpp:678-686).
        consecutive = 0
        for i in range(1, len(visible_nodes) + 1):
            if visible_nodes[len(visible_nodes) - i] == m_total - i:
                consecutive += 1
            else:
                break

        last_found = n_guide - 1
        seg_it = m_total - 1
        cur_center = guide_nodes[-1].copy()
        while last_found - 1 >= n_guide - consecutive and seg_it - 1 >= 0:
            look_ahead = abs(geodesic_coord[seg_it] - geodesic_coord[seg_it - 1])
            segs = [(i, i - 1) for i in range(last_found, n_guide - consecutive, -1)]
            found, pos, inter = _pursuit_step(guide_nodes, cur_center, look_ahead, segs)
            if not found:
                break
            last_found = last_found - pos
            cur_center = inter
            pairs.append(pair(seg_it - 1, inter))
            seg_it -= 1

    else:
        pairs.append(pair(visible_nodes[alignment_node_idx], guide_nodes[alignment_node_idx]))

        # Forward run from the alignment node (trackdlo.cpp:755-763).
        consec_fwd = 1
        for i in range(alignment_node_idx + 1, len(visible_nodes)):
            if visible_nodes[i] - visible_nodes[i - 1] == 1:
                consec_fwd += 1
            else:
                break

        last_found = alignment_node_idx
        seg_it = visible_nodes[alignment_node_idx]
        cur_center = guide_nodes[alignment_node_idx].copy()
        while (
            last_found + 1 <= alignment_node_idx + consec_fwd - 1
            and seg_it + 1 <= m_total - 1
        ):
            look_ahead = abs(geodesic_coord[seg_it + 1] - geodesic_coord[seg_it])
            segs = [
                (i, i + 1)
                for i in range(last_found, alignment_node_idx + consec_fwd - 1)
            ]
            found, pos, inter = _pursuit_step(guide_nodes, cur_center, look_ahead, segs)
            if not found:
                break
            last_found = last_found + pos
            cur_center = inter
            pairs.append(pair(seg_it + 1, inter))
            seg_it += 1

        # Backward run (intended semantics of trackdlo.cpp:826-835).
        consec_bwd = 1
        for i in range(alignment_node_idx - 1, -1, -1):
            if visible_nodes[i + 1] - visible_nodes[i] == 1:
                consec_bwd += 1
            else:
                break

        last_found = alignment_node_idx
        seg_it = visible_nodes[alignment_node_idx]
        cur_center = guide_nodes[alignment_node_idx].copy()
        while last_found - 1 >= alignment_node_idx - consec_bwd and seg_it - 1 >= 0:
            look_ahead = abs(geodesic_coord[seg_it] - geodesic_coord[seg_it - 1])
            # Inner scan runs all the way to guide node 0 regardless of the
            # run bound (trackdlo.cpp:847 uses i-1 >= 0).
            segs = [(i, i - 1) for i in range(last_found, 0, -1)]
            found, pos, inter = _pursuit_step(guide_nodes, cur_center, look_ahead, segs)
            if not found:
                break
            last_found = last_found - pos
            cur_center = inter
            pairs.append(pair(seg_it - 1, inter))
            seg_it -= 1

    return np.array(pairs)
