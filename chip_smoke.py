#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA GPU:

    python3 chip_smoke.py

Phases, in order (any failure exits nonzero and prints no result line):

1. toolchain: the card's name and power limit, torch's CUDA version, nvcc;
2. build: compile the twelve CUDA sources (fifteen kernels and modes) from
   ``trackdlo_tpu_torch/csrc``, one ``nvcc`` per source, all started
   together;
3. check: kernels E and S's cluster launches (size, rows per CTA, clusters
   the card holds at once); each kernel against its plain PyTorch version on
   the card, at the shapes of the main paths (720p frames, M=45, the live
   cloud capacity, 16 streams for the batched E-step; each stream of the
   batch bit-equal to the same stream launched alone), the Gauss-Jordan
   solve and its plain version against float64, kernel E after 10
   iterations, the 4·B walks against each stream's alone (the JAX package's
   audit fields, printed beside the port's names where they differ),
   and the per-iteration EM against kernel E and its plain version; kernel
   W bit for bit its saved previous design; kernel E's trips on four saved
   pre-registration passes against the JAX package's B1, and frame 25 phase
   by phase through a probe build of kernel E (ROADMAP §C fault 1); kernel C
   with explicit kept cells and in its derived mode (the overflow thinning
   and the centroid division in the launch), at the live slots and at 16
   slots a channel, where the thinning fires; the exact route (the step's
   parity preprocessing) at the evaluation preset's 720p shape on a frame
   with 2 mm depth noise, 5% dropout and a box over the rope: kernel P's
   exact build against its plain version (counts bit-equal, sums within
   2e-6, the same split channel-cells and pixels without depth), kernel X
   after kernel C against the plain route's cloud (the same voxels, each
   centroid within 1e-6 m); kernel
   P's one-channel modes (floor votes, no leaf) and kernel F (one EM
   iteration with its one-hot M-step solve): F's route against the plain
   per-iteration route, a live tolerance run through F (its trips the plain
   version's), F batched, one device op a route iteration, F against its
   previous design's saved outputs (recorded); kernel N (each node's
   nearest point on one shard of the cloud) bit-equal to its plain version,
   alone and for 4 streams, with bool and float32 masks, one device op a
   call; kernel L (the EM loop's trip flag) against its plain version;
4. closed loop: ``Tracker.step`` (its step one CUDA graph, replayed a
   frame) over 30 occluded frames against the float64 oracle, with the
   kernels' launch counts and the EM trip-count gate (each pass's mean
   iterations within one of the oracle's); the eager step over the same
   frames, every output bit for bit the graph's; two streams interleaved
   through the compiled step, each its run alone; then the coarse profile
   (``parity_split=False``, 30 frames) and the cells-only profile
   (``exact_voxels=False``, 10 frames), each against the oracle fed the
   port's own clouds; 49, 64 and 100 nodes (ROADMAP §C fault 3: the plain
   versions of kernels past their node ranges, on the card), 10 frames each,
   graph against eager and against the oracle; the TCP service on the card
   with two clients, every reply a direct step's; GLTP on the card against
   its CPU run; the reference cells through the compiled steps: 45 occluded
   frames (``full``) and the oracle's own clouds through the compiled
   ``Tracker.step_from_points`` (``same_pts``), the native library's clouds
   through it (graph bit for bit eager), perf/trip_counts.py's 40 frames'
   trips, and the evaluation profile (``eval_params()``) beside the JAX
   package's CPU run of the same frames (perf/eval_profile_jax_cpu.json);
5. batch: the batched step over 16 streams in cohorts of 8 for 30 frames,
   each frame set one CUDA graph (every cohort's EM loops conditional WHILE
   nodes whose trips kernel L decides on the card), each frame held against
   the single-stream step from the same state and against a lockstep batch
   of 16, streams 0 and 15 against the oracle, the exact lockstep launch
   count (the trips counted on the card); the graph against the eager
   step, and a lockstep batch of 8 the same way, with no host read inside
   a replay; a trace of replays (S, G and L spans); then ``Tracker.step``
   with ``solver="lstsq"`` (the single-stream per-iteration route, one
   graph) against the oracle and its eager step; kernel F's route
   (``cpd_lle(use_fused_mstep=True)``) as a graph against its eager run;
   then the coarse batched step, 4 streams for 10 frames, its clouds
   against the single-stream coarse step's;
6. shard: the point-sharded step (``build_parallel_step_fn``) on 2 gloo
   ranks sharing the card (NCCL refuses two ranks on one GPU), the mesh 1
   data × 2 model, over the 30 frames of phase 4: the shards' counts against
   the cloud's, y bit-equal across the ranks, against the oracle, each frame
   against ``Tracker.step`` from the same state (phase 5's nudge rule), the
   exact launch counts, the per-frame time (CUDA events);
7. timing: the per-frame single step (parity as one CUDA graph and eager,
   and coarse), the batched step at b16/c8 and b8 (graph and eager), the
   lstsq step and ``step_from_points`` (graph and eager), all by CUDA
   events, and each kernel beside its plain version and, for the
   solve, beside ``torch.linalg.solve``, with its device time from a
   ``torch.profiler`` trace; kernel P also with the L2 flushed before each
   launch; kernel C in the main path's derived mode; kernel F also beside
   one iteration of the single-stream per-iteration route; the wide builds
   at 100 and 128 nodes with their bounds (G also beside
   ``torch.linalg.solve``).

Every path is driven with the launch counters set to 0 just before it and
read just after. The last two lines of standard output are the card line
and a JSON object ``{"ok": true, "device": {...}}``; the line before them
holds the kernels' JSON record. Details go to ``chiprun_out/chip_smoke.json``;
kernel G's outputs and the closed loop's final nodes and trips to
``chiprun_out/exact_products_bits.npz``, kernel W's inputs and outputs on
five cases to ``chiprun_out/walks_bits.npz`` (the card tests hold the
kernels bit-equal to the copies in ``tests/data``).
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import threading
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))

# Node counts whose Tracker.step phase 4 drives (frames each): the wide
# builds' and the node-unbounded builds'.
NODE_COUNTS = {49: 10, 64: 10, 100: 10, 129: 5, 192: 5, 256: 5, 512: 3, 1024: 3}
# Phase 3's bounds for a kernel against its plain version, by field.
WIDE_BOUNDS = (("em3_lle_max_m", 1e-6), ("em10_max_m", 2e-6),
               ("visibility_idx_mismatch", 0), ("visibility_max_m", 1e-6),
               ("walks_mask_mismatch", 0), ("walks_max_m", 5e-6),
               ("estep_outside_tol", 0), ("estep_short_mismatch", 0),
               ("gj_spd_vs_f64_max", 2e-8),
               ("em3_fusedmstep_max_m", 1e-6), ("nearest_mismatch", 0))
# (rows, nodes) of the clouds past 16,384 rows that E, S and F are held on.
ROW_CELLS = ((16385, 45), (32768, 45), (65536, 45), (32768, 128), (65536, 256))
# The wide_kernels runs that the timing phase times.
WIDE_TIMED = ("nodes100", "nodes128", "nodes256", "nodes512", "rows65536_nodes45")

BOUNDS = {
    "preprocess_parity_count_delta": 0,
    "preprocess_parity_p95_m": 1e-6,
    "parity_z_mismatch": 0,
    "parity_xy_mismatch": 0,
    "compact_mismatch": 0,
    # The exact route on the noisy 720p frame: kernel P's exact build
    # against its plain version (counts, split channel-cells and pixels
    # without depth exact; sums a few float32 ulps at ~1 m), then the cloud
    # after kernel X and the snap against the plain route's (kernel X sums a
    # voxel's pixels in another order).
    "exact_p_count_mismatch": 0,
    "exact_p_sums_max": 2e-6,
    "exact_split_mismatch": 0,
    "exact_cloud_count_delta": 0,
    "exact_cloud_max_m": 1e-6,
    "visibility_idx_mismatch": 0,
    "visibility_dist_max_m": 1e-6,
    "visibility_pointmin_max": 1e-6,
    "priors_mask_mismatch": 0,
    "priors_pos_max_m": 5e-6,
    "em3_plain_max_m": 1e-6,
    "em3_lle_max_m": 1e-6,
    "em3_priors_gate_max_m": 1e-6,
    # The JAX package's audit fields (perf/tpu_kernel_numerics.py:36-55) that
    # the checks above do not cover, under its names and bounds: kernel E
    # against its plain version after 10 iterations (tol 0); the plain
    # version of kernel G (LU and two triangular solves, on the card)
    # against float64;
    # kernel W's 4·B walks against each stream's walks alone.
    "em10_pallas_vs_xla_max_m": 2e-6,
    # ROADMAP §C fault 1: on the four saved pre-registration passes, kernel
    # E's and the plain version's trips within one of B1's; the probe build
    # of kernel E takes kernel E's trips; on frame 25 no phase of kernel E
    # ten times further from float64 than the plain float32 route's.
    "prereg_trips_vs_b1_max": 1,
    "prereg_probe_trips_mismatch": 0,
    "prereg_phase_vs_plain_max_ratio": 10.0,
    "lu_solve_vs_f64_max": 1e-7,
    "priors_batched_vs_single_max_m": 1e-6,
    # Kernel W on the five cases and their 4·5-walk batch, from the inputs
    # saved with the previous design's outputs: every position and mask
    # bit for bit.
    "walks_vs_saved_mismatch": 0,
    "closed_loop_mean_mm": 1.0,
    # The batched slice. The solve against float64 and the batched EM
    # against the single stream are the JAX package's own bounds
    # (perf/tpu_kernel_numerics.py); the kernel against its plain version
    # on the same systems: each within 2e-8 of float64, so within 4e-8.
    "gj_solve_vs_f64_max": 2e-8,
    "gj_solve_vs_plain_max": 4e-8,
    # E-step: elements outside rtol 2e-4, atol 1e-6 (tests/test_pallas.py's
    # E-step bound); shortest_sq must be equal where it is defined.
    "estep_outside_tol": 0,
    "estep_short_mismatch": 0,
    "estep_batch_vs_alone_mismatch": 0,
    "em10_batched_vs_single_max_m": 2e-6,
    "em3_periter_plain_max_m": 1e-6,
    "em3_periter_lle_max_m": 1e-6,
    "em3_periter_priors_gate_max_m": 1e-6,
    # Per frame from one state. At the live profile the step is sensitive:
    # its own output moves by up to ~5 mm when its input nodes move by 1e-7 m
    # (float32 rounding of the coordinates), through the EM passes' exit
    # iterations. The batched step (per-iteration EM) and the single step
    # (kernel E) are two float32 realisations of the same loop, so the median
    # stream-frame is held at the open-loop step bound of
    # tests/test_torch_tracker.py, and the batched-vs-single distance at its
    # median, p90 and p99 to at most twice the single step's distance from
    # itself under that nudge. The pre-registration pass's guide nodes are
    # held to the same rule.
    "batched_vs_single_median_m": 5e-4,
    "batched_vs_single_over_nudged": 2.0,
    "batched_guides_vs_single_over_nudged": 2.0,
    "batched_closed_loop_s0_mean_mm": 1.0,
    "batched_closed_loop_s15_mean_mm": 1.0,
    # Cohorts of 8 against one lockstep batch of 16: bit-equal y and sigma2.
    "cohort_vs_lockstep_max": 0.0,
    "batched_launch_mismatch": 0,
    "lstsq_closed_loop_mean_mm": 1.0,
    # The single-channel slice. Kernel P's one-channel modes against the
    # plain version: counts and floor-vote sums (integers below 2^24) equal
    # element for element; the clouds from the two sets of sums as the JAX
    # package's audit holds its compiled kernel (perf/tpu_kernel_numerics.py,
    # preprocess_kernel_*); the no-leaf cloud as the parity cloud.
    "cell_sums_votes_mismatch": 0,
    "preprocess_kernel_count_delta": 0,
    "preprocess_kernel_vs_xla_p95_m": 2e-6,
    "cell_sums_cells_mismatch": 0,
    "preprocess_cells_count_delta": 0,
    "preprocess_cells_p95_m": 1e-6,
    # The coarse clouds are not the oracle's PCL-exact clouds (the JAX
    # package records ~2.4 mm for the coarse profile), so each coarse loop is
    # held against the float64 oracle fed the port's own clouds; the oracle
    # on its own preprocessing is a gross tripwire.
    "coarse_closed_loop_mean_mm": 1.0,
    "coarse_vs_oracle_own_mean_mm": 5.0,
    "cells_closed_loop_mean_mm": 1.0,
    # The coarse batched step: clouds bit-equal to the single step's, the
    # exact lockstep launch count, y under phase 5's nudge rule.
    "coarse_batched_cloud_mismatch": 0,
    "coarse_batched_launch_mismatch": 0,
    "coarse_batched_vs_single_median_m": 5e-4,
    "coarse_batched_vs_single_over_nudged": 2.0,
    # Kernel F: the JAX audit's bounds (em10_fusedmstep_vs_xla_max_m) and
    # check_em's; the launch count equal to the iteration count; a batch of
    # copies bit-equal to one stream of the same staging through F.
    "em3_fusedmstep_plain_max_m": 1e-6,
    "em3_fusedmstep_lle_max_m": 1e-6,
    "em3_fusedmstep_priors_gate_max_m": 1e-6,
    "em10_fusedmstep_vs_xla_max_m": 2e-6,
    "fused_live_launch_mismatch": 0,
    "fused_batched_vs_single_max": 0.0,
    "fused_batched_launch_mismatch": 0,
    # The live tolerance run through F takes its plain version's trips; one
    # route iteration (the c's computed in the launch) is one device op.
    "fused_live_trips_vs_plain": 0,
    "fused_iteration_extra_device_ops": 0,
    # The point-sharded slice. Kernel N against its plain version: a minimum
    # is exact in any order, so every element is equal. The sharded step:
    # the shards' valid points sum to the cloud's count on every frame; y and
    # sigma2 bit-equal across the ranks (every rank solves the same
    # all-reduced system); the closed loop and the per-frame distance from
    # Tracker.step as the batched step's (phase 5); the exact launch counts.
    "nearest_mismatch": 0,
    "nearest_extra_device_ops": 0,
    "sharded_count_mismatch": 0,
    "sharded_ranks_mismatch": 0,
    "sharded_closed_loop_mean_mm": 1.0,
    "sharded_vs_single_median_m": 5e-4,
    "sharded_vs_single_over_nudged": 2.0,
    "sharded_launch_mismatch": 0,
    # The EM trip-count gate (perf/trip_counts.py): over the closed loop the
    # port's mean iterations per pass within one of the float64 oracle's.
    "trip_pre_mean_delta": 1.0,
    "trip_main_mean_delta": 1.0,
    # The compiled step (one CUDA graph replayed a frame) against the eager
    # step over the closed loop: every output field bit for bit, the same
    # launches; two streams interleaved through one compiled step each bit
    # for bit its run alone.
    "graph_vs_eager_mismatch": 0,
    "graph_launch_mismatch": 0,
    "graph_interleaved_vs_alone_mismatch": 0,
    # ROADMAP §C faults 3 and 4: 49, 64 and 100 nodes (the kernels' wide
    # builds) and 129, 192, 256, 512 and 1,024 (their node-unbounded builds),
    # a few frames each: the compiled step bit for bit the eager one; at 49
    # nodes the closed loop's bound against the oracle (past it the live
    # profile loses the rope in the oracle itself). The wide and unbounded
    # builds against their plain versions at those counts and 128, at phase
    # 3's bounds (E, after 3 iterations with LLE and after 10 with the gate
    # on; V; W; S; G on SPD systems against float64 as gj_solve_vs_f64_max;
    # F; N).
    **{f"nodes{m}_graph_vs_eager_mismatch": 0 for m in NODE_COUNTS},
    **{f"nodes{m}_{k}": v for m in (*NODE_COUNTS, 128) for k, v in WIDE_BOUNDS},
    "nodes49_closed_loop_mean_mm": 1.0,
    # ROADMAP §C fault 5: E, S and F over clouds past 16,384 rows (a CTA
    # taking its rows a tile at a time) against their plain versions at the
    # same bounds: 45 nodes at 16,385, 32,768 and 65,536 rows, the wide build
    # (128 nodes) at 32,768 and the unbounded build (256) at 65,536.
    **{f"rows{n}_nodes{m}_{k}": v for n, m in ROW_CELLS for k, v in WIDE_BOUNDS
       if k.startswith(("em", "estep"))},
    # The long-cable cell: 256 nodes on a 1.6 m cable 1.2 m from the 720p
    # camera, drawn 3 px thick with an 8 px painter, 10 frames: the closed
    # loop against the float64 oracle at the closed loop's bound, the
    # compiled step bit for bit its eager run.
    "cable256_closed_loop_mean_mm": 1.0,
    "cable256_graph_vs_eager_mismatch": 0,
    # The TCP service on the card: every reply of two concurrent clients bit
    # for bit a direct step; GLTP on the card against its CPU run, the
    # closed loop's bound.
    "server_vs_direct_mismatch": 0,
    "gltp_card_vs_cpu_mean_mm": 1.0,
    # The per-iteration EM loop on the device (a conditional WHILE node of a
    # CUDA graph, kernel L deciding the trips). Kernel L against its plain
    # version; the batched step at b16/c8 and at b8 lockstep, the single step
    # with solver "lstsq", kernel F's route (cpd_lle(use_fused_mstep=True))
    # and the points step, each as one graph, bit for bit its eager run; no
    # host read inside a replay (torch.cuda.set_sync_debug_mode("error")).
    "loop_flag_mismatch": 0,
    "batched_graph_vs_eager_mismatch": 0,
    "b8_graph_vs_eager_mismatch": 0,
    "batched_graph_host_reads": 0,
    "lstsq_graph_vs_eager_mismatch": 0,
    "fused_graph_vs_eager_mismatch": 0,
    "native_graph_vs_eager_mismatch": 0,
    "solver_graphs_vs_eager_mismatch": 0,
    # The reference cells (perf/parity_decomposition.py, perf/trip_counts.py):
    # same_pts (the oracle's own clouds through the compiled points step, 30
    # frames) and the 45-frame occluded loop, each at the closed loop's
    # bound; the 40 unoccluded frames' mean trips a pass within one of the
    # oracle's.
    "same_pts_mean_mm": 1.0,
    "occl45_closed_loop_mean_mm": 1.0,
    "trip40_pre_mean_delta": 1.0,
    "trip40_main_mean_delta": 1.0,
    # The evaluation profile: held at 1 mm only where the JAX package's CPU
    # build meets it on the same frames (perf/eval_profile_jax_cpu.json).
    "eval_closed_loop_mean_mm": 1.0,
}
# The port's names of four fields of the JAX package's audit, beside the
# audit's own.
JAX_NAMES = {
    "em3_plain_max_m": "em3_fusedloop_vs_xla_max_m",
    "em3_lle_max_m": "em3_fusedloop_lle_vs_xla_max_m",
    "em3_priors_gate_max_m": "em3_fusedloop_priors_vs_xla_max_m",
    "preprocess_parity_p95_m": "preprocess_parity_vs_xla_p95_m",
}
N_STREAMS, COHORT = 16, 8
EXPECTED_LAUNCHES = {"cell_sums": 30, "compact": 30, "split_cells": 30, "visibility": 30,
                     "walks": 30, "em_loop": 60, "estep": 0, "estep_batch": 0, "gj_solve": 0,
                     "cell_sums_votes": 0, "cell_sums_cells": 0, "em_iteration": 0, "nearest": 0,
                     "loop_flag": 0}
# Per frame of the coarse (votes) and cells-only loops: kernel P's mode,
# V, W, and kernel E twice; neither C, X nor the parity mode.
COARSE_LAUNCHES = {"visibility": 1, "walks": 1, "em_loop": 2, "cell_sums": 0, "compact": 0,
                   "split_cells": 0,
                   "em_iteration": 0, "estep": 0, "estep_batch": 0, "gj_solve": 0, "nearest": 0,
                   "loop_flag": 0}
KERNELS = {
    "cell_sums": ("trackdlo_tpu_torch/csrc/cell_sums.cu", "trackdlo_tpu/ops/preprocess_kernel.py:470"),
    "compact": ("trackdlo_tpu_torch/csrc/compact.cu", "trackdlo_tpu/ops/preprocess_kernel.py:617"),
    # Kernel X replaces no pallas_call: the JAX package merges the voxels
    # of a split channel-cell (ROADMAP §C fault 6).
    "split_cells": ("trackdlo_tpu_torch/csrc/split_cells.cu",
                    "none; the parity split of trackdlo_tpu/ops/preprocess.py, which merges them"),
    "visibility": ("trackdlo_tpu_torch/csrc/visibility.cu", "trackdlo_tpu/ops/visibility_kernel.py:292"),
    "walks": ("trackdlo_tpu_torch/csrc/walks.cu", "trackdlo_tpu/ops/pallas_kernels.py:1685"),
    "em_loop": ("trackdlo_tpu_torch/csrc/em_loop.cu", "trackdlo_tpu/ops/pallas_kernels.py:1441"),
    "estep": ("trackdlo_tpu_torch/csrc/estep.cu", "trackdlo_tpu/ops/pallas_kernels.py:728"),
    "estep_batch": ("trackdlo_tpu_torch/csrc/estep.cu", "trackdlo_tpu/ops/pallas_kernels.py:942"),
    "gj_solve": ("trackdlo_tpu_torch/csrc/gj_solve.cu", "trackdlo_tpu/ops/pallas_kernels.py:1112"),
    "cell_sums_votes": ("trackdlo_tpu_torch/csrc/cell_sums.cu", "trackdlo_tpu/ops/preprocess_kernel.py:470"),
    "cell_sums_cells": ("trackdlo_tpu_torch/csrc/cell_sums.cu", "trackdlo_tpu/ops/preprocess_kernel.py:470"),
    "em_iteration": ("trackdlo_tpu_torch/csrc/em_iter.cu", "trackdlo_tpu/ops/pallas_kernels.py:482"),
    "nearest": ("trackdlo_tpu_torch/csrc/nearest.cu", "trackdlo_tpu/ops/pallas_kernels.py:556"),
    # Kernel L replaces no pallas_call: it decides the trips of the EM loop
    # that the JAX package runs as a lax.while_loop.
    "loop_flag": ("trackdlo_tpu_torch/csrc/loop_flag.cu",
                  "none; the while_loop condition at trackdlo_tpu/ops/cpd_lle.py:212"),
}
# Each launch counter's CUDA kernel, by the name a profiler trace shows.
KERNEL_FUNCS = {"cell_sums": "cell_sums_kernel", "compact": "compact_kernel",
                "split_cells": "split_cells_kernel",
                "visibility": "visibility_kernel", "walks": "walks_kernel",
                "em_loop": "em_loop_kernel", "estep": "estep_kernel", "gj_solve": "gj_solve_kernel",
                "em_iteration": "em_iter_kernel", "nearest": "nearest_kernel",
                "loop_flag": "loop_flag_kernel"}
# The path whose run gives each kernel's launch count in the kernels line.
LAUNCH_PATH = {"estep": "lstsq", "estep_batch": "batched", "gj_solve": "batched",
               "cell_sums_votes": "coarse", "cell_sums_cells": "cells", "em_iteration": "fused",
               "nearest": "sharded", "loop_flag": "batched"}
SHARD_RANKS = 2

# Published peaks of one H100 SXM (NVIDIA's data sheet): device memory and
# float32 outside the tensor cores. A kernel's bound is the larger of its
# bytes (each input read once, each output written once) over the first and
# its operations over the second.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# Operation counts per unit of work (adds, multiplies, compares, exp and
# sqrt each one operation), read off the kernels' code:
OPS_PER_PIXEL = 45         # kernel P: HSV test, deprojection, floors, sums
OPS_PER_PIXEL_CELLS = 33   # kernel P without a leaf: no floors
OPS_SWEEP_PAIR = 9         # squared distance and min, per (node, point)
OPS_ESTEP_PAIR = 30        # both E-step passes and the P1/PX sums, per (node, point)
OPS_WALK_STEP_SEG = 40     # kernel W: one sphere-segment test


def gj_solve_ops(m: int) -> int:
    """The least work of kernel G's function for one system: the LU
    factorisation and the inverse (2 m^3), the solve for three right-hand
    sides (2 m^2 3) and three refinement steps (each the residual's m x m x 3
    product as the nine products of B1's bfloat16 pieces, and the
    correction's one product)."""
    return 2 * m ** 3 + 2 * m * m * 3 + 3 * (9 + 1) * 2 * m * m * 3


def em_mstep_ops(m: int) -> int:
    """Kernel E's M-step per iteration (and kernel G's with its node
    update): the solve, then T = Y0 + G W as nine piece products."""
    return gj_solve_ops(m) + 9 * 2 * m * m * 3


def onehot_mstep_ops(m: int) -> int:
    """Kernel F's M-step: the least work of a Gauss-Jordan solve with three
    right-hand sides and no inverse, equilibration or refinement
    ((2/3) m^3 + 2 m^2 3), then T = Y0 + G W."""
    return 2 * m ** 3 // 3 + 2 * m * m * 3 + 2 * m * m * 3


def spd_systems(m: int):
    """Eight (m, m) SPD systems A Aᵀ + m I with three right-hand sides,
    numpy float32 from the seed m: kernel G's systems against float64."""
    import numpy as np

    rng = np.random.default_rng(m)
    a = rng.standard_normal((8, m, m)).astype(np.float32)
    a = a @ a.transpose(0, 2, 1) + m * np.eye(m, dtype=np.float32)
    return a, rng.standard_normal((8, m, 3)).astype(np.float32)


def launches_only(counts: dict) -> dict:
    """The launch counters of ``_build``'s counts, without kernel X's work
    tally (``split_cells.*``: what it regrouped, which the frames decide)."""
    return {k: v for k, v in counts.items() if "." not in k}


def quantile_ratio(got, ref) -> float:
    """The largest ratio of ``got`` to ``ref`` at the median, p90 and p99
    (0 over 0 reads 1)."""
    import numpy as np

    ratios = []
    for q in (0.5, 0.9, 0.99):
        g, r = float(np.quantile(got, q)), float(np.quantile(ref, q))
        ratios.append(1.0 if g == r == 0.0 else (g / r if r > 0 else float("inf")))
    return max(ratios)


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_b, t_o = nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_PER_S
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def log(msg: str) -> None:
    print(msg, flush=True)


def ms_or_not(v) -> str:
    """A device time for the log; a profiler trace can hold none of the
    spans it looked for (seen on the H100), which reads "not measured"."""
    return "not measured" if v is None else f"{v:.4f} ms"


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0] if res.stdout.strip() else "nvidia-smi: no output"


@contextlib.contextmanager
def oracle_trip_counts():
    """Within the block, each call of the oracle's EM from its tracking step
    appends its iteration count to the yielded list (the oracle's own
    function runs unchanged)."""
    from trackdlo_tpu_torch.oracle import tracking

    trips, real = [], tracking.cpd_lle

    def recording(*args, **kwargs):
        result = real(*args, **kwargs)
        trips.append(int(result.iterations))
        return result

    tracking.cpd_lle = recording
    try:
        yield trips
    finally:
        tracking.cpd_lle = real


def shard_worker(rank: int, world: int, device: str, n_frames: int) -> dict:
    """One rank of the point-sharded step (spawned by phase 6): the live
    profile, the mesh 1 data × ``world`` model, the frames of phase 4
    rendered here from the same seedless sequence. Its launch counts are set
    to 0 just before the frames and read just after; then the frames are
    stepped again and timed, and so is one all-reduce of the main pass's
    packed sums (4·45 + 2 floats) on the card and on the host. Returns
    per-frame numpy results."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from trackdlo_tpu_torch import _build
    from trackdlo_tpu_torch.config import CameraIntrinsics, live_params
    from trackdlo_tpu_torch.io.sequence import SyntheticRope, render_frame
    from trackdlo_tpu_torch.models.trackdlo import init_state
    from trackdlo_tpu_torch.ops.collectives import shard_slice
    from trackdlo_tpu_torch.parallel import build_parallel_step_fn, make_tracking_mesh, replicate_state

    params, intr, rope = live_params(), CameraIntrinsics(), SyntheticRope()
    mesh = make_tracking_mesh(model_parallel=world)
    step = build_parallel_step_fn(params, intr, mesh, device=device)
    frames = []
    for i in range(1, n_frames + 1):
        rgb, depth = render_frame(rope, i / 15.0, intr)
        occ = np.ones((intr.height, intr.width), np.uint8) * 255
        if 10 <= i <= 20:
            occ[:, 500:800] = 0
        frames.append((rgb[None], depth[None], occ[None]))
    state = replicate_state(init_state(rope.nodes(0.0, params.M), params, device), 1)
    _build.lib()  # the parent built it: this loads the cached library
    keys = ("y", "sigma2", "n_points", "iterations", "guide_iterations", "occlusion_state")
    rec = {k: [] for k in keys + ("shard_count", "event_ms")}
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    for f in frames:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, out = step(state, *f)
        end.record()
        end.synchronize()
        rec["event_ms"].append(start.elapsed_time(end))
        for k in keys:
            rec[k].append(getattr(out, k)[0].cpu().numpy())
        shard = shard_slice(out.points_mask.shape[-1], mesh.model_group)
        rec["shard_count"].append(int(out.points_mask[0, shard].sum()))
    torch.cuda.synchronize()
    rec["launches"] = dict(_build.launch_counts)
    timed, wall = [], []
    for f in frames:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        state, _ = step(state, *f)
        end.record()
        end.synchronize()
        wall.append(1000 * (time.perf_counter() - t0))
        timed.append(start.elapsed_time(end))

    def all_reduce_ms(t, n=200):
        for _ in range(10):
            dist.all_reduce(t, group=mesh.model_group)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            dist.all_reduce(t, group=mesh.model_group)
        torch.cuda.synchronize()
        return 1000 * (time.perf_counter() - t0) / n

    rec["all_reduce_ms"] = {"cuda": all_reduce_ms(torch.zeros(4 * params.M + 2, device=device)),
                            "cpu": all_reduce_ms(torch.zeros(4 * params.M + 2))}
    rec.update(timed_event_ms=timed, timed_wall_ms=wall, shard=(shard.start, shard.stop),
               jax_modules=[k for k in sys.modules
                            if k.split(".")[0] in ("jax", "jaxlib", "trackdlo_tpu")])
    return {k: (np.stack(v) if k in keys else v) for k, v in rec.items()}


class Smoke:
    def __init__(self, frames: int = 30, timing_frames: int = 100):
        import numpy as np
        import torch

        from trackdlo_tpu_torch.config import CameraIntrinsics, live_params
        from trackdlo_tpu_torch.io.sequence import SyntheticRope, render_frame

        self.np, self.torch = np, torch
        self.params = live_params()
        self.intr = CameraIntrinsics()
        self.rope = SyntheticRope()
        self.render = render_frame
        self.frames = frames
        self.timing_frames = timing_frames
        self.dev = torch.device("cuda")
        self.metrics: dict = {}
        self.kernel_err: dict = {}
        self.launches: dict = {}
        self.path_launches: dict = {}
        self.times: dict = {}
        self.bits: dict = {}  # outputs kept bit for bit (chiprun_out/exact_products_bits.npz)
        self.walk_bits: dict = {}  # kernel W's inputs and outputs (chiprun_out/walks_bits.npz)
        self.bounds_ms: dict = {}
        self.wide_calls: dict = {}  # run key -> kernel name -> (kernel, plain[, library] call)
        self.wide_bounds: dict = {}  # run key -> kernel name -> (bound ms, what bounds it)
        self.failures: list[str] = []

    # -- helpers -----------------------------------------------------------
    def bound(self, key: str, value: float) -> None:
        self.metrics[key] = value
        ok = abs(value) <= BOUNDS[key]
        jax = f"  (JAX audit: {JAX_NAMES[key]})" if key in JAX_NAMES else ""
        log(f"  {key:34s} {value!r:>24}  bound {BOUNDS[key]!r}  {'ok' if ok else 'FAIL'}{jax}")
        if not ok:
            self.failures.append(key)

    def frame(self, t: float, occlude: bool = False):
        np, torch = self.np, self.torch
        rgb, depth = self.render(self.rope, t, self.intr)
        occ = np.ones((self.intr.height, self.intr.width), np.uint8) * 255
        if occlude:
            occ[:, 500:800] = 0
        return rgb, depth, occ

    def to_dev(self, rgb, depth, occ):
        torch = self.torch
        return (
            torch.from_numpy(rgb).to(self.dev),
            torch.from_numpy(depth.view(self.np.int16)).to(self.dev),
            torch.from_numpy(occ != 0).to(self.dev),
        )

    def event_ms(self, fn, n):
        """ms per call of ``fn`` over ``n`` calls after one warm-up call,
        between two CUDA events."""
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n

    def device_ms(self, fn, n):
        """The device time of one call of ``fn`` (the sum of its kernels' and
        copies' spans in a torch.profiler trace of ``n`` calls after one
        warm-up call) and its device ops per call; (None, 0) where the trace
        holds no device activity. Events between back-to-back calls measure
        the host where the host is slower than the card; this does not.

        A trace can miss some of the device activity at its start (seen on
        the H100 with the kernels this library launches through ctypes), so
        the ``n`` timed calls follow ``n`` untimed ones in the same trace,
        only the device spans that start inside the timed range count, and
        a trace whose count is no whole number of ops a call is taken again
        (three times at most; the fullest is kept)."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile, record_function

        fn()
        torch.cuda.synchronize()
        best = []
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
                with record_function("chip_smoke_timed"):
                    for _ in range(n):
                        fn()
                    torch.cuda.synchronize()
            events = prof.events()
            start = min(e.time_range.start for e in events if e.name == "chip_smoke_timed")
            ev = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.time_range.start >= start and e.name != "chip_smoke_timed"]
            if len(ev) > len(best):
                best = ev
            if len(ev) % n == 0:
                break
        if not best:
            return None, 0.0
        return sum(e.time_range.elapsed_us() for e in best) / 1e3 / n, len(best) / n

    def extra_device_ops(self, fn, n, counter, kernel):
        """The device ops a call of ``fn`` makes besides one launch of its
        kernel, over ``n`` calls after one warm-up call: the launches the
        wrapper counted (``_build.launch_counts[counter]``) past one a call,
        plus the device spans (kernels, copies, fills) of a profiler trace of
        those calls whose names do not hold ``kernel``, per call. The trace
        can lose spans (seen on the H100: some traces of the same calls hold
        16% fewer), so the kernel's own launches are counted on the host and
        the trace is read only for other ops, which a lost span can hide but
        never invent. Returns the extra ops per call and the other spans'
        names."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile

        from trackdlo_tpu_torch import _build

        fn()
        torch.cuda.synchronize()
        before = _build.launch_counts[counter]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        launches = _build.launch_counts[counter] - before
        other = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA and kernel not in e.name]
        return abs(launches / n - 1) + len(other) / n, sorted(set(other))

    def cold_l2(self, fn, name, n=50):
        """The device time of ``fn``'s kernels whose names hold ``name``,
        with the L2 flushed before each call (a 64 MB buffer, more than the
        H100's 50 MB, zeroed): the frame arrives from the host each step."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile

        flush = torch.empty(64 << 20, dtype=torch.uint8, device=self.dev)
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA and name in e.name]
        return {"device_ms": sum(e.time_range.elapsed_us() for e in ev) / 1e3 / n if ev else None,
                "kernels_per_call": len(ev) / n}

    def time_pair(self, name, kernel_fn, plain_fn, n_kernel=50, n_plain=5, library_fn=None):
        """ms per call of the kernel, of its plain version and of the library
        call (if any), measured in turns (plain, kernel, kernel, plain) with
        CUDA events; then the kernel's device time from the profiler."""
        run = self.event_ms
        p1 = run(plain_fn, n_plain)
        k1 = run(kernel_fn, n_kernel)
        k2 = run(kernel_fn, n_kernel)
        p2 = run(plain_fn, n_plain)
        rec = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
               "ms_runs": [k1, k2], "plain_ms_runs": [p1, p2], "library_ms": None}
        if library_fn is not None:
            rec["library_ms"] = run(library_fn, n_kernel)
        rec["device_ms"], rec["device_ops_per_call"] = self.device_ms(kernel_fn, n_kernel)
        self.times[name] = rec
        lib = f"   library {rec['library_ms']:.4f} ms" if library_fn is not None else ""
        dev = ("not measured" if rec["device_ms"] is None
               else f"{rec['device_ms']:.4f} ms in {rec['device_ops_per_call']:g} ops")
        log(f"  {name:12s} kernel {rec['ms']:.4f} ms (device {dev})   plain {rec['plain_ms']:.4f} ms"
            f"{lib}   bound {self.bounds_ms[name][0]:.6f} ms ({self.bounds_ms[name][1]})")

    def count_path(self, path: str, fn):
        """Run ``fn`` with every launch counter at 0; keep the counts."""
        from trackdlo_tpu_torch import _build

        self.torch.cuda.synchronize()
        _build.reset_launch_counts()
        out = fn()
        self.torch.cuda.synchronize()
        # The trips of the loops inside replayed graphs, counted on the card.
        self.path_launches[path] = dict(_build.settle_counts())
        log(f"  launches in the {path} run: {self.path_launches[path]}")
        return out

    @staticmethod
    def warm(tracker, state, frame):
        """One step whose result is dropped: a compiled step's first call
        warms it up and captures its CUDA graph (its launches, outside any
        counted run, are real launches)."""
        tracker.step(state, *frame)

    def outputs_mismatch(self, a, b) -> int:
        """How many fields of two StepOutputs (or states) differ in any bit
        (float32 fields compared as their bits, so two equal NaNs match)."""
        torch = self.torch
        bits = lambda t: t.view(torch.int32) if t.dtype == torch.float32 else t
        return sum(not torch.equal(bits(x), bits(y)) for x, y in zip(a, b))

    # -- phase 3: kernels against their plain versions ----------------------
    def cluster_launches(self):
        """Kernels E, S and F launch as thread-block clusters: the cluster
        size and rows per CTA for the live cloud (2048 rows) and a shard of
        two ranks (1024), and how many such clusters the card holds at
        once."""
        from trackdlo_tpu_torch.ops.hopper_kernels import cluster_info

        info = {f"{k}_n{n}": cluster_info(k, n)
                for k, n in (("em_loop", 2048), ("estep", 2048), ("estep", 1024), ("em_iter", 2048))}
        # Past 16,384 rows a CTA takes its rows a tile at a time; past 128
        # nodes the unbounded builds run 8 CTAs.
        info.update({f"{k}_n{n}_m{m}": cluster_info(k, n, m) for k, n, m in (
            ("em_loop", 65536, 45), ("em_loop", 2048, 256), ("estep", 65536, 256),
            ("em_iter", 2048, 1024))})
        self.metrics["cluster_launches"] = info
        for key, v in info.items():
            log(f"  {key}: {v['cluster_size']} CTAs of {v['rows_per_cta']} rows, at most "
                f"{v['max_active_clusters']} clusters at once, {v['smem_bytes']} B of shared "
                "memory a CTA")

    def check_preprocess(self):
        np, torch = self.np, self.torch
        from trackdlo_tpu_torch.ops.preprocess import (
            cell_sums_plain, compact_channels, compact_channels_plain, compact_occupied_channels,
            compact_occupied_channels_plain, compact_sums, default_cell_px, exact_frame, kept_cells,
        )
        from trackdlo_tpu_torch.ops.preprocess_kernel import cell_sums

        p, intr = self.params, self.intr
        leaf = p.downsample_leaf_size
        cell = default_cell_px(leaf, intr.fx)
        rgb, depth, occ = self.frame(1 / 15.0)
        args = (*self.to_dev(rgb, depth, occ), intr.fx, intr.fy, intr.cx, intr.cy,
                p.hsv_lower, p.hsv_upper, p.multi_color_dlo, cell, leaf)
        # Kernel P in the build the step runs (the exact route).
        k_out = cell_sums(*args, exact=True)
        p_out = cell_sums_plain(*args, exact=True)
        self.kernel_err["cell_sums"] = max(float((a - b).abs().max())
                                           for a, b in zip(k_out[:4], p_out[:4]))
        # The live frame has no split channel-cell and no pixel without depth,
        # so the plain sums' cloud is the one kernel C alone packs.
        if bool((p_out[4].counts != 0).any()) or bool((k_out[4].counts != 0).any()):
            self.failures.append("preprocess_live_frame_split")
        pcs = [compact_sums(k_out, p.max_points, leaf, p.candidate_cap(), True,
                            exact_frame(args, k_out)),
               compact_sums(p_out[:4], p.max_points, leaf, p.candidate_cap(), True)]
        kp = pcs[0].points[pcs[0].mask].cpu().numpy()
        pp = pcs[1].points[pcs[1].mask].cpu().numpy()
        log(f"  cell grid {tuple(k_out[3].shape)}, cloud {len(kp)} points (plain {len(pp)})")
        self.bound("preprocess_parity_count_delta", int(pcs[0].count) - int(pcs[1].count))
        d = np.linalg.norm(kp[:, None] - pp[None], axis=2).min(1)
        self.bound("preprocess_parity_p95_m", float(np.percentile(d, 95)))
        self.cloud = pcs[1]
        self.p_args = args
        k_out = k_out[:4]

        # Kernel C on the same cell sums: the live slots, then 16 slots per
        # channel so that the occupied cells overflow them and the thinning
        # fires. The explicit kept cells, and the derived mode (the thinning
        # in the launch) with and without the centroid division, each
        # against its plain version: every output bit-equal.
        mismatch, c_err = 0, 0.0
        for cap_per in (p.candidate_cap() // 8, 16):
            kept = kept_cells(k_out[3], cap_per)
            pairs = [(compact_channels(*k_out, kept, cap_per), compact_channels_plain(*k_out, kept, cap_per))]
            for div in (False, True):
                pairs.append((compact_occupied_channels(*k_out, cap_per, div),
                              compact_occupied_channels_plain(*k_out, cap_per, div)))
            for ck, cp in pairs:
                mismatch += sum(int((a != b).sum()) for a, b in zip(ck, cp))
                c_err = max(c_err, *(float((a.float() - b.float()).abs().max()) for a, b in zip(ck, cp)))
            occupied = int((k_out[3] > 0).sum(1).max())
            log(f"  compaction: {cap_per} slots per channel, {int(pairs[0][1][2].sum())} filled; "
                f"the fullest channel {occupied} occupied cells "
                f"({'thinned' if occupied > cap_per else 'no thinning'})")
        self.bound("compact_mismatch", mismatch)
        self.kernel_err["compact"] = c_err
        self.c_args = (*k_out, p.candidate_cap() // 8, True)

        # Parity over every u16 depth at the 8 mm leaf: one pixel per cell.
        side = 256
        dgrid = np.arange(65536, dtype=np.uint16).reshape(side, side)
        rgb1 = np.empty((side, side, 3), np.uint8)
        rgb1[:] = (30, 60, 200)
        occ1 = np.ones((side, side), np.uint8)
        a1 = (*self.to_dev(rgb1, dgrid, occ1), intr.fx, intr.fy, 128.5, 127.25,
              p.hsv_lower, p.hsv_upper, False, 1, leaf)
        cnt_k = cell_sums(*a1)[3]
        cnt_p = cell_sums_plain(*a1)[3]
        have = (cnt_k.sum(0) > 0).cpu().numpy()
        ch_k = cnt_k.argmax(0).cpu().numpy()
        ch_p = cnt_p.argmax(0).cpu().numpy()
        d_all = dgrid.reshape(-1).astype(np.int64)
        truth_z = (d_all // 8) & 1
        self.bound("parity_z_mismatch", int(((ch_k & 1) != truth_z)[have].sum() + (~have[1:]).sum()))
        self.bound("parity_xy_mismatch", int(((ch_k >> 1) != (ch_p >> 1))[have].sum()))

    def check_exact_route(self):
        """The exact route at the evaluation preset's 720p shape on a frame
        with 2 mm depth noise, 5% dropout and a box over the rope: kernel P's
        exact build against its plain version (on the CPU), and the cloud
        after kernels C and X and the snap against the plain route's. Keeps
        kernel X's inputs and least time for the timing phase."""
        np, torch = self.np, self.torch
        from trackdlo_tpu_torch import _build
        from trackdlo_tpu_torch.config import eval_params
        from trackdlo_tpu_torch.ops.preprocess import (
            cell_sums_plain, compact_occupied_channels, compact_sums, default_cell_px, exact_frame,
            preprocess_frame,
        )
        from trackdlo_tpu_torch.ops.preprocess_kernel import cell_sums, strip_grid

        p, intr = eval_params(), self.intr
        leaf, cap = p.downsample_leaf_size, p.candidate_cap()
        cell = default_cell_px(leaf, intr.fx)
        rgb, depth = self.render(self.rope, 0.3, intr, depth_noise_mm=2.0, seed=11, markers=12,
                                 dropout_frac=0.05)
        occ = np.ones((intr.height, intr.width), np.uint8)
        occ[200:520, 300:700] = 0
        dev_args = (*self.to_dev(rgb, depth, occ), intr.fx, intr.fy, intr.cx, intr.cy,
                    p.hsv_lower, p.hsv_upper, p.multi_color_dlo, cell, leaf)
        cpu_args = tuple(a.cpu() if torch.is_tensor(a) else a for a in dev_args)
        got = cell_sums(*dev_args, exact=True)
        ref = cell_sums_plain(*cpu_args, exact=True)
        self.bound("exact_p_count_mismatch", int((got[3].cpu() != ref[3]).sum()))
        self.bound("exact_p_sums_max", max(float((g.cpu() - r).abs().max())
                                           for g, r in zip(got[:3], ref[:3])))
        marked = ref[4].mask != 0
        split_mismatch = int((got[4].mask.cpu()[marked] != ref[4].mask[marked]).sum()) + int(
            (got[4].counts.sum(0).cpu() != ref[4].counts.sum(0)).sum())
        self.bound("exact_split_mismatch", split_mismatch)
        n_split, n_no_depth = (int(v) for v in ref[4].counts.sum(0))
        if n_split == 0 or n_no_depth == 0:
            self.failures.append("exact_frame_without_work")
        _build.settle_counts()
        before = dict(_build.launch_counts)
        pc = compact_sums(got, p.max_points, leaf, cap, True, exact_frame(dev_args, got))
        torch.cuda.synchronize()
        after = _build.settle_counts()
        work = {k.split(".")[1]: after[k] - before[k] for k in _build.SPLIT_WORK}
        want = preprocess_frame(*cpu_args[:11], p.max_points, leaf, cap, exact=True)
        g = pc.points[pc.mask].cpu().double()
        w = want.points[want.mask].double()
        self.bound("exact_cloud_count_delta", len(g) - len(w))
        d = torch.cdist(g, w) if len(g) == len(w) else None
        err = float("inf") if d is None else max(float(d.min(1).values.max()),
                                                  float(d.min(0).values.max()))
        self.bound("exact_cloud_max_m", err)
        self.kernel_err["split_cells"] = err
        log(f"  exact route: {n_split} split channel-cells, {n_no_depth} masked pixels without "
            f"depth; cloud {len(g)} voxels (plain {len(w)}); kernel X's work {work}")
        # Kernel X's least time on this frame, portbench/roofline_exact.py's
        # count: P's per-block counts read, the split cells' bytes and
        # pixels, the rows' slots scanned and the groups written.
        blocks = strip_grid(intr.height, intr.width, cell, "parity")[1]
        self.bounds_ms["split_cells"] = bound(
            blocks * 8 + work["cells"] + work["pixels"] * 6 + work["slots"] + work["groups"] * 17,
            work["pixels"] * OPS_PER_PIXEL)
        self.x_args = (exact_frame(dev_args, got),
                       compact_occupied_channels(*got[:4], cap // 8, True))

    def check_visibility(self):
        np, torch = self.np, self.torch
        from trackdlo_tpu_torch.ops.kernels import geodesic_coords
        from trackdlo_tpu_torch.ops.preprocess import compact_parity_channels
        from trackdlo_tpu_torch.ops.preprocess_kernel import cell_sums
        from trackdlo_tpu_torch.ops.visibility import compute_visibility
        from trackdlo_tpu_torch.ops.visibility_kernel import fused_visibility

        p, intr = self.params, self.intr
        y = torch.as_tensor(self.rope.nodes(0.0, p.M), dtype=torch.float32, device=self.dev)
        coord = geodesic_coords(y)
        proj = torch.as_tensor(np.array(intr.proj_matrix(), np.float32), device=self.dev)
        clouds = [self.cloud]
        rgb, depth, occ = self.frame(1 / 15.0, occlude=True)
        sums = cell_sums(*self.to_dev(rgb, depth, occ), *self.p_args[3:])
        clouds.append(compact_parity_channels(*sums, p.max_points, p.downsample_leaf_size,
                                              p.candidate_cap(), inputs_are_sums=True))
        idx_mis, dist, pmin, err = 0, 0.0, 0.0, 0.0
        for pc in clouds:
            a = (y, pc.points, pc.mask, proj, coord, intr.height, intr.width,
                 p.visibility_threshold, p.dlo_pixel_width, p.d_vis)
            vk, vp = fused_visibility(*a), compute_visibility(*a)
            for f in ("visible_mask", "extended_mask", "not_self_occluded", "vis_idx", "vis_ext_idx"):
                idx_mis += int((getattr(vk, f) != getattr(vp, f)).sum())
            idx_mis += int(vk.vis_count != vp.vis_count) + int(vk.vis_ext_count != vp.vis_ext_count)
            dist = max(dist, float((vk.shortest_node_pt_dists - vp.shortest_node_pt_dists).abs().max()))
            for f in ("point_min_sq_all", "point_min_sq_ext"):
                gk = getattr(vk, f).clamp(max=1.0)
                gp = getattr(vp, f).clamp(max=1.0)
                pmin = max(pmin, float((gk - gp).abs().max()))
            log(f"  visible {int(vp.vis_count)}, extended {int(vp.vis_ext_count)} of {p.M}")
        err = max(dist, pmin)
        self.bound("visibility_idx_mismatch", idx_mis)
        self.bound("visibility_dist_max_m", dist)
        self.bound("visibility_pointmin_max", pmin)
        self.kernel_err["visibility"] = err
        self.v_args = (y, clouds[0].points, clouds[0].mask, proj, coord, intr.height, intr.width,
                       p.visibility_threshold, p.dlo_pixel_width, p.d_vis)

    def check_walks(self):
        np, torch = self.np, self.torch
        from trackdlo_tpu_torch.ops.hopper_kernels import pursuit_walks, pursuit_walks_plain
        from trackdlo_tpu_torch.ops.kernels import geodesic_coords
        from trackdlo_tpu_torch.ops.priors import correspondence_priors, walk_inputs

        m = self.params.M
        y = torch.as_tensor(self.rope.nodes(0.0, m), dtype=torch.float32, device=self.dev)
        coord = geodesic_coords(y)
        moved = torch.as_tensor(self.rope.nodes(1 / 15.0, m), dtype=torch.float32, device=self.dev)
        cases = {
            "all_visible": list(range(m)),
            "mid_occluded": list(range(0, 15)) + list(range(30, m)),
            "tail_occluded": list(range(0, 35)),
            "head_occluded": list(range(10, m)),
            "both_ends_occluded": list(range(10, 35)),
        }
        mask_mis, pos_max = 0, 0.0
        streams = []
        for name, vis in cases.items():
            idx = torch.full((m,), m - 1, dtype=torch.int64, device=self.dev)
            idx[: len(vis)] = torch.as_tensor(vis, device=self.dev)
            cnt = torch.tensor(len(vis), device=self.dev)
            guides = torch.zeros_like(y)
            guides[: len(vis)] = moved[idx[: len(vis)]]
            streams.append((y, coord, guides, idx, cnt, idx, cnt))
            wi = walk_inputs(y, coord, guides, idx, cnt, idx, cnt)
            pk, vk = pursuit_walks(wi.guides, wi.seglens, wi.ints)
            pp, vp = pursuit_walks_plain(wi.guides, wi.seglens, wi.ints)
            mask_mis += int((vk != vp).sum())
            both = vk & vp
            if bool(both.any()):
                pos_max = max(pos_max, float((pk - pp).abs()[both].max()))
            log(f"  {name:20s} state {int(wi.state)}  valid nodes {int(vp.sum())}")
            self.w_args = (wi.guides, wi.seglens, wi.ints)
            self.walk_bits.update({f"{name}_{k}": v.cpu().numpy() for k, v in (
                ("guides", wi.guides), ("seglens", wi.seglens), ("ints", wi.ints), ("pos", pk),
                ("valid", vk))})
        self.bound("priors_mask_mismatch", mask_mis)
        self.bound("priors_pos_max_m", pos_max)
        self.kernel_err["walks"] = pos_max
        for k in ("guides", "seglens", "ints"):
            self.walk_bits[f"batch_{k}"] = np.concatenate([self.walk_bits[f"{name}_{k}"] for name in cases])
        batch = [torch.from_numpy(self.walk_bits[f"batch_{k}"]).to(self.dev) for k in ("guides", "seglens", "ints")]
        self.walk_bits.update(zip(("batch_pos", "batch_valid"),
                                  (v.cpu().numpy() for v in pursuit_walks(*batch))))
        self.check_walks_bits(list(cases) + ["batch"])
        # The five cases as the streams of one batch: their 4·5 walks in one
        # launch of W, against each stream's priors alone.
        batched = correspondence_priors(*(torch.stack(f) for f in zip(*streams)))
        diff = max(float((batched.prior_pos[b] - correspondence_priors(*f).prior_pos).abs().max())
                   for b, f in enumerate(streams))
        self.bound("priors_batched_vs_single_max_m", diff)

    def check_walks_bits(self, cases):
        """Kernel W on the saved inputs of the five cases and their 4·5-walk
        batch (tests/data/walks_bits.npz, saved from the previous design of
        the kernel): positions and masks bit for bit the saved ones."""
        np, torch = self.np, self.torch
        from trackdlo_tpu_torch.ops.hopper_kernels import pursuit_walks

        path = os.path.join(ROOT, "tests", "data", "walks_bits.npz")
        if not os.path.exists(path):
            self.failures.append("walks_bits_missing")
            return
        saved = np.load(path)
        mismatch = 0
        for name in cases:
            args = [torch.from_numpy(saved[f"{name}_{k}"]).to(self.dev) for k in ("guides", "seglens", "ints")]
            pos, valid = (v.cpu().numpy() for v in pursuit_walks(*args))
            mismatch += int((pos.view(np.int32) != saved[f"{name}_pos"].view(np.int32)).sum())
            mismatch += int((valid != saved[f"{name}_valid"]).sum())
        self.bound("walks_vs_saved_mismatch", mismatch)

    def check_em(self):
        torch = self.torch
        from trackdlo_tpu_torch.ops.cpd_lle import CpdParams, em_staging
        from trackdlo_tpu_torch.ops.hopper_kernels import fused_em_loop, fused_em_loop_plain

        p = self.params
        m = p.M
        nodes = torch.as_tensor(self.rope.nodes(0.0, m), dtype=torch.float32, device=self.dev)
        nm = torch.ones(m, dtype=torch.bool, device=self.dev)
        s2 = torch.tensor(0.001, device=self.dev)
        vc = torch.tensor(30, device=self.dev)
        base = dict(beta=p.beta, lam=p.lam, lle_weight=p.lle_weight, mu=p.mu, max_iter=3,
                    tol=0.0, include_lle=False, k_vis=p.k_vis,
                    visibility_threshold=p.visibility_threshold, use_visibility=True)
        cases = (
            ("em3_plain_max_m", {}, {}),
            ("em3_lle_max_m", {"include_lle": True}, {}),
            ("em3_priors_gate_max_m", {"use_priors": True, "alpha": p.alpha},
             {"prior_pos": nodes + 0.004,
              "prior_mask": torch.arange(m, device=self.dev) < 12}),
            ("em10_pallas_vs_xla_max_m", {"max_iter": 10}, {}),
        )
        err = 0.0
        for key, extra, kw in cases:
            st = em_staging(self.cloud.points, self.cloud.mask, nodes, nm, s2,
                            CpdParams(**{**base, **extra}), visible_count=vc, **kw)
            yk, sk = fused_em_loop(*st.args, **st.kwargs)
            yp, sp = fused_em_loop_plain(*st.args, **st.kwargs)
            e = float((yk - yp).abs().max())
            log(f"  iterations kernel {int(sk[1])} plain {int(sp[1])}, sigma2 {float(sk[0]):.6g} vs {float(sp[0]):.6g}")
            if int(sk[1]) != int(sp[1]):
                self.failures.append(f"{key}_iterations")
            self.bound(key, e)
            err = max(err, e)
        self.kernel_err["em_loop"] = err

    def check_prereg_frames(self, probe_lib):
        """ROADMAP §C fault 1: kernel E on the staged pre-registration inputs
        of four frames of this loop (tests/data/prereg_frames.npz, staged
        from the float64 oracle's state), its trips and the plain version's
        against the JAX package's B1 (interpreted on the CPU, trips saved
        beside the inputs); then frame 25 through the probe build of kernel
        E (perf/port_em_probes.py phases: every phase of 16 iterations, tol
        0, fed kernel E's own inputs, on this machine's CPU): each phase's
        relative error against float64, kernel E's and the plain float32
        route's, and the largest ratio of the two."""
        np, torch = self.np, self.torch
        import port_em_probes as probes
        from trackdlo_tpu_torch.ops.hopper_kernels import fused_em_loop, fused_em_loop_plain

        d = dict(np.load(os.path.join(ROOT, "tests", "data", "prereg_frames.npz")))
        worst, probe_mismatch = 0, 0
        trips = {}
        for i in probes.B1_FRAMES:
            kw = probes._frame_kwargs(d, i)
            args = [torch.from_numpy(d[f"f{i}_{k}"]).to(self.dev) for k in probes.B1_ARGS]
            kernel = int(fused_em_loop(*args, **kw)[1][1])
            plain = int(fused_em_loop_plain(*args, **kw)[1][1])
            b1 = int(d[f"f{i}_b1_trips"])
            trips[i] = {"kernel E": kernel, "plain": plain, "B1": b1, "oracle": int(d[f"f{i}_oracle_trips"])}
            worst = max(worst, abs(kernel - b1), abs(plain - b1))
            if i == 25:
                deep = dict(kw, tol=0.0, max_iter=probes.PROBE_ITERS)
                dump, _ = probes.run_probe(probe_lib, args, deep)
                probe_mismatch += int(probes.run_probe(probe_lib, args, kw)[1][1]) != kernel
                summary = probes.phase_summary(probes.phase_errors(d, i, dump, with_b1=False))
                ratio = max(r["kernel E / plain"] for r in summary.values())
                self.metrics["prereg_frame25_phases"] = summary
                for ph, r in summary.items():
                    log(f"  frame 25, {ph:17s} kernel E {r['kernel E']:.3g}, plain {r['plain']:.3g} "
                        f"(relative to float64, median of 16 iterations)")
            log(f"  frame {i}: trips {trips[i]}")
        self.metrics["prereg_frames_trips"] = trips
        self.bound("prereg_trips_vs_b1_max", worst)
        self.bound("prereg_probe_trips_mismatch", probe_mismatch)
        self.bound("prereg_phase_vs_plain_max_ratio", ratio)

    def check_gj(self):
        """Kernel G: the (8, 48, 48) SPD systems of perf/tpu_kernel_numerics.py
        (seed 0) against float64 and the plain version; one live
        pre-registration M-step system (the worst-conditioned iterate of the
        first frame's pass), kernel against plain, relative error reported;
        the system and both solutions go to chiprun_out/gj_prereg_system.npz
        (the CPU tests hold them against the JAX package's own solve)."""
        np, torch = self.np, self.torch
        from trackdlo_tpu_torch.ops.hopper_kernels import (
            gauss_jordan_solve_batched, gauss_jordan_solve_batched_plain,
        )

        rng = np.random.default_rng(0)
        a_np = rng.standard_normal((8, 48, 48)).astype(np.float32)
        a_np = a_np @ a_np.transpose(0, 2, 1) + 48 * np.eye(48, dtype=np.float32)
        b_np = rng.standard_normal((8, 48, 3)).astype(np.float32)
        w64 = np.linalg.solve(a_np.astype(np.float64), b_np.astype(np.float64))
        a, b = torch.from_numpy(a_np).to(self.dev), torch.from_numpy(b_np).to(self.dev)
        wk = gauss_jordan_solve_batched(a, b)
        wp = gauss_jordan_solve_batched_plain(a, b)
        wk_np, wp_np = wk.cpu().numpy(), wp.cpu().numpy()
        self.bound("lu_solve_vs_f64_max", float(np.abs(wp_np - w64).max()))
        self.bound("gj_solve_vs_f64_max", float(np.abs(wk_np - w64).max()))
        self.bound("gj_solve_vs_plain_max", float(np.abs(wk_np - wp_np).max()))
        self.kernel_err["gj_solve"] = self.metrics["gj_solve_vs_plain_max"]
        self.gj_spd = (torch.cat([a, a]), torch.cat([b, b]))  # (16, 48, 48) for the timing
        saved = np.load(os.path.join(ROOT, "tests", "data", "gj_prereg_system.npz"))
        self.bits["gj_spd16"] = gauss_jordan_solve_batched(*self.gj_spd).cpu().numpy()
        self.bits["gj_saved_live"] = gauss_jordan_solve_batched(
            *(torch.from_numpy(saved[k]).to(self.dev)[None] for k in ("a", "b")))[0].cpu().numpy()

        a_l, b_l = self.prereg_system()
        cond = float(np.linalg.cond(a_l.double().cpu().numpy()))
        wk = gauss_jordan_solve_batched(a_l[None], b_l[None])[0]
        wp = gauss_jordan_solve_batched_plain(a_l[None], b_l[None])[0]
        w64 = np.linalg.solve(a_l.double().cpu().numpy(), b_l.double().cpu().numpy())
        scale = float(np.abs(w64).max())
        self.metrics.update(
            gj_live_prereg_cond=cond,
            gj_live_prereg_kernel_vs_plain_rel=float((wk - wp).abs().max()) / float(wp.abs().max()),
            gj_live_prereg_kernel_vs_f64_rel=float(np.abs(wk.cpu().numpy() - w64).max()) / scale,
            gj_live_prereg_plain_vs_f64_rel=float(np.abs(wp.cpu().numpy() - w64).max()) / scale,
        )
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        np.savez(os.path.join(ROOT, "chiprun_out", "gj_prereg_system.npz"),
                 a=a_l.cpu().numpy(), b=b_l.cpu().numpy(), w_kernel=wk.cpu().numpy(),
                 w_plain=wp.cpu().numpy())
        log(f"  live pre-registration system: cond {cond:.3g}, kernel vs plain relative "
            f"{self.metrics['gj_live_prereg_kernel_vs_plain_rel']:.3g}; against float64: kernel "
            f"{self.metrics['gj_live_prereg_kernel_vs_f64_rel']:.3g}, plain "
            f"{self.metrics['gj_live_prereg_plain_vs_f64_rel']:.3g}")

    def prereg_system(self):
        """The pre-registration M-step system of the first live frame with
        the largest condition number over the pass's iterations."""
        np, torch = self.np, self.torch
        from trackdlo_tpu_torch.ops.cpd_lle import (
            CpdParams, em_iteration, em_staging, estep_scalars, mstep_system,
        )
        from trackdlo_tpu_torch.ops.hopper_kernels import (
            fused_estep_packed_batch, gauss_jordan_solve_batched,
        )
        from trackdlo_tpu_torch.ops.visibility_kernel import fused_visibility

        p, intr, m = self.params, self.intr, self.params.M
        y = torch.as_tensor(self.rope.nodes(0.0, m), dtype=torch.float32, device=self.dev)
        vis = fused_visibility(*self.v_args)
        nm = torch.arange(m, device=self.dev) < vis.vis_ext_count
        guides = torch.where(nm[:, None], y[vis.vis_ext_idx], 0.0)
        params = CpdParams(beta=p.beta_pre_proc, lam=p.lambda_pre_proc, lle_weight=p.lle_weight,
                           mu=p.mu, max_iter=p.max_iter, tol=p.tol, include_lle=True,
                           prune_radius=p.prune_radius,
                           visibility_threshold=p.visibility_threshold)
        st = em_staging(self.cloud.points[None], self.cloud.mask[None], guides[None], nm[None],
                        torch.tensor([p.sigma2_init], device=self.dev), params,
                        point_min_sq=vis.point_min_sq_ext[None])
        yb, s2 = st.args[1], st.args[0][:, 0]
        best = (-1.0, None)
        for _ in range(p.max_iter):
            scal = estep_scalars(st.args[0], s2, params)
            p1, px, _, _ = fused_estep_packed_batch(scal, yb, st.args[2], st.args[3],
                                                    torch.ones_like(st.args[3]), st.args[9],
                                                    st.args[10], two_phase=True)
            a, b = mstep_system(st, p1, px, s2, params)
            cond = float(np.linalg.cond(a[0].double().cpu().numpy()))
            if cond > best[0]:
                best = (cond, (a[0].clone(), b[0].clone()))
            t, s2, delta = em_iteration(st, yb, s2, params, fused_estep_packed_batch,
                                        lambda a, b, g, y0: gauss_jordan_solve_batched(a, b, g, y0)[1])
            yb = t
            if float(delta[0]) < p.tol:
                break
        return best[1]

    def batch_em_inputs(self, n_streams=N_STREAMS):
        """B streams of EM inputs at the live shapes: each stream's cloud from
        its own frame (odd streams occluded), its nodes, mixed visibility
        gates; streams 14 and 15 with 3 and 2 valid nodes (the anchor
        fallbacks' edge)."""
        torch = self.torch
        from trackdlo_tpu_torch.ops.preprocess import compact_parity_channels
        from trackdlo_tpu_torch.ops.preprocess_kernel import cell_sums

        p, m = self.params, self.params.M
        frames = [self.frame(1 / 15.0 + 0.01 * b, occlude=b % 2 == 1) for b in range(n_streams)]
        rgb, depth, occ = (torch.stack(f) for f in zip(*(self.to_dev(*f) for f in frames)))
        pc = compact_parity_channels(*cell_sums(rgb, depth, occ, *self.p_args[3:]), p.max_points,
                                     p.downsample_leaf_size, p.candidate_cap(), inputs_are_sums=True)
        y = torch.stack([torch.as_tensor(self.rope.nodes(0.01 * b, m), dtype=torch.float32)
                         for b in range(n_streams)]).to(self.dev)
        nm = torch.ones((n_streams, m), dtype=torch.bool, device=self.dev)
        if n_streams >= 16:
            nm[14, 3:] = False
            nm[15, 2:] = False
            y = torch.where(nm[..., None], y, 0.0)
        vc = torch.tensor([30 if b % 2 == 0 else m for b in range(n_streams)], device=self.dev)
        return pc, y, nm, vc

    def check_estep(self):
        """Kernel S against its plain version: 16 streams (B7) and each stream
        alone (B6), gates mixed, all off, and both phase modes."""
        torch = self.torch
        from trackdlo_tpu_torch.ops.cpd_lle import CpdParams, em_staging, estep_scalars
        from trackdlo_tpu_torch.ops.hopper_kernels import (
            fused_estep_packed, fused_estep_packed_batch, fused_estep_packed_batch_plain,
            fused_estep_packed_plain,
        )

        p = self.params
        pc, y, nm, vc = self.batch_em_inputs()
        params = CpdParams(beta=p.beta, lam=p.lam, lle_weight=p.lle_weight, mu=p.mu,
                           max_iter=3, tol=0.0, include_lle=False, k_vis=p.k_vis,
                           visibility_threshold=p.visibility_threshold, use_visibility=True)
        s2 = torch.linspace(5e-4, 2e-3, N_STREAMS, device=self.dev)
        st = em_staging(pc.points, pc.mask, y, nm, s2, params, visible_count=vc)
        scal = estep_scalars(st.args[0], s2, params)
        coord, nmf, x, xm = st.args[2], st.args[3], st.args[9], st.args[10]
        pv = torch.rand(nmf.shape, generator=torch.Generator().manual_seed(0)).to(self.dev) * nmf
        pv = pv / pv.sum(dim=1, keepdim=True)
        log(f"  gates on: {int((scal[:, 3] > 0).sum())} of {N_STREAMS} streams; points per stream "
            f"{[int(v) for v in st.n_count.tolist()]}")
        outside, short_mis, err = 0, 0, 0.0

        def compare(got, ref, defined):
            nonlocal outside, short_mis, err
            for g, r in zip(got[:3], ref[:3]):
                outside += int((~((g - r).abs() <= 1e-6 + 2e-4 * r.abs())).sum())
                err = max(err, float((g - r).abs().max()))
            short_mis += int((got[3] != ref[3]).sum()) if defined else 0

        for case, gate in (("mixed", None), ("all_off", 0.0)):
            sc = scal.clone()
            if gate is not None:
                sc[:, 3] = gate
            for two_phase in (True, False):
                args = (sc, y, coord, nmf, pv, x, xm)
                got = fused_estep_packed_batch(*args, two_phase=two_phase)
                ref = fused_estep_packed_batch_plain(*args, two_phase=two_phase)
                compare(got, ref, True)
                if not two_phase or gate is not None:
                    sentinel = bool((got[3] == 1e5).all())
                    if not sentinel:
                        self.failures.append(f"estep_sentinel_{case}")
                for b in (0, 1, 15):
                    one = tuple(a[b] for a in args)
                    compare(fused_estep_packed(*one, two_phase=two_phase),
                            fused_estep_packed_plain(*one, two_phase=two_phase), True)
                log(f"  {case:8s} two_phase={two_phase!s:5s}: outside tolerance so far {outside}, "
                    f"shortest_sq mismatches {short_mis}")
        self.bound("estep_outside_tol", outside)
        self.bound("estep_short_mismatch", short_mis)
        # One cluster per stream, shaped by n alone: each stream of the batch
        # gives the same bits launched alone (shortest_sq where the sweeps
        # agree: it runs for every stream when any stream's gate is on).
        mismatch = 0
        for two_phase in (True, False):
            args = (scal, y, coord, nmf, pv, x, xm)
            got = fused_estep_packed_batch(*args, two_phase=two_phase)
            for b in range(N_STREAMS):
                alone = fused_estep_packed(*(a[b] for a in args), two_phase=two_phase)
                mismatch += sum(int((got[k][b] != alone[k]).sum()) for k in range(3))
                if not two_phase or bool(scal[b, 3] > 0):
                    mismatch += int((got[3][b] != alone[3]).sum())
        self.bound("estep_batch_vs_alone_mismatch", mismatch)
        self.kernel_err["estep"] = self.kernel_err["estep_batch"] = err
        self.s_args = (scal, y, coord, nmf, pv, x, xm)
        self.s_n_valid = st.n_count

    def check_em_periter(self):
        """The per-iteration EM: 10 iterations (tol 0) of 4 copies of one
        stream through kernels S and G against kernel E on that stream, and
        3 iterations of 4 streams, kernels against plain versions."""
        torch = self.torch
        from trackdlo_tpu_torch.ops.cpd_lle import (
            CpdParams, cpd_lle, cpd_lle_batched, em_iteration, em_loop_lockstep, em_staging,
        )
        from trackdlo_tpu_torch.ops.hopper_kernels import (
            fused_estep_packed_batch, fused_estep_packed_batch_plain, gauss_jordan_solve_batched,
            gauss_jordan_solve_batched_plain,
        )

        p, m = self.params, self.params.M
        nodes = torch.as_tensor(self.rope.nodes(0.0, m), dtype=torch.float32, device=self.dev)
        nm = torch.ones(m, dtype=torch.bool, device=self.dev)
        base = dict(beta=p.beta, lam=p.lam, lle_weight=p.lle_weight, mu=p.mu, max_iter=10,
                    tol=0.0, include_lle=False, k_vis=p.k_vis,
                    visibility_threshold=p.visibility_threshold, use_visibility=True)
        vc = torch.tensor(30, device=self.dev)
        s2 = torch.tensor(0.001, device=self.dev)
        single = cpd_lle(self.cloud.points, self.cloud.mask, nodes, nm, s2, CpdParams(**base),
                         visible_count=vc)
        rep = lambda a: a.unsqueeze(0).expand(4, *a.shape).contiguous()
        batched = cpd_lle_batched(rep(self.cloud.points), rep(self.cloud.mask), rep(nodes), rep(nm),
                                  rep(s2), CpdParams(**base), visible_count=rep(vc))
        self.bound("em10_batched_vs_single_max_m", float((batched.y - single.y[None]).abs().max()))

        pc, y, _, vcs = self.batch_em_inputs(4)
        nm4 = torch.ones((4, m), dtype=torch.bool, device=self.dev)
        s2_4 = torch.full((4,), 0.001, device=self.dev)
        short = dict(base, max_iter=3)
        for key, extra, kw in (
            ("em3_periter_plain_max_m", {}, {}),
            ("em3_periter_lle_max_m", {"include_lle": True}, {}),
            ("em3_periter_priors_gate_max_m", {"use_priors": True, "alpha": p.alpha},
             {"prior_pos": y + 0.004, "prior_mask": (torch.arange(m, device=self.dev) < 12).expand(4, m)}),
        ):
            params = CpdParams(**{**short, **extra})
            st = em_staging(pc.points, pc.mask, y, nm4, s2_4, params, visible_count=vcs, **kw)
            def loop(estep, solve, st=st, params=params):
                update = lambda a, b, g, y0: solve(a, b, g, y0)[1]  # the solve and T = Y0 + G W
                return em_loop_lockstep(
                    st, params, lambda y, s2: em_iteration(st, y, s2, params, estep, update))

            yk, sk, ik, _ = loop(fused_estep_packed_batch, gauss_jordan_solve_batched)
            yp, sp, ip, _ = loop(fused_estep_packed_batch_plain, gauss_jordan_solve_batched_plain)
            if not torch.equal(ik, ip):
                self.failures.append(f"{key}_iterations")
            self.bound(key, float((yk - yp).abs().max()))

    def check_preprocess_single(self):
        """Kernel P's one-channel modes on the occluded live frame against
        the plain version: the coarse two-stage path (with the floor votes)
        and the cells-only path (no leaf); then the clouds each set of sums
        gives."""
        np = self.np
        from trackdlo_tpu_torch.ops.preprocess import cell_sums_plain, compact_sums
        from trackdlo_tpu_torch.ops.preprocess_kernel import cell_sums

        p = self.params
        rgb, depth, occ = self.frame(1 / 15.0, occlude=True)
        frame = self.to_dev(rgb, depth, occ)
        self.p1_args = {}
        for mode, leaf, cloud_key, p95_bound in (
            ("votes", p.downsample_leaf_size, "preprocess_kernel", "preprocess_kernel_vs_xla_p95_m"),
            ("cells", None, "preprocess_cells", "preprocess_cells_p95_m"),
        ):
            args = (*frame, *self.p_args[3:-1], leaf)
            kw = dict(parity_split=False, with_votes=leaf is not None)
            k_out = cell_sums(*args, **kw)
            p_out = cell_sums_plain(*args, **kw)
            exact = range(3, len(p_out))  # the count and the floor votes
            self.bound(f"cell_sums_{mode}_mismatch", sum(int((k_out[i] != p_out[i]).sum()) for i in exact))
            self.kernel_err[f"cell_sums_{mode}"] = max(float((a - b).abs().max())
                                                       for a, b in zip(k_out, p_out))
            pcs = [compact_sums(o, p.max_points, leaf, p.candidate_cap(), False) for o in (k_out, p_out)]
            kp = pcs[0].points[pcs[0].mask].cpu().numpy()
            pp = pcs[1].points[pcs[1].mask].cpu().numpy()
            log(f"  one channel, {mode}: {len(p_out)} sums of {tuple(p_out[3].shape)} cells, "
                f"{int((p_out[3] > 0).sum())} occupied; cloud {len(kp)} points (plain {len(pp)})")
            self.bound(f"{cloud_key}_count_delta", int(pcs[0].count) - int(pcs[1].count))
            d = np.linalg.norm(kp[:, None] - pp[None], axis=2).min(1) if len(kp) else np.zeros(1)
            self.bound(p95_bound, float(np.percentile(d, 95)))
            self.p1_args[mode] = (args, kw)

    def check_fused(self):
        """Kernel F: three iterations (tol 0) against its plain version in
        the plain, LLE and priors+gate configurations of check_em; the fused
        route against the plain per-iteration route (the JAX package's XLA
        iteration, plain solve) over 10 iterations in the main-pass
        configuration; a live tolerance run through F (its launches counted);
        4 copies of that stream through the batched route."""
        torch = self.torch
        import dataclasses

        from trackdlo_tpu_torch.ops.cpd_lle import (
            CpdParams, EmStaging, cpd_lle, cpd_lle_batched, em_iteration_xla, em_loop_lockstep,
            em_staging, fused_iteration,
        )
        from trackdlo_tpu_torch.ops.hopper_kernels import (
            fused_em_iteration_plain, gauss_jordan_solve_batched_plain,
        )

        p, m = self.params, self.params.M
        nodes = torch.as_tensor(self.rope.nodes(0.0, m), dtype=torch.float32, device=self.dev)
        nm = torch.ones(m, dtype=torch.bool, device=self.dev)
        s2 = torch.tensor(0.001, device=self.dev)
        vc = torch.tensor(30, device=self.dev)
        x, xm = self.cloud.points, self.cloud.mask
        base = dict(beta=p.beta, lam=p.lam, lle_weight=p.lle_weight, mu=p.mu, max_iter=3,
                    tol=0.0, include_lle=False, k_vis=p.k_vis,
                    visibility_threshold=p.visibility_threshold, use_visibility=True,
                    use_fused_mstep=True)
        one = lambda a: a[None]
        err = 0.0
        for key, extra, kw in (
            ("em3_fusedmstep_plain_max_m", {}, {}),
            ("em3_fusedmstep_lle_max_m", {"include_lle": True}, {}),
            ("em3_fusedmstep_priors_gate_max_m", {"use_priors": True, "alpha": p.alpha},
             {"prior_pos": nodes + 0.004, "prior_mask": torch.arange(m, device=self.dev) < 12}),
        ):
            params = CpdParams(**{**base, **extra})
            st = em_staging(one(x), one(xm), one(nodes), one(nm), one(s2), params,
                            visible_count=one(vc), **{k: one(v) for k, v in kw.items()})
            yk, _, ik, _ = em_loop_lockstep(st, params, lambda y, s: fused_iteration(st, y, s, params))
            yp, _, ip, _ = em_loop_lockstep(
                st, params, lambda y, s: fused_iteration(st, y, s, params, fused_em_iteration_plain))
            if not torch.equal(ik, ip):
                self.failures.append(f"{key}_iterations")
            e = float((yk - yp).abs().max())
            self.bound(key, e)
            err = max(err, e)
        self.kernel_err["em_iteration"] = err

        main = CpdParams(**{**base, "max_iter": 10})
        fused = cpd_lle(x, xm, nodes, nm, s2, main, visible_count=vc)
        plain = dataclasses.replace(main, use_fused_mstep=False)
        st = em_staging(one(x), one(xm), one(nodes), one(nm), one(s2), plain, visible_count=one(vc))
        y_xla, _, it_xla, _ = em_loop_lockstep(
            st, plain, lambda y, s: em_iteration_xla(
                st, y, s, plain, lambda a, b, g, y0: y0 + g @ gauss_jordan_solve_batched_plain(a, b)))
        log(f"  10 iterations: fused route {int(fused.iterations)}, plain route {int(it_xla[0])}")
        self.bound("em10_fusedmstep_vs_xla_max_m", float((fused.y - y_xla[0]).abs().max()))
        self.f_stage = (st, main)

        live = dataclasses.replace(main, max_iter=p.max_iter, tol=p.tol)
        res = self.count_path("fused", lambda: cpd_lle(x, xm, nodes, nm, s2, live, visible_count=vc))
        iters = int(res.iterations)
        log(f"  live tolerance through F: {iters} iterations, converged {bool(res.converged)}")
        self.bound("fused_live_launch_mismatch", self.path_launches["fused"]["em_iteration"] - iters)
        st_live = em_staging(one(x), one(xm), one(nodes), one(nm), one(s2), live, visible_count=one(vc))
        _, _, it_plain, _ = em_loop_lockstep(
            st_live, live, lambda y, s: fused_iteration(st_live, y, s, live, fused_em_iteration_plain))
        self.bound("fused_live_trips_vs_plain", iters - int(it_plain[0]))
        y0l, s2l = st_live.args[1], st_live.args[0][:, 0]
        extra, other = self.extra_device_ops(lambda: fused_iteration(st_live, y0l, s2l, live), 20,
                                             "em_iteration", "em_iter_kernel")
        if other:
            log(f"  device ops of a route iteration besides kernel F: {other}")
        self.bound("fused_iteration_extra_device_ops", extra)
        self.fused_vs_parent_design()
        rep = lambda a: a.unsqueeze(0).expand(4, *a.shape).contiguous()
        batched = self.count_path("fused_batched", lambda: cpd_lle_batched(
            rep(x), rep(xm), rep(nodes), rep(nm), rep(s2), live, visible_count=rep(vc)))
        # F on the first stream of the batch's own staging: the staging of a
        # lone stream can differ in the last bit of its geodesic coordinates
        # (torch scans one row with another algorithm than a batch of rows),
        # so F and the lockstep loop are held to bit-equality on the same
        # inputs, and the distance from the lone stream is reported.
        st4 = em_staging(rep(x), rep(xm), rep(nodes), rep(nm), rep(s2), live, visible_count=rep(vc))
        st1 = EmStaging(tuple(a[:1] for a in st4.args), st4.kwargs, st4.n_count[:1], st4.sigma2[:1])
        y1, s1, it1, _ = em_loop_lockstep(st1, live, lambda y, s: fused_iteration(st1, y, s, live))
        self.bound("fused_batched_vs_single_max", max(float((batched.y - y1).abs().max()),
                                                      float((batched.sigma2 - s1).abs().max())))
        self.metrics["fused_batched_vs_lone_stream_max_m"] = float((batched.y - res.y[None]).abs().max())
        log(f"  F batched against the lone stream's cpd_lle: "
            f"{self.metrics['fused_batched_vs_lone_stream_max_m']!r} m")
        trips = int(batched.iterations.max())
        self.bound("fused_batched_launch_mismatch",
                   abs(self.path_launches["fused_batched"]["em_iteration"] - trips)
                   + int((batched.iterations != it1).sum()))

    def fused_vs_parent_design(self):
        """Kernel F against the outputs of its design before the cluster
        E-step on the same inputs (tests/data/em_iter_bits.npz, written by
        perf/em_iter_bits.py on that design): the largest distances, recorded."""
        np, torch = self.np, self.torch
        import em_iter_bits

        from trackdlo_tpu_torch.ops.hopper_kernels import fused_em_iteration

        dt, ds, dd = 0.0, 0.0, 0.0
        saved = em_iter_bits.load(os.path.join(ROOT, "tests", "data", "em_iter_bits.npz"))
        for case, (fargs, kw, (t0, s0, d0)) in saved.items():
            t, s2, delta = (o.cpu().numpy() for o in fused_em_iteration(
                *(torch.from_numpy(a).to(self.dev) for a in fargs), **kw))
            dt = max(dt, float(np.abs(t - t0).max()))
            ds = max(ds, float(np.abs(s2 - s0).max()))
            dd = max(dd, float(np.abs(delta - d0).max()))
        self.metrics.update(fused_vs_parent_design_t_max_m=dt, fused_vs_parent_design_sigma2_max=ds,
                            fused_vs_parent_design_delta_max=dd)
        log(f"  F against the previous design's saved outputs ({len(saved)} cases): t {dt!r} m, "
            f"sigma2 {ds!r}, delta {dd!r}")

    def check_nearest(self):
        """Kernel N against its plain version at the main pass's shapes: the
        live nodes against each half of the phase-3 cloud (the shard a rank
        of two holds), every node valid or some masked; a shard with no
        valid point; 4 streams' first shards in one launch; each case with
        bool masks and with float32 masks (the route's, from em_staging).
        Bit-equal; one device op per call with either."""
        torch = self.torch
        from trackdlo_tpu_torch.ops.hopper_kernels import nearest_point_sq, nearest_point_sq_plain

        m = self.params.M
        y = torch.as_tensor(self.rope.nodes(0.0, m), dtype=torch.float32, device=self.dev)
        x, xm = self.cloud.points, self.cloud.mask
        half = x.shape[0] // 2
        nm_all = torch.ones(m, dtype=torch.bool, device=self.dev)
        nm_part = torch.arange(m, device=self.dev) < 30
        nm_part[3] = False
        cases = [(y, nm, x[sl], xm[sl]) for sl in (slice(0, half), slice(half, None))
                 for nm in (nm_all, nm_part)]
        cases.append((y, nm_all, x[:half], torch.zeros_like(xm[:half])))
        pc4, y4, _, _ = self.batch_em_inputs(4)
        nm4 = torch.stack([nm_all, nm_part, nm_all, nm_part])
        cases.append((y4, nm4, pc4.points[:, :half], pc4.mask[:, :half]))
        f32 = lambda c: (c[0], c[1].to(torch.float32), c[2], c[3].to(torch.float32))
        mismatch, err = 0, 0.0
        for c in cases + [f32(c) for c in cases]:
            got, ref = nearest_point_sq(*c), nearest_point_sq_plain(*c)
            mismatch += int((got != ref).sum())
            err = max(err, float((got - ref).abs().max()))
        log(f"  shards of {half} points ({int(xm[:half].sum())} and {int(xm[half:].sum())} valid), "
            f"{m} nodes; 4 streams of {half}; bool and float32 masks")
        self.bound("nearest_mismatch", mismatch)
        self.kernel_err["nearest"] = err
        self.n_args = cases[0]
        self.n_args_route = f32(cases[0])
        extra = 0.0
        for a in (self.n_args, self.n_args_route):
            e, other = self.extra_device_ops(lambda a=a: nearest_point_sq(*a), 20, "nearest",
                                             "nearest_kernel")
            if other:
                log(f"  device ops of a nearest_point_sq call besides kernel N: {other}")
            extra = max(extra, e)
        self.bound("nearest_extra_device_ops", extra)

    def check_loop_flag(self):
        """Kernel L alone against its plain version: random done flags and
        trip counts of 1 to 80 streams and max_iter 0 to 11 (its inputs at
        b16/c8 are 8 streams, at b8 8). Kept for the timing phase: the b16
        frame set's shape."""
        np, torch = self.np, self.torch
        from trackdlo_tpu_torch.ops.graph_loop import loop_flag, loop_flag_plain

        rng = np.random.default_rng(0)
        mismatch = 0
        for _ in range(200):
            b = int(rng.integers(1, 81))
            done = torch.from_numpy(rng.random(b) < 0.8).to(self.dev)
            it = torch.from_numpy(rng.integers(0, 12, b).astype(np.int32)).to(self.dev)
            mi = int(rng.integers(0, 12))
            mismatch += int(int(loop_flag(done, it, mi)) != int(loop_flag_plain(done, it, mi)))
        self.bound("loop_flag_mismatch", mismatch)
        self.kernel_err["loop_flag"] = float(mismatch)
        self.l_args = (torch.zeros(COHORT, dtype=torch.bool, device=self.dev),
                       torch.full((COHORT,), 3, dtype=torch.int32, device=self.dev),
                       self.params.max_iter)

    # -- phase 4: closed loop against the oracle -----------------------------
    def closed_loop(self):
        np, torch = self.np, self.torch
        from trackdlo_tpu_torch.oracle.pipeline import init_state as oracle_init, step_frame
        from trackdlo_tpu_torch.models.trackdlo import Tracker

        p, intr, m = self.params, self.intr, self.params.M
        tracker = Tracker(p, intr, device=self.dev)
        state = tracker.init_from_nodes(self.rope.nodes(0.0, m))
        o_state = oracle_init(self.rope.nodes(0.0, m), p)
        frames = [self.frame(i / 15.0, occlude=10 <= i <= 20) for i in range(1, self.frames + 1)]
        ys, states, iters, guide_iters, npts = [], [], [], [], []

        outs = []

        def run():
            nonlocal state
            for rgb, depth, occ in frames:
                state, out = tracker.step(state, rgb, depth, occ)
                outs.append(out)
                ys.append(state.y)
                states.append(out.occlusion_state)
                iters.append(out.iterations)
                guide_iters.append(out.guide_iterations)
                npts.append(out.n_points)

        self.warm(tracker, state, frames[0])
        self.count_path("single", run)
        self.launches = self.path_launches["single"]
        for k, want in EXPECTED_LAUNCHES.items():
            want = want * self.frames // 30
            if self.launches.get(k) != want:
                self.failures.append(f"launches_{k}")
                log(f"  launches {k}: {self.launches.get(k)} != {want}  FAIL")
        self.graph_checks(tracker, frames, outs)
        dev_mm, gt_mm, oracle_trips = [], [], []
        for i, (rgb, depth, occ) in enumerate(frames, start=1):
            with oracle_trip_counts() as trips:
                o_state, _, _ = step_frame(o_state, rgb, depth, p, intr, occ)
            # The oracle skips the pre-registration pass when no node is
            # visible: that pass then counts 0 trips.
            oracle_trips.append(trips if len(trips) == 2 else [0, *trips])
            y = ys[i - 1].cpu().numpy()
            if not np.isfinite(y).all() or y.shape != (m, 3):
                self.failures.append("closed_loop_finite")
            dev_mm.append(1000 * float(np.linalg.norm(y - o_state.y, axis=1).mean()))
            gt_mm.append(1000 * float(np.linalg.norm(y - self.rope.nodes(i / 15.0, m), axis=1).mean()))
        seen = sorted({int(s) for s in torch.stack(states).cpu().tolist()})
        self.metrics.update(
            closed_loop_per_frame_mm=dev_mm, closed_loop_max_mm=max(dev_mm),
            gt_mean_mm=statistics.fmean(gt_mm), occlusion_states_seen=seen,
            main_em_iterations=[int(v) for v in torch.stack(iters).cpu().tolist()],
            n_points=[int(v) for v in torch.stack(npts).cpu().tolist()],
        )
        log(f"  occlusion states seen: {seen}")
        log(f"  points per frame: {self.metrics['n_points']}")
        log(f"  main-EM iterations: {self.metrics['main_em_iterations']}")
        log(f"  per-frame deviation from the oracle (mm): {[round(v, 4) for v in dev_mm]}")
        self.bound("closed_loop_mean_mm", statistics.fmean(dev_mm))
        if len(seen) < 2:
            self.failures.append("occlusion_states")
        port_trips = np.stack([torch.stack(guide_iters).cpu().numpy(),
                               torch.stack(iters).cpu().numpy()], axis=1)
        self.trip_count_gate(port_trips, np.array(oracle_trips))
        self.bits.update(loop_y=state.y.cpu().numpy(), loop_trips=port_trips)
        self.tracker, self.state, self.frames_data = tracker, state, frames
        # The loop's clouds padded to max_points (a points step's static
        # cloud), for kernel F's graph.
        cap = p.max_points
        self.loop_clouds = []
        for out in outs:
            pts = torch.zeros((cap, 3), dtype=torch.float32, device=self.dev)
            msk = torch.zeros(cap, dtype=torch.bool, device=self.dev)
            n = out.points.shape[0]
            pts[:n], msk[:n] = out.points, out.points_mask
            self.loop_clouds.append((pts, msk))

    def reference_cells(self, n_occl: int = 45, n_trip: int = 40, n_eval: int = 30,
                        n_native: int = 10):
        """The reference's own cells, each through the compiled steps:

        - 45 frames, columns 500:800 occluded on frames 10-20
          (perf/parity_decomposition.py --occlude): ``Tracker.step`` against
          the float64 oracle (``full``), and the oracle's own clouds through
          ``Tracker.step_from_points`` (``same_pts``, its CUDA graph; the
          bound on the first 30 frames);
        - the native library's clouds (``native.preprocess_frame``) of the
          first 10 frames through the compiled points step and eagerly, bit
          for bit;
        - perf/trip_counts.py's 40 unoccluded frames: each pass's mean trips
          against the oracle's;
        - the evaluation profile (``eval_params()`` as shipped, 30
          unoccluded frames, one graph): deviation and trips, beside the
          JAX package's CPU run of the same frames."""
        np, torch = self.np, self.torch
        from trackdlo_tpu_torch import native
        from trackdlo_tpu_torch.config import eval_params
        from trackdlo_tpu_torch.models.trackdlo import Tracker, build_points_step_fn
        from trackdlo_tpu_torch.oracle.pipeline import init_state as oracle_init, step_frame

        p, intr = self.params, self.intr
        dev_mm = lambda y, ref: 1000 * float(np.linalg.norm(y.cpu().numpy() - ref, axis=1).mean())

        m = p.M
        tracker = Tracker(p, intr, device=self.dev)
        s_full = s_pts = tracker.init_from_nodes(self.rope.nodes(0.0, m))
        o_state = oracle_init(self.rope.nodes(0.0, m), p)
        full_mm, pts_mm, frames = [], [], []
        self.oracle_clouds = []
        for i in range(1, n_occl + 1):
            rgb, depth, occ = self.frame(i / 15.0, occlude=10 <= i <= 20)
            frames.append((rgb, depth, occ))
            o_state, _, aux = step_frame(o_state, rgb, depth, p, intr, occ)
            s_full, _ = tracker.step(s_full, rgb, depth, occ)
            s_pts, _ = tracker.step_from_points(s_pts, aux["points"])
            self.oracle_clouds.append(aux["points"])
            full_mm.append(dev_mm(s_full.y, o_state.y))
            pts_mm.append(dev_mm(s_pts.y, o_state.y))
        self.metrics.update(occl45_per_frame_mm=full_mm, same_pts_per_frame_mm=pts_mm,
                            same_pts_45_mean_mm=statistics.fmean(pts_mm))
        log(f"  45 occluded frames: same_pts over 45 frames {statistics.fmean(pts_mm):.4f} mm")
        self.bound("occl45_closed_loop_mean_mm", statistics.fmean(full_mm))
        self.bound("same_pts_mean_mm", statistics.fmean(pts_mm[:30]))

        cap = p.max_points
        graph_t = Tracker(p, intr, device=self.dev)
        eager = build_points_step_fn(p, intr, jit=False, device=self.dev)
        sg = se = graph_t.init_from_nodes(self.rope.nodes(0.0, m))
        mismatch, sizes = 0, []
        for rgb, depth, occ in frames[:n_native]:
            cloud = native.preprocess_frame(rgb, depth, p, intr, occlusion_mask=occ, max_points=cap)
            sizes.append(len(cloud))
            sg, og = graph_t.step_from_points(sg, cloud)
            pts = np.zeros((cap, 3), np.float32)
            msk = np.zeros(cap, bool)
            pts[:len(cloud)], msk[:len(cloud)] = cloud, True
            se, oe = eager(se, pts, msk)
            mismatch += self.outputs_mismatch(og, oe)
        self.metrics["native_cloud_sizes"] = sizes
        log(f"  native clouds: {sizes} points")
        self.bound("native_graph_vs_eager_mismatch", mismatch + self.outputs_mismatch(sg, se))

        trip_t = Tracker(p, intr, device=self.dev)
        st = trip_t.init_from_nodes(self.rope.nodes(0.0, m))
        o_state = oracle_init(self.rope.nodes(0.0, m), p)
        port, oracle = [], []
        for i in range(1, n_trip + 1):
            rgb, depth = self.render(self.rope, i / 15.0, intr)
            with oracle_trip_counts() as trips:
                o_state, _, _ = step_frame(o_state, rgb, depth, p, intr)
            oracle.append(trips if len(trips) == 2 else [0, *trips])
            st, out = trip_t.step(st, rgb, depth)
            port.append([int(out.guide_iterations), int(out.iterations)])
        port_a, oracle_a = np.array(port), np.array(oracle)
        means = {f"{who}_{name}": float(a[:, k].mean()) for who, a in (("port", port_a), ("oracle", oracle_a))
                 for k, name in enumerate(("pre", "main"))}
        self.metrics.update(trip40=means, trip40_port=port, trip40_oracle=oracle)
        log(f"  40 unoccluded frames, mean trips: {means}")
        self.bound("trip40_pre_mean_delta", means["port_pre"] - means["oracle_pre"])
        self.bound("trip40_main_mean_delta", means["port_main"] - means["oracle_main"])

        ep = eval_params()
        me = ep.M
        eval_t = Tracker(ep, intr, device=self.dev)
        st = eval_t.init_from_nodes(self.rope.nodes(0.0, me))
        o_state = oracle_init(self.rope.nodes(0.0, me), ep)
        mm, port, oracle = [], [], []
        for i in range(1, n_eval + 1):
            rgb, depth = self.render(self.rope, i / 15.0, intr)
            with oracle_trip_counts() as trips:
                o_state, _, _ = step_frame(o_state, rgb, depth, ep, intr)
            oracle.append(trips if len(trips) == 2 else [0, *trips])
            st, out = eval_t.step(st, rgb, depth)
            port.append([int(out.guide_iterations), int(out.iterations)])
            mm.append(dev_mm(st.y, o_state.y))
        port_a, oracle_a = np.array(port), np.array(oracle)
        with open(os.path.join(ROOT, "perf", "eval_profile_jax_cpu.json")) as f:
            jax_cpu = json.load(f)
        rec = {"mean_mm": statistics.fmean(mm), "max_mm": max(mm), "per_frame_mm": mm,
               "port_pre_trips_mean": float(port_a[:, 0].mean()),
               "port_main_trips_mean": float(port_a[:, 1].mean()),
               "oracle_pre_trips_mean": float(oracle_a[:, 0].mean()),
               "oracle_main_trips_mean": float(oracle_a[:, 1].mean()),
               "jax_cpu_mean_mm": jax_cpu["mean_mm"],
               "jax_cpu_main_trips_mean": jax_cpu["jax_main_trips_mean"]}
        self.metrics["eval_profile"] = rec
        log(f"  eval profile, 30 frames: {rec['mean_mm']:.4f} mm from the oracle (JAX CPU build "
            f"{rec['jax_cpu_mean_mm']:.4f} mm); trips pre {rec['port_pre_trips_mean']:.3f} / main "
            f"{rec['port_main_trips_mean']:.3f}, oracle {rec['oracle_pre_trips_mean']:.3f} / "
            f"{rec['oracle_main_trips_mean']:.3f}, JAX main {rec['jax_cpu_main_trips_mean']:.3f}")
        if jax_cpu["mean_mm"] <= BOUNDS["eval_closed_loop_mean_mm"]:
            self.bound("eval_closed_loop_mean_mm", rec["mean_mm"])

    def trip_count_gate(self, port, oracle):
        """The EM trip counts of the closed loop, (frames, 2) arrays of the
        pre-registration and main passes' iterations: mean, p95 and max of
        each pass for the port and the float64 oracle; each pass's mean held
        within one iteration of the oracle's."""
        np = self.np
        summary = {}
        for k, name in enumerate(("pre", "main")):
            for who, a in (("port", port[:, k]), ("oracle", oracle[:, k])):
                summary[f"{who}_{name}"] = {"mean": float(a.mean()),
                                            "p95": float(np.percentile(a, 95)), "max": int(a.max())}
            log(f"  EM trips, {name} pass: port {summary[f'port_{name}']}, oracle "
                f"{summary[f'oracle_{name}']}")
        self.metrics.update(em_trips=summary, em_trips_port=port.tolist(),
                            em_trips_oracle=oracle.tolist())
        for name in ("pre", "main"):
            self.bound(f"trip_{name}_mean_delta",
                       summary[f"port_{name}"]["mean"] - summary[f"oracle_{name}"]["mean"])

    def graph_checks(self, tracker, frames, graph_outs):
        """The compiled step (``Tracker.step``, one CUDA graph replayed a
        frame) against the eager step (``build_step_fn(jit=False)``) over
        the closed loop's frames: every output field bit for bit, and the
        eager run's launch counts those of the replays; then two streams
        interleaved through the one compiled step, each bit for bit its run
        alone."""
        torch = self.torch
        from trackdlo_tpu_torch.models.trackdlo import build_step_fn

        m = self.params.M
        eager = build_step_fn(self.params, self.intr, jit=False, device=self.dev)
        state = tracker.init_from_nodes(self.rope.nodes(0.0, m))
        eager_outs = []

        def run():
            nonlocal state
            for rgb, depth, occ in frames:
                occ_t = torch.from_numpy(occ != 0).to(self.dev)
                state, out = eager(state, rgb, depth, occ_t)
                eager_outs.append(out)

        self.count_path("single_eager", run)
        self.bound("graph_vs_eager_mismatch",
                   sum(self.outputs_mismatch(a, b) for a, b in zip(graph_outs, eager_outs)))
        self.bound("graph_launch_mismatch", sum(
            abs(self.path_launches["single"][k] - v) for k, v in self.path_launches["single_eager"].items()))
        n = 10
        starts = [tracker.init_from_nodes(self.rope.nodes(t, m)) for t in (0.0, 0.02)]
        alone, mixed = [[], []], [[], []]
        for k, s in enumerate(starts):
            for f in frames[:n]:
                s, o = tracker.step(s, *f)
                alone[k].append((s, o))
        cur = list(starts)
        for f in frames[:n]:
            for k in (0, 1):
                cur[k], o = tracker.step(cur[k], *f)
                mixed[k].append((cur[k], o))
        self.bound("graph_interleaved_vs_alone_mismatch", sum(
            self.outputs_mismatch(a[0], b[0]) + self.outputs_mismatch(a[1], b[1])
            for k in (0, 1) for a, b in zip(alone[k], mixed[k])))
        if torch.equal(cur[0].y, cur[1].y):
            self.failures.append("graph_interleaved_streams_identical")
        # The launches of a replay, measured: each kernel's spans in a
        # profiler trace of replays, against what the capture recorded
        # (CompiledStep.counts, added at every replay). A trace can lose
        # spans but never invent one, so each kernel of the path must show
        # at least one span a replay and at most its recorded count.
        recorded = tracker._step.counts
        traced = self.traced_launches(lambda: tracker.step(starts[0], *frames[0]), n)
        self.metrics["graph_replay_launches"] = {"recorded": recorded, "traced_per_replay": traced}
        log(f"  launches a replay: recorded {dict((k, v) for k, v in recorded.items() if v)}, "
            f"traced {traced}")
        for k, v in recorded.items():
            if not (v == 0 == traced.get(k, 0) or 1 <= traced.get(k, 0) <= v):
                self.failures.append(f"graph_traced_launches_{k}")
                log(f"  {k}: {traced.get(k, 0)} spans a replay, recorded {v}  FAIL")

    def traced_launches(self, fn, n):
        """Each kernel's launches per call of ``fn`` as a torch.profiler trace
        sees them: its device spans (by the kernel's name, KERNEL_FUNCS) over
        ``n`` calls that follow ``n`` untimed ones in the same trace
        (device_ms's rule), the fullest of three traces kept."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile, record_function

        fn()
        torch.cuda.synchronize()
        best: dict = {}
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
                with record_function("chip_smoke_timed"):
                    for _ in range(n):
                        fn()
                    torch.cuda.synchronize()
            events = prof.events()
            start = min(e.time_range.start for e in events if e.name == "chip_smoke_timed")
            names = [e.name for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                     and e.time_range.start >= start]
            got = {k: sum(func in nm for nm in names) / n for k, func in KERNEL_FUNCS.items()}
            if sum(got.values()) > sum(best.values()):
                best = got
        return best

    def node_counts(self):
        """ROADMAP §C faults 3 and 4: ``num_of_nodes`` 49, 64 and 100, past
        the 48 nodes of the kernels' narrow builds (V's 64, W's 65), and 129,
        192, 256, 512 and 1,024, past their wide builds (W's 129), over the
        first :data:`NODE_COUNTS` frames of phase 4: every kernel of the path
        launched on every frame (the wide and the node-unbounded builds, no
        plain version), the compiled step and the eager step bit for bit with
        the same launches, and the builds against their plain versions
        (:meth:`wide_kernels`, also at 128 nodes). The closed loop against
        the float64 oracle at 49 nodes. Past it the live profile loses the
        rope in the oracle itself and the oracle's LLE raises once fewer than
        7 guide nodes are visible (PERF.md, fault 3), so there the port is
        held to the JAX package on the CPU (tests/test_torch_node_range.py),
        and the long-cable cell (:meth:`cable_cell`) holds 256 nodes to the
        oracle; the distance from the rendered rope is recorded."""
        np, torch = self.np, self.torch
        import dataclasses

        from trackdlo_tpu_torch.models.trackdlo import Tracker, build_step_fn
        from trackdlo_tpu_torch.oracle.pipeline import init_state as oracle_init, step_frame

        for m, n_frames in NODE_COUNTS.items():
            frames = self.frames_data[:n_frames]
            want = {k: v * n_frames // 30 for k, v in EXPECTED_LAUNCHES.items()}
            p = dataclasses.replace(self.params, num_of_nodes=m)
            tracker = Tracker(p, self.intr, device=self.dev)
            eager = build_step_fn(p, self.intr, jit=False, device=self.dev)
            nodes = self.rope.nodes(0.0, m)
            self.warm(tracker, tracker.init_from_nodes(nodes), frames[0])
            runs = {}
            for name, step in (("graph", tracker.step),
                               ("eager", lambda s, r, d, o: eager(
                                   s, r, d, torch.from_numpy(o != 0).to(self.dev)))):
                state, outs, ms = tracker.init_from_nodes(nodes), [], []

                def run(state=state, outs=outs, step=step, ms=ms):
                    for f in frames:
                        start = torch.cuda.Event(enable_timing=True)
                        end = torch.cuda.Event(enable_timing=True)
                        start.record()
                        state, out = step(state, *f)
                        end.record()
                        end.synchronize()
                        ms.append(start.elapsed_time(end))
                        outs.append(out)

                self.count_path(f"nodes{m}_{name}", run)
                runs[name] = outs
                self.times[f"nodes{m}_step_{name}"] = {
                    "median_ms": statistics.median(ms), "p90_ms": float(np.percentile(ms, 90)),
                    "calls": len(ms)}
            key = f"nodes{m}"
            for name in ("graph", "eager"):
                if launches_only(self.path_launches[f"{key}_{name}"]) != want:
                    self.failures.append(f"{key}_{name}_launches")
                    log(f"  {key} {name}: launches {self.path_launches[f'{key}_{name}']} != {want}  FAIL")
            self.bound(f"{key}_graph_vs_eager_mismatch", sum(
                self.outputs_mismatch(a, b) for a, b in zip(runs["graph"], runs["eager"])))
            ys = [out.y.cpu().numpy() for out in runs["graph"]]
            if any(not np.isfinite(y).all() or y.shape != (m, 3) for y in ys):
                self.failures.append(f"{key}_finite")
            gt_mm = [1000 * float(np.linalg.norm(y - self.rope.nodes(i / 15.0, m), axis=1).mean())
                     for i, y in enumerate(ys, start=1)]
            self.metrics[f"{key}_gt_per_frame_mm"] = gt_mm
            self.metrics[f"{key}_iterations"] = [
                [int(o.guide_iterations), int(o.iterations)] for o in runs["graph"]]
            self.metrics[f"{key}_visible_nodes"] = [int(o.visible_mask.sum()) for o in runs["graph"]]
            log(f"  {key}: visible nodes {self.metrics[f'{key}_visible_nodes']}; from the rope (mm) "
                f"{[round(v, 2) for v in gt_mm]}; step median graph "
                f"{self.times[f'{key}_step_graph']['median_ms']:.3f} ms, eager "
                f"{self.times[f'{key}_step_eager']['median_ms']:.3f} ms")
            self.wide_kernels(m, runs["graph"][0])
            if m == 100:
                self.wide_kernels(128, runs["graph"][0])
            if m == 49:
                o_state = oracle_init(nodes, p)
                dev_mm = []
                for (rgb, depth, occ), y in zip(frames, ys):
                    o_state, _, _ = step_frame(o_state, rgb, depth, p, self.intr, occ)
                    dev_mm.append(1000 * float(np.linalg.norm(y - o_state.y, axis=1).mean()))
                self.metrics[f"{key}_per_frame_mm"] = dev_mm
                log(f"  {key}: per-frame deviation from the oracle (mm) {[round(v, 4) for v in dev_mm]}")
                self.bound(f"{key}_closed_loop_mean_mm", statistics.fmean(dev_mm))

    def row_kernels(self):
        """ROADMAP §C fault 5: kernels E, S and F over the clouds of
        :data:`ROW_CELLS`, past 16,384 rows (a CTA then takes its rows a tile
        of 2048 at a time), against their plain versions at phase 3's bounds
        (:meth:`wide_kernels`' E, S and F): half the rows valid, points along
        the rope at t = 1/15 with 2 mm of noise, from a seed."""
        from types import SimpleNamespace

        np, torch = self.np, self.torch
        for n, m in ROW_CELLS:
            rng = np.random.default_rng(n + m)
            curve = self.rope.curve(1 / 15.0)
            x = curve[rng.integers(0, len(curve), n)] + rng.normal(0, 0.002, (n, 3))
            cloud = SimpleNamespace(points=torch.from_numpy(x.astype(np.float32)).to(self.dev),
                                    points_mask=torch.from_numpy(rng.random(n) < 0.5).to(self.dev))
            self.wide_kernels(m, cloud, key=f"rows{n}_nodes{m}",
                              only=("em_loop", "estep_batch", "em_iteration"))

    def cable_cell(self, n_frames: int = 10):
        """The long-cable cell: ``num_of_nodes`` 256 on a 1.6 m cable 1.2 m
        from the 720p camera, drawn 3 px thick, the painter's width 8 px
        (node spacing ~4.8 px, over half of it, so visibility keeps the
        nodes; the float64 oracle tracks it within ~1.4 mm of the rendered
        cable on the CPU, PERF.md §4). ``n_frames`` unoccluded frames through
        the compiled step and the eager step (bit for bit, every kernel of
        the path launched on every frame: the node-unbounded builds), the
        closed loop against the oracle, and the compiled step's time."""
        np, torch = self.np, self.torch
        import dataclasses

        from trackdlo_tpu_torch.io.sequence import SyntheticRope
        from trackdlo_tpu_torch.models.trackdlo import Tracker, build_step_fn
        from trackdlo_tpu_torch.oracle.pipeline import init_state as oracle_init, step_frame

        m, key = 256, "cable256"
        rope = SyntheticRope(length=1.6, depth=1.2)
        p = dataclasses.replace(self.params, num_of_nodes=m, dlo_pixel_width=8)
        occ = np.ones((self.intr.height, self.intr.width), np.uint8) * 255
        frames = [(*self.render(rope, i / 15.0, self.intr, rope_pixel_radius=3), occ)
                  for i in range(1, n_frames + 1)]
        nodes = rope.nodes(0.0, m)
        tracker = Tracker(p, self.intr, device=self.dev)
        eager = build_step_fn(p, self.intr, jit=False, device=self.dev)
        self.warm(tracker, tracker.init_from_nodes(nodes), frames[0])
        want = {k: v * n_frames // 30 for k, v in EXPECTED_LAUNCHES.items()}
        runs = {}
        for name, step in (("graph", tracker.step),
                           ("eager", lambda s, r, d, o: eager(
                               s, r, d, torch.from_numpy(o != 0).to(self.dev)))):
            outs = []

            def run(state=tracker.init_from_nodes(nodes), outs=outs, step=step):
                for f in frames:
                    state, out = step(state, *f)
                    outs.append(out)

            self.count_path(f"{key}_{name}", run)
            runs[name] = outs
            if launches_only(self.path_launches[f"{key}_{name}"]) != want:
                self.failures.append(f"{key}_{name}_launches")
                log(f"  {key} {name}: launches {self.path_launches[f'{key}_{name}']} != {want}  FAIL")
        self.bound(f"{key}_graph_vs_eager_mismatch", sum(
            self.outputs_mismatch(a, b) for a, b in zip(runs["graph"], runs["eager"])))
        ys = [out.y.cpu().numpy() for out in runs["graph"]]
        if any(not np.isfinite(y).all() for y in ys):
            self.failures.append(f"{key}_finite")
        o_state = oracle_init(nodes, p)
        dev_mm, gt_mm, oracle_gt_mm = [], [], []
        for i, ((rgb, depth, o), y) in enumerate(zip(frames, ys), start=1):
            o_state, _, _ = step_frame(o_state, rgb, depth, p, self.intr, o)
            gt = rope.nodes(i / 15.0, m)
            dev_mm.append(1000 * float(np.linalg.norm(y - o_state.y, axis=1).mean()))
            gt_mm.append(1000 * float(np.linalg.norm(y - gt, axis=1).mean()))
            oracle_gt_mm.append(1000 * float(np.linalg.norm(o_state.y - gt, axis=1).mean()))
        self.metrics.update({f"{key}_per_frame_mm": dev_mm, f"{key}_gt_per_frame_mm": gt_mm,
                             f"{key}_oracle_gt_per_frame_mm": oracle_gt_mm,
                             f"{key}_visible_nodes": [int(o.visible_mask.sum())
                                                      for o in runs["graph"]],
                             f"{key}_iterations": [[int(o.guide_iterations), int(o.iterations)]
                                                   for o in runs["graph"]]})
        log(f"  {key}: visible nodes {self.metrics[f'{key}_visible_nodes']}; from the oracle (mm) "
            f"{[round(v, 4) for v in dev_mm]}; the oracle from the cable (mm) "
            f"{[round(v, 2) for v in oracle_gt_mm]}")
        self.bound(f"{key}_closed_loop_mean_mm", statistics.fmean(dev_mm))
        holder = {"s": tracker.init_from_nodes(nodes)}

        def step(rgb, depth, o):
            holder["s"], _ = tracker.step(holder["s"], rgb, depth, o)

        rec = self.step_times(f"{key}_step", step, frames, 2 * n_frames)
        log(f"  {key}: Tracker.step (one CUDA graph) median {rec['median_ms']:.3f} ms "
            f"(p90 {rec['p90_ms']:.3f})")

    def wide_kernels(self, m: int, out, key: str | None = None, only=None):
        """The kernels' wide builds (m > 48; V past 64, W past 65) and
        node-unbounded builds (past 128; W past 129) against their plain
        versions on the same card inputs, on ``m`` nodes along the rope and
        the cloud of ``out`` (a step's outputs, or anything with ``points``
        and ``points_mask``), at phase 3's bounds: E after 3 iterations with
        LLE and after 10 in the main-pass configuration with the gate on (the
        same trips); V; W; S for 4 streams (two gated, both phase modes); G on
        the 4 streams' M-step systems and on SPD systems against float64; F
        after 3 iterations; N bit for bit. ``only`` names the launch counters
        of the kernels to hold (all by default); the fields are named
        ``{key}_...`` (``nodes{m}`` by default)."""
        torch = self.torch
        from trackdlo_tpu_torch.ops.cpd_lle import (
            CpdParams, em_loop_lockstep, em_staging, estep_scalars, fused_iteration, mstep_system,
        )
        from trackdlo_tpu_torch.ops.hopper_kernels import (
            fused_em_iteration_plain, fused_em_loop, fused_em_loop_plain,
        )

        p, dev = self.params, self.dev
        key = key or f"nodes{m}"
        want = lambda name: only is None or name in only
        x, xm = out.points, out.points_mask
        nodes = torch.as_tensor(self.rope.nodes(0.0, m), dtype=torch.float32, device=dev)
        nm = torch.ones(m, dtype=torch.bool, device=dev)
        base = dict(beta=p.beta, lam=p.lam, lle_weight=p.lle_weight, mu=p.mu, max_iter=3,
                    tol=0.0, include_lle=False, k_vis=p.k_vis,
                    visibility_threshold=p.visibility_threshold, use_visibility=True)
        calls = self.wide_calls.setdefault(key, {})  # (kernel, plain) pairs for the timing phase
        # Each wide call's least time on the card, by kernel_bounds' rules.
        wb = self.wide_bounds.setdefault(key, {})
        # E
        for name, extra in (("em3_lle", {"include_lle": True}), ("em10", {"max_iter": 10})):
            if not want("em_loop"):
                break
            st = em_staging(x, xm, nodes, nm, torch.tensor(0.001, device=dev),
                            CpdParams(**{**base, **extra}),
                            visible_count=torch.tensor(2 * m // 3, device=dev))
            yk, sk = fused_em_loop(*st.args, **st.kwargs)
            yp, sp = fused_em_loop_plain(*st.args, **st.kwargs)
            # The float64 witness: the plain version on the same inputs in
            # float64, and both float32 runs' distances from it.
            y64, _ = fused_em_loop_plain(*(a.double() for a in st.args), **st.kwargs)
            self.metrics[f"{key}_{name}_vs_f64_m"] = {
                "kernel": float((yk.double() - y64).abs().max()),
                "plain": float((yp.double() - y64).abs().max())}
            if name == "em10":
                calls["em_loop"] = (lambda st=st: fused_em_loop(*st.args, **st.kwargs),
                                    lambda st=st: fused_em_loop_plain(*st.args, **st.kwargs))
                n_e, nv = x.shape[0], int(st.n_count)
                wb["em_loop"] = bound(n_e * 16 + 3 * m * m * 4 + 6 * m * 12 + 16 + m * 12 + 16,
                                      int(sk[1]) * ((OPS_SWEEP_PAIR + OPS_ESTEP_PAIR) * m * nv
                                                    + em_mstep_ops(m)))
            if int(sk[1]) != int(sp[1]):
                self.failures.append(f"{key}_{name}_iterations")
            self.bound(f"{key}_{name}_max_m", float((yk - yp).abs().max()))
        # V and W
        if want("visibility"):
            self.wide_visibility_walks(m, nodes, x, xm, key, calls, wb)
        # S, G and F on 4 streams of the cloud, nodes along the rope
        bsz = 4
        yb = torch.stack([torch.as_tensor(self.rope.nodes(0.01 * b, m), dtype=torch.float32)
                          for b in range(bsz)]).to(dev)
        nmb = torch.ones((bsz, m), dtype=torch.bool, device=dev)
        nmb[3, m // 2:] = False
        yb = torch.where(nmb[..., None], yb, 0.0)
        vcb = torch.tensor([m // 2, m, m // 2, m], device=dev)
        s2b = torch.linspace(5e-4, 2e-3, bsz, device=dev)
        params = CpdParams(**base)
        st = em_staging(x.expand(bsz, -1, -1), xm.expand(bsz, -1), yb, nmb, s2b, params,
                        visible_count=vcb)
        scal = estep_scalars(st.args[0], s2b, params)
        coord, nmf, xs, xms = st.args[2], st.args[3], st.args[9], st.args[10]
        if want("estep_batch"):
            p1, px = self.wide_estep(m, st, scal, yb, coord, nmf, xs, xms, key, calls, wb)
        if want("gj_solve"):
            a_sys, b_sys = mstep_system(st, p1, px, s2b, params)
            self.wide_gj(m, a_sys, b_sys, key, calls, wb)
        if want("em_iteration"):
            fparams = CpdParams(**{**base, "include_lle": True, "use_fused_mstep": True})
            stf = em_staging(x[None], xm[None], nodes[None], nm[None],
                             torch.tensor([0.001], device=dev), fparams,
                             visible_count=torch.tensor([2 * m // 3], device=dev))
            y1, s1 = stf.args[1], stf.args[0][:, 0]
            n_f, nv_f = stf.args[9].shape[1], int(stf.n_count[0])
            sweep_f = OPS_SWEEP_PAIR if bool(stf.args[0][0, 3] > 0) else 0
            wb["em_iteration"] = bound(
                20 + m * 12 * 2 + m * 4 * 2 + 3 * m * m * 4 + 2 * m * 12 + n_f * 16 + m * 12 + 8,
                (sweep_f + OPS_ESTEP_PAIR) * m * nv_f + onehot_mstep_ops(m))
            calls["em_iteration"] = (
                lambda: fused_iteration(stf, y1, s1, fparams),
                lambda: fused_iteration(stf, y1, s1, fparams, fused_em_iteration_plain))
            yk, _, ik, _ = em_loop_lockstep(stf, fparams,
                                            lambda y, s: fused_iteration(stf, y, s, fparams))
            yp, _, ip, _ = em_loop_lockstep(
                stf, fparams,
                lambda y, s: fused_iteration(stf, y, s, fparams, fused_em_iteration_plain))
            if not torch.equal(ik, ip):
                self.failures.append(f"{key}_em3_fusedmstep_iterations")
            self.bound(f"{key}_em3_fusedmstep_max_m", float((yk - yp).abs().max()))
        if want("nearest"):
            self.wide_nearest(m, nodes, nm, x, xm, yb, nmb, xs, xms, key, calls, wb)

    def wide_visibility_walks(self, m, nodes, x, xm, key, calls, wb):
        """:meth:`wide_kernels`' V and W."""
        torch, np, p, dev = self.torch, self.np, self.params, self.dev
        from trackdlo_tpu_torch.ops import priors as tp
        from trackdlo_tpu_torch.ops.hopper_kernels import pursuit_walks, pursuit_walks_plain
        from trackdlo_tpu_torch.ops.kernels import geodesic_coords
        from trackdlo_tpu_torch.ops.visibility import compute_visibility
        from trackdlo_tpu_torch.ops.visibility_kernel import fused_visibility

        intr = self.intr
        proj = torch.as_tensor(np.array(intr.proj_matrix(), np.float32), device=dev)
        v_args = (nodes, x, xm, proj, geodesic_coords(nodes), intr.height, intr.width,
                  p.visibility_threshold, p.dlo_pixel_width, p.d_vis)
        vk, vp = fused_visibility(*v_args), compute_visibility(*v_args)
        calls["visibility"] = (lambda: fused_visibility(*v_args), lambda: compute_visibility(*v_args))
        wb["visibility"] = bound(x.shape[0] * 21 + m * 32 + 48,
                                 2 * OPS_SWEEP_PAIR * m * int(xm.sum()) + 20 * m * m)
        idx = sum(int((getattr(vk, f) != getattr(vp, f)).sum()) for f in (
            "vis_idx", "vis_ext_idx", "vis_count", "vis_ext_count", "visible_mask",
            "extended_mask", "not_self_occluded"))
        self.bound(f"{key}_visibility_idx_mismatch", idx)
        self.bound(f"{key}_visibility_max_m", max(
            float((getattr(vk, f).clamp(max=1.0) - getattr(vp, f).clamp(max=1.0)).abs().max())
            for f in ("shortest_node_pt_dists", "point_min_sq_all", "point_min_sq_ext")))
        # W
        wi = tp.walk_inputs(nodes, geodesic_coords(nodes), nodes + 0.002, vk.vis_ext_idx,
                            vk.vis_ext_count, vk.vis_idx, vk.vis_count)
        w_args = (wi.guides, wi.seglens, wi.ints, tp._EPS_BETWEEN)
        calls["walks"] = (lambda: pursuit_walks(*w_args), lambda: pursuit_walks_plain(*w_args))
        nw, mw = wi.guides.shape[:2]
        wb["walks"] = bound(nw * (mw * 12 + (mw - 1) * 4 + 20 + mw * 13),
                            nw * (mw - 1) * (mw - 1) * OPS_WALK_STEP_SEG)
        pk, mk = pursuit_walks(*w_args)
        pp, mp = pursuit_walks_plain(*w_args)
        self.bound(f"{key}_walks_mask_mismatch", int((mk != mp).sum()))
        self.bound(f"{key}_walks_max_m", float(torch.where(mp[..., None], (pk - pp).abs(), 0.0).max()))

    def wide_estep(self, m, st, scal, yb, coord, nmf, xs, xms, key, calls, wb):
        """:meth:`wide_kernels`' S: both phase modes on 4 streams; returns
        the plain two-phase P1 and PX (G's systems)."""
        torch, dev = self.torch, self.dev
        from trackdlo_tpu_torch.ops.hopper_kernels import (
            fused_estep_packed_batch, fused_estep_packed_batch_plain,
        )

        bsz = yb.shape[0]
        pv = torch.rand(nmf.shape, generator=torch.Generator().manual_seed(0)).to(dev) * nmf
        pv = pv / pv.sum(dim=1, keepdim=True)
        outside, short_mis = 0, 0
        s_args = (scal, yb, coord, nmf, pv, xs, xms)
        calls["estep_batch"] = (lambda: fused_estep_packed_batch(*s_args, two_phase=True),
                                lambda: fused_estep_packed_batch_plain(*s_args, two_phase=True))
        sweep = OPS_SWEEP_PAIR if bool((scal[:, 3] > 0).any()) else 0
        wb["estep_batch"] = bound(bsz * (32 + xs.shape[1] * 16 + m * 12 * 2 + m * 4 * 5 + 8),
                                  sum((sweep + OPS_ESTEP_PAIR) * m * int(v) for v in st.n_count))
        for two_phase in (True, False):
            got = fused_estep_packed_batch(*s_args, two_phase=two_phase)
            ref = fused_estep_packed_batch_plain(*s_args, two_phase=two_phase)
            for g, r in zip(got[:3], ref[:3]):
                outside += int((~((g - r).abs() <= 1e-6 + 2e-4 * r.abs())).sum())
            short_mis += int((got[3] != ref[3]).sum())
            if two_phase:
                p1, px = ref[0], ref[1]
        self.bound(f"{key}_estep_outside_tol", outside)
        self.bound(f"{key}_estep_short_mismatch", short_mis)
        return p1, px

    def wide_gj(self, m, a_sys, b_sys, key, calls, wb):
        """:meth:`wide_kernels`' G: on the M-step systems against its plain
        version (recorded) and on 8 SPD systems against float64."""
        np, torch, dev = self.np, self.torch, self.dev
        from trackdlo_tpu_torch.ops.hopper_kernels import (
            gauss_jordan_solve_batched, gauss_jordan_solve_batched_plain,
        )

        bsz = a_sys.shape[0]
        calls["gj_solve"] = (lambda: gauss_jordan_solve_batched(a_sys, b_sys),
                             lambda: gauss_jordan_solve_batched_plain(a_sys, b_sys),
                             lambda: torch.linalg.solve(a_sys, b_sys))
        wb["gj_solve"] = bound(bsz * (m * m + 2 * m * 3) * 4, bsz * gj_solve_ops(m))
        wk = gauss_jordan_solve_batched(a_sys, b_sys)
        wp = gauss_jordan_solve_batched_plain(a_sys, b_sys)
        self.metrics[f"{key}_gj_mstep_vs_plain_rel"] = rel = (
            float((wk - wp).abs().max()) / float(wp.abs().max()))
        log(f"  {key}: G on the M-step systems, kernel vs plain relative {rel:.3g}")
        a_np, b_np = spd_systems(m)
        w64 = np.linalg.solve(a_np.astype(np.float64), b_np.astype(np.float64))
        wk = gauss_jordan_solve_batched(torch.from_numpy(a_np).to(dev), torch.from_numpy(b_np).to(dev))
        wp = gauss_jordan_solve_batched_plain(torch.from_numpy(a_np).to(dev),
                                              torch.from_numpy(b_np).to(dev))
        self.metrics[f"{key}_gj_spd_plain_vs_f64_max"] = float(np.abs(wp.cpu().numpy() - w64).max())
        self.bound(f"{key}_gj_spd_vs_f64_max", float(np.abs(wk.cpu().numpy() - w64).max()))

    def wide_nearest(self, m, nodes, nm, x, xm, yb, nmb, xs, xms, key, calls, wb):
        """:meth:`wide_kernels`' N: one shard, the other half with a part of
        the nodes masked, and 4 streams, bit for bit."""
        torch, dev = self.torch, self.dev
        from trackdlo_tpu_torch.ops.hopper_kernels import nearest_point_sq, nearest_point_sq_plain

        half = x.shape[0] // 2
        nm_part = torch.arange(m, device=dev) < 2 * m // 3
        mismatch = 0
        n_args = (nodes, nm, x[:half], xm[:half])
        calls["nearest"] = (lambda: nearest_point_sq(*n_args), lambda: nearest_point_sq_plain(*n_args))
        wb["nearest"] = bound(sum(t.numel() * t.element_size() for t in n_args) + m * 4,
                              OPS_SWEEP_PAIR * int(nm.sum()) * int(xm[:half].sum()))
        for c in (n_args, (nodes, nm_part, x[half:], xm[half:]),
                  (yb, nmb, xs[:, :half], xms[:, :half])):
            mismatch += int((nearest_point_sq(*c) != nearest_point_sq_plain(*c)).sum())
        self.bound(f"{key}_nearest_mismatch", mismatch)

    def server(self, n_frames: int = 10):
        """The TCP service on the card (``io.net.TrackerServer``, port 0):
        two clients at once, ``n_frames`` each (the first initialises the
        stream), every reply bit for bit a direct ``Tracker.step`` of the
        same frames on the card."""
        np = self.np
        from trackdlo_tpu_torch.io.net import TrackerClient, TrackerServer
        from trackdlo_tpu_torch.models.trackdlo import Tracker

        streams = {
            "a": [f for f in self.frames_data[:n_frames]],
            "b": [self.frame(i / 15.0 + 0.02) for i in range(n_frames)],
        }
        srv = TrackerServer(self.params, self.intr, host="127.0.0.1", port=0, device=self.dev)
        host, port = srv.start()
        replies, errors = {}, []

        def client(name):
            try:
                with TrackerClient(host, port) as cli:
                    replies[name] = [cli.track(*f) for f in streams[name]]
            except Exception as e:  # reported below as a failure
                errors.append(repr(e))

        try:
            threads = [threading.Thread(target=client, args=(k,)) for k in streams]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            alive = any(t.is_alive() for t in threads)
        finally:
            srv.shutdown()
        if alive or errors:
            self.failures.append("server_clients")
            log(f"  server: clients alive {alive}, errors {errors}  FAIL")
            return
        tracker = Tracker(self.params, self.intr, device=self.dev)
        mismatch = 0
        for name, frames in streams.items():
            state = tracker.init_from_frame(frames[0][0], frames[0][1])
            want = [(state.y, state.sigma2, None)]
            for f in frames[1:]:
                state, out = tracker.step(state, *f)
                want.append((out.y, out.sigma2, out))
            for got, (y, s2, out) in zip(replies[name], want, strict=True):
                same = (np.array_equal(got["y"], y.cpu().numpy())
                        and np.float32(got["sigma2"]) == np.float32(s2.item()))
                if out is not None:
                    same = same and (got["iterations"] == int(out.iterations)
                                     and got["occlusion_state"] == int(out.occlusion_state)
                                     and got["converged"] == bool(out.converged)
                                     and np.array_equal(got["visible"], out.visible_mask.cpu().numpy()))
                mismatch += not same
        self.metrics["server_iterations"] = {k: [r["iterations"] for r in v] for k, v in replies.items()}
        self.bound("server_vs_direct_mismatch", mismatch)

    def gltp(self, n_frames: int = 10):
        """``GltpTracker`` on the card (its step one CUDA graph) over the
        first ``n_frames`` frames of phase 4, against the same tracker's
        run on this machine's CPU."""
        np = self.np
        from trackdlo_tpu_torch.models.gltp import GltpTracker

        frames = self.frames_data[:n_frames]
        nodes = self.rope.nodes(0.0, self.params.M)
        card = GltpTracker(self.params, self.intr, device=self.dev)
        cpu = GltpTracker(self.params, self.intr, device="cpu")
        self.warm(card, card.init_from_nodes(nodes), frames[0])
        ys, iters = {}, {}

        def run(tr, key):
            state, ys[key], iters[key] = tr.init_from_nodes(nodes), [], []
            for f in frames:
                state, res = tr.step(state, *f)
                ys[key].append(state.y.cpu().numpy())
                iters[key].append(int(res.iterations))

        self.count_path("gltp", lambda: run(card, "card"))
        run(cpu, "cpu")
        if self.path_launches["gltp"]["em_loop"] != n_frames:
            self.failures.append("gltp_launches")
        dev_mm = [1000 * float(np.linalg.norm(a - b, axis=1).mean())
                  for a, b in zip(ys["card"], ys["cpu"])]
        self.metrics.update(gltp_per_frame_mm=dev_mm, gltp_iterations=iters)
        log(f"  GLTP card against CPU, per frame (mm): {[round(v, 4) for v in dev_mm]}; "
            f"iterations {iters}")
        self.bound("gltp_card_vs_cpu_mean_mm", statistics.fmean(dev_mm))

    def profile_loop(self, name: str, change: dict, n_frames: int, key: str, tripwire=None):
        """``Tracker.step`` with ``change`` to the live profile over the
        first ``n_frames`` frames of phase 4, its launches counted; held
        against the float64 oracle fed the port's own clouds, with the
        oracle on its own preprocessing reported beside it."""
        np, torch = self.np, self.torch
        import dataclasses

        from trackdlo_tpu_torch.models.trackdlo import Tracker
        from trackdlo_tpu_torch.oracle.pipeline import init_state as oracle_init, step_frame

        p = dataclasses.replace(self.params, **change)
        intr, m = self.intr, p.M
        tracker = Tracker(p, intr, device=self.dev)
        state = tracker.init_from_nodes(self.rope.nodes(0.0, m))
        frames = self.frames_data[:n_frames]
        ys, clouds = [], []

        def run():
            nonlocal state
            for rgb, depth, occ in frames:
                state, out = tracker.step(state, rgb, depth, occ)
                ys.append(state.y)
                clouds.append(out.points[out.points_mask])

        self.warm(tracker, state, frames[0])
        self.count_path(name, run)
        got = self.path_launches[name]
        want = {k: v * n_frames for k, v in COARSE_LAUNCHES.items()}
        want[f"cell_sums_{'votes' if p.exact_voxels else 'cells'}"] = n_frames
        for k, v in want.items():
            if got[k] != v:
                self.failures.append(f"{name}_launches_{k}")
                log(f"  launches {k}: {got[k]} != {v}  FAIL")
        o_port = oracle_init(self.rope.nodes(0.0, m), p)
        o_own = oracle_init(self.rope.nodes(0.0, m), p)
        port_mm, own_mm, npts = [], [], []
        for (rgb, depth, occ), y, cloud in zip(frames, ys, clouds):
            pts = cloud.cpu().numpy()
            o_port, _, _ = step_frame(o_port, rgb, depth, p, intr, occ, points=pts)
            o_own, _, _ = step_frame(o_own, rgb, depth, p, intr, occ)
            y = y.cpu().numpy()
            if not np.isfinite(y).all() or y.shape != (m, 3):
                self.failures.append(f"{name}_finite")
            port_mm.append(1000 * float(np.linalg.norm(y - o_port.y, axis=1).mean()))
            own_mm.append(1000 * float(np.linalg.norm(y - o_own.y, axis=1).mean()))
            npts.append(len(pts))
        self.metrics.update({f"{name}_per_frame_mm": port_mm,
                             f"{name}_vs_oracle_own_per_frame_mm": own_mm,
                             f"{name}_n_points": npts})
        log(f"  {name}: points per frame {npts}")
        log(f"  {name}: against the oracle on its own preprocessing, mean "
            f"{statistics.fmean(own_mm):.4f} mm (max {max(own_mm):.4f})")
        self.bound(key, statistics.fmean(port_mm))
        if tripwire is not None:
            self.bound(tripwire, statistics.fmean(own_mm))
        else:
            self.metrics[f"{name}_vs_oracle_own_mean_mm"] = statistics.fmean(own_mm)
        return tracker, state

    def coarse_loops(self):
        self.coarse = self.profile_loop("coarse", {"parity_split": False}, self.frames,
                                        "coarse_closed_loop_mean_mm", "coarse_vs_oracle_own_mean_mm")
        self.profile_loop("cells", {"exact_voxels": False}, 10, "cells_closed_loop_mean_mm")

    # -- phase 5: the batched step and the per-iteration route ---------------
    def batch_frames(self, i: int):
        """Frame i of the 16 streams: stream b at phase offset 0.01·b, odd
        streams occluded at columns 500:800 on frames 10-20."""
        np = self.np
        fr = [self.frame(i / 15.0 + 0.01 * b, occlude=b % 2 == 1 and 10 <= i <= 20)
              for b in range(N_STREAMS)]
        return tuple(np.stack(f) for f in zip(*fr))

    def batched_loop(self):
        np, torch = self.np, self.torch
        from trackdlo_tpu_torch.models.trackdlo import TrackerState
        from trackdlo_tpu_torch.oracle.pipeline import init_state as oracle_init, step_frame
        from trackdlo_tpu_torch.parallel import build_batched_step_fn

        p, intr, m = self.params, self.intr, self.params.M
        fn_c8 = build_batched_step_fn(p, intr, cohort_size=COHORT, device=self.dev)
        fn_lock = build_batched_step_fn(p, intr, device=self.dev)
        init = [self.rope.nodes(0.01 * b, m) for b in range(N_STREAMS)]
        state = TrackerState(*(torch.stack(f) for f in zip(*(
            self.tracker.init_from_nodes(n) for n in init))))
        frames = [self.batch_frames(i) for i in range(1, self.frames + 1)]
        befores, outs = [], []
        state0 = state
        fn_c8(state, *frames[0])  # the first call captures the frame set's graph

        def run():
            nonlocal state
            with self.sync_errors():
                for rgb, depth, occ in frames:
                    befores.append(state)
                    state, out = fn_c8(state, rgb, depth, occ)
                    outs.append(out)

        self.count_path("batched", run)
        got = self.path_launches["batched"]
        n_cohorts = N_STREAMS // COHORT
        want = {k: 0 for k in got}
        for k in ("cell_sums", "compact", "split_cells", "visibility", "walks"):
            want[k] = n_cohorts * self.frames
        trips = 0
        for out in outs:
            for c in range(n_cohorts):
                sl = slice(c * COHORT, (c + 1) * COHORT)
                trips += int(out.guide_iterations[sl].max()) + int(out.iterations[sl].max())
        want["estep_batch"] = want["gj_solve"] = trips
        # Kernel L: once a trip and once before each cohort's two EM loops.
        want["loop_flag"] = trips + 2 * n_cohorts * self.frames
        mismatch = sum(abs(got[k] - want[k]) for k in want)
        log(f"  expected launches: {want}")
        self.bound("batched_launch_mismatch", mismatch)

        # Each frame from the same state: the single-stream step and a
        # lockstep batch of 16.
        lock_err = 0.0
        dy, dg, it_main, it_guide, dy_pert, dg_pert, trips_pert = [], [], [], [], [], [], []
        nudge = torch.from_numpy(np.random.default_rng(0).normal(0, 1e-7, (m, 3)).astype(np.float32))
        nudge = nudge.to(self.dev)
        for (rgb, depth, occ), before, out in zip(frames, befores, outs):
            s_lock, _ = fn_lock(before, rgb, depth, occ)
            lock_err = max(lock_err, float((s_lock.y - out.y).abs().max()),
                           float((s_lock.sigma2 - out.sigma2).abs().max()))
            for b in range(N_STREAMS):
                one = TrackerState(*(v[b] for v in before))
                s1, o1 = self.tracker.step(one, rgb[b], depth[b], occ[b])
                # The single step against itself, its input nodes moved by
                # ~1e-7 m: the step's own sensitivity.
                s2, o2 = self.tracker.step(one._replace(y=one.y + nudge), rgb[b], depth[b], occ[b])
                dy_pert.append(float((s1.y - s2.y).abs().max()))
                dg_pert.append(float((o1.guide_nodes - o2.guide_nodes).abs().max()))
                trips_pert.append(int(o1.iterations) != int(o2.iterations)
                                  or int(o1.guide_iterations) != int(o2.guide_iterations))
                dy.append(float((s1.y - out.y[b]).abs().max()))
                dg.append(float((o1.guide_nodes - out.guide_nodes[b]).abs().max()))
                it_main.append(int(o1.iterations) - int(out.iterations[b]))
                it_guide.append(int(o1.guide_iterations) - int(out.guide_iterations[b]))
        dy_a, dg_a = np.array(dy), np.array(dg)
        over = dy_a > BOUNDS["batched_vs_single_median_m"]
        same_trips = (np.array(it_main) == 0) & (np.array(it_guide) == 0)
        self.metrics.update(
            batched_vs_single_per_stream_frame_m=dy, batched_vs_single_guides_m=dg,
            batched_vs_single_main_trip_delta=it_main, batched_vs_single_guide_trip_delta=it_guide,
            batched_vs_single_quantiles_m={q: float(np.quantile(dy_a, q)) for q in (0.5, 0.9, 0.99)},
        )
        log(f"  batched vs single, {len(dy)} stream-frames: median {np.median(dy_a):.3g} m, p90 "
            f"{np.quantile(dy_a, 0.9):.3g}, p99 {np.quantile(dy_a, 0.99):.3g}, max {dy_a.max():.3g}; "
            f"{int(over.sum())} above {BOUNDS['batched_vs_single_median_m']}, of which "
            f"{int((over & ~same_trips).sum())} with another EM trip count; "
            f"{int((same_trips).sum())} stream-frames with equal trips, max there "
            f"{dy_a[same_trips].max() if same_trips.any() else float('nan'):.3g} m; guides: median "
            f"{np.median(dg_a):.3g} m, max {dg_a.max():.3g}")
        dp, dgp = np.array(dy_pert), np.array(dg_pert)
        log(f"  single vs single with its input moved by 1e-7 m: median {np.median(dp):.3g} m, p90 "
            f"{np.quantile(dp, 0.9):.3g}, p99 {np.quantile(dp, 0.99):.3g}, max {dp.max():.3g}; "
            f"{int(np.sum(trips_pert))} of {len(dp)} with another EM trip count; guides: median "
            f"{np.median(dgp):.3g} m, p90 {np.quantile(dgp, 0.9):.3g}, p99 "
            f"{np.quantile(dgp, 0.99):.3g}, max {dgp.max():.3g}")
        self.metrics.update(single_vs_nudged_per_stream_frame_m=dy_pert,
                            single_vs_nudged_guides_m=dg_pert,
                            single_vs_nudged_trip_changed=trips_pert,
                            batched_guides_vs_single_quantiles_m={
                                q: float(np.quantile(dg_a, q)) for q in (0.5, 0.9, 0.99)},
                            single_vs_nudged_guides_quantiles_m={
                                q: float(np.quantile(dgp, q)) for q in (0.5, 0.9, 0.99)})
        self.bound("batched_vs_single_median_m", float(np.median(dy_a)))
        self.bound("batched_vs_single_over_nudged", quantile_ratio(dy_a, dp))
        self.bound("batched_guides_vs_single_over_nudged", quantile_ratio(dg_a, dgp))
        self.bound("cohort_vs_lockstep_max", lock_err)

        for b in (0, N_STREAMS - 1):
            o_state = oracle_init(init[b], p)
            dev_mm = []
            for (rgb, depth, occ), out in zip(frames, outs):
                o_state, _, _ = step_frame(o_state, rgb[b], depth[b], p, intr, occ[b])
                y = out.y[b].cpu().numpy()
                if not np.isfinite(y).all():
                    self.failures.append("batched_closed_loop_finite")
                dev_mm.append(1000 * float(np.linalg.norm(y - o_state.y, axis=1).mean()))
            self.metrics[f"batched_closed_loop_s{b}_per_frame_mm"] = dev_mm
            self.bound(f"batched_closed_loop_s{b}_mean_mm", statistics.fmean(dev_mm))
        seen = sorted({int(v) for v in torch.stack([o.occlusion_state for o in outs]).flatten().tolist()})
        self.metrics.update(
            batched_occlusion_states_seen=seen,
            batched_guide_iterations=[o.guide_iterations.tolist() for o in outs],
            batched_main_iterations=[o.iterations.tolist() for o in outs],
        )
        log(f"  occlusion states seen across the streams: {seen}")
        log(f"  main-EM iterations, frame 1: {outs[0].iterations.tolist()}")
        if len(seen) < 2:
            self.failures.append("batched_occlusion_states")
        self.batch_fns = (fn_c8, fn_lock)
        self.batch_state, self.batch_frames_data = state, frames
        self.batch_init, self.batch_outs = state0, outs

    def batched_graph(self):
        """The batched step as one CUDA graph a frame set: the b16/c8 run of
        batched_loop against the eager step over the same 30 frame sets from
        the same state, every output bit for bit; a lockstep batch of 8
        (streams 0-7) through its graph and eagerly, bit for bit; no host
        read inside a replay (sync debug mode "error" around the replays);
        and a profiler trace of replays: S, G and kernel L show at least one
        span a replay and no more than the trips the card counted."""
        torch = self.torch
        from trackdlo_tpu_torch.models.trackdlo import TrackerState
        from trackdlo_tpu_torch.parallel import build_batched_step_fn

        p, intr = self.params, self.intr
        frames, init = self.batch_frames_data, self.batch_init
        eager = build_batched_step_fn(p, intr, cohort_size=COHORT, device=self.dev, jit=False)
        state, mismatch = init, 0
        for (rgb, depth, occ), out in zip(frames, self.batch_outs):
            state, e_out = eager(state, rgb, depth, occ)
            mismatch += self.outputs_mismatch(out, e_out)
        mismatch += self.outputs_mismatch(state, self.batch_state)
        self.bound("batched_graph_vs_eager_mismatch", mismatch)

        b8 = 8
        g8 = build_batched_step_fn(p, intr, device=self.dev)
        e8 = build_batched_step_fn(p, intr, device=self.dev, jit=False)
        s0 = TrackerState(*(v[:b8] for v in init))
        fr8 = [tuple(a[:b8] for a in f) for f in frames]
        g8(s0, *fr8[0])  # capture
        sg, outs = s0, []

        def run():
            nonlocal sg
            with self.sync_errors():
                for f in fr8:
                    sg, o = g8(sg, *f)
                    outs.append(o)

        self.count_path("b8_graph", run)
        want = sum(int(o.guide_iterations.max()) + int(o.iterations.max()) for o in outs)
        got = self.path_launches["b8_graph"]
        if got["estep_batch"] != want or got["gj_solve"] != want or (
                got["loop_flag"] != want + 2 * len(fr8)):
            self.failures.append("b8_graph_launches")
            log(f"  b8 graph launches {got} against {want} trips  FAIL")
        se, mismatch = s0, 0
        for f, o in zip(fr8, outs):
            se, eo = e8(se, *f)
            mismatch += self.outputs_mismatch(o, eo)
        self.bound("b8_graph_vs_eager_mismatch", mismatch + self.outputs_mismatch(sg, se))

        # One replay's launches, counted on the card, against a trace of
        # replays of the same call.
        fn_c8 = self.batch_fns[0]
        one = self.count_path("batched_one_replay", lambda: fn_c8(init, *frames[0]))
        per = self.path_launches["batched_one_replay"]
        traced = self.traced_launches(lambda: fn_c8(init, *frames[0]), 5)
        self.metrics["batched_replay_launches"] = {"counted": per, "traced_per_replay": traced}
        log(f"  launches a b16/c8 replay: counted {dict((k, v) for k, v in per.items() if v)}, "
            f"traced {traced}")
        for k in ("estep", "gj_solve", "loop_flag"):
            n = per["estep_batch"] if k == "estep" else per[k]
            if not 1 <= traced.get(k, 0) <= n:
                self.failures.append(f"batched_traced_launches_{k}")
                log(f"  {k}: {traced.get(k, 0)} spans a replay, counted {n}  FAIL")
        del one

    @contextlib.contextmanager
    def sync_errors(self):
        """torch's synchronisation debug mode at "error" inside the block: a
        host read of a device value raises; counted into
        batched_graph_host_reads."""
        torch = self.torch
        torch.cuda.set_sync_debug_mode("error")
        try:
            yield
        except RuntimeError as e:
            self.metrics.setdefault("host_read_errors", []).append(str(e)[:300])
            self.host_reads = getattr(self, "host_reads", 0) + 1
            raise
        finally:
            torch.cuda.set_sync_debug_mode(0)

    def solver_graphs(self, n_frames: int = 5, n_streams: int = 4):
        """The other solvers' graphs against their eager steps: the single
        step with "xla_lu", "normal_cholesky" and, after them, "lstsq" again
        (5 frames), the batched step
        of 4 streams with "xla_lu" (5 frame sets), every output bit for bit;
        "svd_lstsq" (and, batched, "normal_cholesky" and "lstsq") stay eager
        (models.trackdlo.EAGER_SOLVERS, BATCH_EAGER_SOLVERS)."""
        torch = self.torch
        import dataclasses

        from trackdlo_tpu_torch.models.trackdlo import (
            CompiledStep, TrackerState, build_step_fn,
        )
        from trackdlo_tpu_torch.parallel import build_batched_step_fn

        m, mismatch, kinds = self.params.M, 0, {}
        # lstsq again after the others: a body with cuSOLVER calls captured
        # after other such bodies in the process (one body stream a device).
        for solver in ("xla_lu", "normal_cholesky", "lstsq"):
            p = dataclasses.replace(self.params, solver=solver)
            graph = build_step_fn(p, self.intr, device=self.dev)
            eager = build_step_fn(p, self.intr, jit=False, device=self.dev)
            kinds[solver] = type(graph).__name__
            sg = se = self.tracker.init_from_nodes(self.rope.nodes(0.0, m))
            for rgb, depth, occ in self.frames_data[:n_frames]:
                occ_t = torch.from_numpy(occ != 0).to(self.dev)
                sg, og = graph(sg, rgb, depth, occ_t)
                se, oe = eager(se, rgb, depth, occ_t)
                mismatch += self.outputs_mismatch(og, oe)
            # The normal equations square the pre-registration system's
            # conditioning (~4e6): at the live profile this solver's step
            # ends in NaN, eager and graph alike. Recorded, not held.
            self.metrics[f"{solver}_step_finite"] = bool(torch.isfinite(sg.y).all())
            if not isinstance(graph, CompiledStep):
                self.failures.append(f"{solver}_step_not_a_graph")
        for solver in ("xla_lu",):
            p = dataclasses.replace(self.params, solver=solver)
            graph = build_batched_step_fn(p, self.intr, device=self.dev)
            eager = build_batched_step_fn(p, self.intr, device=self.dev, jit=False)
            sg = se = TrackerState(*(v[:n_streams] for v in self.batch_init))
            for f in self.batch_frames_data[:n_frames]:
                f = tuple(a[:n_streams] for a in f)
                sg, og = graph(sg, *f)
                se, oe = eager(se, *f)
                mismatch += self.outputs_mismatch(og, oe)
        self.metrics["solver_step_kinds"] = kinds
        self.bound("solver_graphs_vs_eager_mismatch", mismatch)

    def fused_graph(self, n_frames: int = 10):
        """Kernel F's route as a CUDA graph: the main pass of cpd_lle with
        use_fused_mstep=True (a CpdParams option: TrackerParams has no field
        for it, in the JAX package either) on the closed loop's first 10
        clouds, captured through CompiledStep over a static cloud and
        replayed; bit for bit the eager call, the trips from the card."""
        torch = self.torch
        from trackdlo_tpu_torch.models.trackdlo import CompiledStep, TrackerState, points_shapes
        from trackdlo_tpu_torch.ops.cpd_lle import CpdParams, cpd_lle

        p, m = self.params, self.params.M
        main = CpdParams(beta=p.beta, lam=p.lam, lle_weight=p.lle_weight, mu=p.mu,
                         max_iter=p.max_iter, tol=p.tol, include_lle=False,
                         visibility_threshold=p.visibility_threshold,
                         prune_radius=p.prune_radius, use_fused_mstep=True)

        def fused(state, points, mask):
            res = cpd_lle(points, mask, state.y, torch.ones(m, dtype=torch.bool, device=self.dev),
                          state.sigma2, main)
            return TrackerState(res.y, res.sigma2, state.geodesic_coord), res

        graph = CompiledStep(fused, self.dev, points_shapes(p))
        clouds = self.loop_clouds[:n_frames]
        start = self.tracker.init_from_nodes(self.rope.nodes(0.0, m))
        graph(start, *clouds[0])  # capture
        sg, se, outs, mismatch = start, start, [], 0

        def run():
            nonlocal sg
            with self.sync_errors():
                for c in clouds:
                    sg, r = graph(sg, *c)
                    outs.append(r)

        self.count_path("fused_graph", run)
        for c, r in zip(clouds, outs):
            se, er = fused(se, *c)
            mismatch += self.outputs_mismatch(r, er)
        self.bound("fused_graph_vs_eager_mismatch", mismatch + self.outputs_mismatch(sg, se))
        trips = sum(int(r.iterations) for r in outs)
        got = self.path_launches["fused_graph"]
        self.metrics["fused_graph_trips"] = [int(r.iterations) for r in outs]
        if got["em_iteration"] != trips or got["loop_flag"] != trips + len(clouds):
            self.failures.append("fused_graph_launches")
            log(f"  fused graph launches {got} against {trips} trips  FAIL")

    def lstsq_loop(self, n_frames: int = 10):
        np = self.np
        import dataclasses

        from trackdlo_tpu_torch.models.trackdlo import Tracker
        from trackdlo_tpu_torch.oracle.pipeline import init_state as oracle_init, step_frame

        p = dataclasses.replace(self.params, solver="lstsq")
        intr, m = self.intr, p.M
        tracker = Tracker(p, intr, device=self.dev)
        state = tracker.init_from_nodes(self.rope.nodes(0.0, m))
        ys, outs = [], []
        start = state
        self.warm(tracker, state, self.frames_data[0])

        def run():
            nonlocal state
            with self.sync_errors():
                for rgb, depth, occ in self.frames_data[:n_frames]:
                    state, out = tracker.step(state, rgb, depth, occ)
                    ys.append(state.y)
                    outs.append(out)

        self.count_path("lstsq", run)
        # The compiled lstsq step (its per-iteration loop a conditional node)
        # against the eager one, frame by frame.
        from trackdlo_tpu_torch.models.trackdlo import build_step_fn

        eager = build_step_fn(p, intr, jit=False, device=self.dev)
        se, mismatch = start, 0
        for (rgb, depth, occ), out in zip(self.frames_data[:n_frames], outs):
            se, eo = eager(se, rgb, depth, self.torch.from_numpy(occ != 0).to(self.dev))
            mismatch += self.outputs_mismatch(out, eo)
        self.bound("lstsq_graph_vs_eager_mismatch", mismatch + self.outputs_mismatch(state, se))
        self.solver_graphs()
        trips = sum(int(o.guide_iterations) + int(o.iterations) for o in outs)
        if self.path_launches["lstsq"]["estep"] != trips:
            self.failures.append("lstsq_trip_launches")
            log(f"  lstsq: {self.path_launches['lstsq']['estep']} S launches, {trips} trips  FAIL")
        if self.path_launches["lstsq"]["estep"] == 0 or self.path_launches["lstsq"]["em_loop"] != 0:
            self.failures.append("lstsq_launches")
        o_state = oracle_init(self.rope.nodes(0.0, m), p)
        dev_mm = []
        for (rgb, depth, occ), y in zip(self.frames_data[:n_frames], ys):
            o_state, _, _ = step_frame(o_state, rgb, depth, p, intr, occ)
            dev_mm.append(1000 * float(np.linalg.norm(y.cpu().numpy() - o_state.y, axis=1).mean()))
        self.metrics["lstsq_closed_loop_per_frame_mm"] = dev_mm
        self.bound("lstsq_closed_loop_mean_mm", statistics.fmean(dev_mm))
        self.lstsq_state = (tracker, state)

    def coarse_batched(self, n_streams: int = 4, n_frames: int = 10):
        """The coarse profile's batched step, 4 streams in lockstep for 10
        frames (streams 0-3 of phase 5, odd ones occluded): each stream's
        cloud bit-equal to the single coarse step's on its frame, kernel P
        once per frame, the exact lockstep launch count, and y under phase
        5's nudge rule."""
        np, torch = self.np, self.torch
        from trackdlo_tpu_torch.models.trackdlo import TrackerState
        from trackdlo_tpu_torch.parallel import build_batched_step_fn

        tracker = self.coarse[0]
        p, intr, m = tracker.params, self.intr, self.params.M
        fn = build_batched_step_fn(p, intr, device=self.dev)
        state = TrackerState(*(torch.stack(f) for f in zip(*(
            tracker.init_from_nodes(self.rope.nodes(0.01 * b, m)) for b in range(n_streams)))))
        frames = [tuple(a[:n_streams] for a in f) for f in self.batch_frames_data[:n_frames]]
        befores, outs = [], []
        fn(state, *frames[0])  # capture

        def run():
            nonlocal state
            for rgb, depth, occ in frames:
                befores.append(state)
                state, out = fn(state, rgb, depth, occ)
                outs.append(out)

        self.count_path("coarse_batched", run)
        got = self.path_launches["coarse_batched"]
        want = {k: 0 for k in got}
        for k in ("cell_sums_votes", "visibility", "walks"):
            want[k] = n_frames
        want["estep_batch"] = want["gj_solve"] = sum(
            int(o.guide_iterations.max()) + int(o.iterations.max()) for o in outs)
        want["loop_flag"] = want["estep_batch"] + 2 * n_frames
        log(f"  expected launches: {want}")
        self.bound("coarse_batched_launch_mismatch", sum(abs(got[k] - want[k]) for k in want))

        cloud_mis = 0
        dy, dp = [], []
        nudge = torch.from_numpy(np.random.default_rng(0).normal(0, 1e-7, (m, 3)).astype(np.float32))
        nudge = nudge.to(self.dev)
        for (rgb, depth, occ), before, out in zip(frames, befores, outs):
            for b in range(n_streams):
                one = TrackerState(*(v[b] for v in before))
                s1, o1 = tracker.step(one, rgb[b], depth[b], occ[b])
                s2, _ = tracker.step(one._replace(y=one.y + nudge), rgb[b], depth[b], occ[b])
                cloud_mis += int((o1.points != out.points[b]).any(dim=-1).sum())
                cloud_mis += int((o1.points_mask != out.points_mask[b]).sum())
                dy.append(float((s1.y - out.y[b]).abs().max()))
                dp.append(float((s1.y - s2.y).abs().max()))
        dy_a, dp_a = np.array(dy), np.array(dp)
        self.metrics.update(coarse_batched_vs_single_m=dy, coarse_single_vs_nudged_m=dp)
        log(f"  coarse batched vs single, {len(dy)} stream-frames: median {np.median(dy_a):.3g} m, "
            f"max {dy_a.max():.3g}; single vs nudged: median {np.median(dp_a):.3g}, "
            f"max {dp_a.max():.3g}")
        self.bound("coarse_batched_cloud_mismatch", cloud_mis)
        self.bound("coarse_batched_vs_single_median_m", float(np.median(dy_a)))
        self.bound("coarse_batched_vs_single_over_nudged", quantile_ratio(dy_a, dp_a))

    # -- phase 6: the point-sharded step -----------------------------------------
    def sharded_loop(self):
        np, torch = self.np, self.torch
        from trackdlo_tpu_torch.models.trackdlo import TrackerState
        from trackdlo_tpu_torch.oracle.pipeline import init_state as oracle_init, step_frame
        from trackdlo_tpu_torch.parallel.launch import run_ranks

        p, intr, m = self.params, self.intr, self.params.M
        t0 = time.perf_counter()
        ranks = run_ranks(shard_worker, SHARD_RANKS, device="cuda:0",
                          timeout_s=600.0, args=(self.frames,))
        log(f"  {SHARD_RANKS} ranks on cuda:0 ran in {time.perf_counter() - t0:.1f} s, shards "
            f"{[r['shard'] for r in ranks]}")
        r0 = ranks[0]
        for r in ranks:
            if r["jax_modules"]:
                self.failures.append("sharded_rank_imported_jax")
                log(f"  a rank imported {r['jax_modules'][:5]}  FAIL")
        counts = np.stack([r["shard_count"] for r in ranks])
        log(f"  valid points per shard, frame 1: {counts[:, 0].tolist()} of {int(r0['n_points'][0])}")
        self.bound("sharded_count_mismatch", int((counts.sum(0) != r0["n_points"]).sum()))
        self.bound("sharded_ranks_mismatch", sum(
            int((~((r["y"] == r0["y"]).all(axis=(1, 2)) & (r["sigma2"] == r0["sigma2"]))).sum())
            for r in ranks[1:]))

        self.path_launches["sharded"] = r0["launches"]
        log(f"  launches in the sharded run (rank 0): {r0['launches']}")
        trips = int(r0["iterations"].sum() + r0["guide_iterations"].sum())
        want = {k: 0 for k in r0["launches"]}
        for k in ("cell_sums", "compact", "split_cells", "visibility", "walks"):
            want[k] = self.frames
        want["estep"] = want["gj_solve"] = trips
        want["nearest"] = int(r0["iterations"].sum())
        log(f"  expected launches: {want}")
        self.bound("sharded_launch_mismatch",
                   sum(abs(r["launches"][k] - want[k]) for r in ranks for k in want))

        geo = self.tracker.init_from_nodes(self.rope.nodes(0.0, m)).geodesic_coord
        o_state = oracle_init(self.rope.nodes(0.0, m), p)
        nudge = torch.from_numpy(np.random.default_rng(0).normal(0, 1e-7, (m, 3)).astype(np.float32))
        nudge = nudge.to(self.dev)
        y_prev = torch.as_tensor(self.rope.nodes(0.0, m), dtype=torch.float32, device=self.dev)
        s2_prev = torch.tensor(p.sigma2_init, dtype=torch.float32, device=self.dev)
        dev_mm, dy, dp, trips_changed = [], [], [], 0
        for k, (rgb, depth, occ) in enumerate(self.frames_data):
            o_state, _, _ = step_frame(o_state, rgb, depth, p, intr, occ)
            y = r0["y"][k]
            if not np.isfinite(y).all() or y.shape != (m, 3):
                self.failures.append("sharded_closed_loop_finite")
            dev_mm.append(1000 * float(np.linalg.norm(y - o_state.y, axis=1).mean()))
            before = TrackerState(y_prev, s2_prev, geo)
            s1, o1 = self.tracker.step(before, rgb, depth, occ)
            s2, _ = self.tracker.step(before._replace(y=y_prev + nudge), rgb, depth, occ)
            dy.append(float(np.abs(s1.y.cpu().numpy() - y).max()))
            dp.append(float((s1.y - s2.y).abs().max()))
            trips_changed += int(o1.iterations) != int(r0["iterations"][k])
            y_prev = torch.as_tensor(y, device=self.dev)
            s2_prev = torch.as_tensor(r0["sigma2"][k], device=self.dev)
        dy_a, dp_a = np.array(dy), np.array(dp)
        ev, timed, wall = (np.array(r0[k]) for k in ("event_ms", "timed_event_ms", "timed_wall_ms"))
        self.times["sharded_step"] = {
            "median_ms": float(np.median(timed)), "p90_ms": float(np.percentile(timed, 90)),
            "wall_median_ms": float(np.median(wall)), "counted_run_median_ms": float(np.median(ev)),
            "calls": len(timed), "ranks": SHARD_RANKS,
            "rank_event_medians_ms": [float(np.median(r["timed_event_ms"])) for r in ranks],
            "all_reduce_ms": r0["all_reduce_ms"]}
        self.metrics.update(
            sharded_per_frame_mm=dev_mm, sharded_vs_single_m=dy, sharded_single_vs_nudged_m=dp,
            sharded_shard_counts=counts.tolist(), sharded_n_points=r0["n_points"].tolist(),
            sharded_main_iterations=r0["iterations"].tolist(),
            sharded_guide_iterations=r0["guide_iterations"].tolist(),
            sharded_occlusion_states_seen=sorted({int(v) for v in r0["occlusion_state"]}))
        log(f"  main-EM iterations: {r0['iterations'].tolist()}")
        log(f"  per-frame deviation from the oracle (mm): {[round(v, 4) for v in dev_mm]}")
        log(f"  sharded vs Tracker.step, {len(dy)} frames: median {np.median(dy_a):.3g} m, max "
            f"{dy_a.max():.3g}, {trips_changed} with another main-EM trip count; Tracker.step vs "
            f"nudged: median {np.median(dp_a):.3g} m, max {dp_a.max():.3g}")
        log(f"  per frame (rank 0, CUDA events, 30 frames after the counted run): median "
            f"{np.median(timed):.3f} ms, p90 {np.percentile(timed, 90):.3f} ms, host wall median "
            f"{np.median(wall):.3f} ms; the counted run's median {np.median(ev):.3f} ms")
        log(f"  one all-reduce of {4 * m + 2} floats between the ranks: card tensor "
            f"{r0['all_reduce_ms']['cuda']:.4f} ms, host tensor {r0['all_reduce_ms']['cpu']:.4f} ms")
        self.bound("sharded_closed_loop_mean_mm", statistics.fmean(dev_mm))
        self.bound("sharded_vs_single_median_m", float(np.median(dy_a)))
        self.bound("sharded_vs_single_over_nudged", quantile_ratio(dy_a, dp_a))

    # -- phase 7: timing --------------------------------------------------------
    def step_times(self, key, step, frames, n):
        """Median and p90 of CUDA events around ``step`` over ``n`` calls."""
        np, torch = self.np, self.torch
        ev_ms, wall_ms = [], []
        for i in range(n):
            args = frames[i % len(frames)]
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            step(*args)
            end.record()
            end.synchronize()
            wall_ms.append(1000 * (time.perf_counter() - t0))
            ev_ms.append(start.elapsed_time(end))
        rec = {"median_ms": statistics.median(ev_ms), "p90_ms": float(np.percentile(ev_ms, 90)),
               "wall_median_ms": statistics.median(wall_ms), "calls": n}
        self.times[key] = rec
        return rec

    def kernel_bounds(self):
        """Each kernel's least time on the card for the inputs it is timed on."""
        p, m = self.params, self.params.M
        rgb = self.p_args[0]
        h, w = rgb.shape[:2]
        n_cells = self.c_args[3].shape[-1]
        self.bounds_ms["cell_sums"] = bound(h * w * 6 + 4 * 8 * n_cells * 4, h * w * OPS_PER_PIXEL)
        # Kernel C's derived launch: the counts read once (the occupied
        # flags), the kept cells' x, y, z read once, every slot written once
        # (x, y, z, count and the valid byte); one compare a cell and three
        # divisions a kept cell. This frame's kept cells: each row's
        # occupied cells, at most cap of them.
        counts, cap = self.c_args[3], self.c_args[4]
        rows, n_per = counts.shape
        n_kept = int((counts > 0).sum(1).clamp(max=cap).sum())
        self.bounds_ms["compact"] = bound(rows * n_per * 4 + n_kept * 12 + rows * cap * 17,
                                          rows * n_per + 3 * n_kept)
        x, xm = self.v_args[1], self.v_args[2]
        n, n_valid = x.shape[0], int(xm.sum())
        self.bounds_ms["visibility"] = bound(n * 21 + m * 32 + 48,
                                             2 * OPS_SWEEP_PAIR * m * n_valid + 20 * m * m)
        gw = self.w_args[0]
        nw, mw = gw.shape[:2]
        self.bounds_ms["walks"] = bound(nw * (mw * 12 + (mw - 1) * 4 + 20 + mw * 13),
                                        nw * (mw - 1) * (mw - 1) * OPS_WALK_STEP_SEG)
        st = self.e_stage
        it = int(self.e_iters)
        nv = int(st.n_count)
        self.bounds_ms["em_loop"] = bound(
            n * 16 + 3 * m * m * 4 + 6 * m * 12 + 16 + m * 12 + 16,
            it * ((OPS_SWEEP_PAIR + OPS_ESTEP_PAIR) * m * nv + em_mstep_ops(m)))
        scal, y = self.s_args[0], self.s_args[1]
        bsz, n_b = y.shape[0], self.s_args[5].shape[1]
        per_stream_bytes = 32 + n_b * 16 + m * 12 * 2 + m * 4 * 5 + 8
        nv_all = [int(v) for v in self.s_n_valid.tolist()]
        sweep = OPS_SWEEP_PAIR if bool((scal[:, 3] > 0).any()) else 0
        self.bounds_ms["estep_batch"] = bound(
            bsz * per_stream_bytes, sum((sweep + OPS_ESTEP_PAIR) * m * v for v in nv_all))
        sweep0 = OPS_SWEEP_PAIR if bool(scal[0, 3] > 0) else 0
        self.bounds_ms["estep"] = bound(per_stream_bytes, (sweep0 + OPS_ESTEP_PAIR) * m * nv_all[0])
        a = self.g_args[0]
        ns, mg = a.shape[:2]
        self.bounds_ms["gj_solve"] = bound(ns * (mg * mg + 2 * mg * 3) * 4, ns * gj_solve_ops(mg))
        self.bounds_ms["cell_sums_votes"] = bound(h * w * 6 + 7 * n_cells * 4, h * w * OPS_PER_PIXEL)
        self.bounds_ms["cell_sums_cells"] = bound(h * w * 6 + 4 * n_cells * 4,
                                                  h * w * OPS_PER_PIXEL_CELLS)
        st1 = self.f_stage[0]
        n_f, nv_f = st1.args[9].shape[1], int(st1.n_count[0])
        sweep_f = OPS_SWEEP_PAIR if bool(st1.args[0][0, 3] > 0) else 0
        self.bounds_ms["em_iteration"] = bound(
            20 + m * 12 * 2 + m * 4 * 2 + 3 * m * m * 4 + 2 * m * 12 + n_f * 16 + m * 12 + 8,
            (sweep_f + OPS_ESTEP_PAIR) * m * nv_f + onehot_mstep_ops(m))
        # Kernel L: B done bytes and B int32 counts read, the flag written;
        # a compare, an and and an or a stream.
        nl = self.l_args[0].shape[0]
        self.bounds_ms["loop_flag"] = bound(nl * 5 + 4, 3 * nl)
        yn, nmn, xn, xmn = self.n_args
        self.bounds_ms["nearest"] = bound(
            sum(t.numel() * t.element_size() for t in self.n_args) + yn.shape[0] * 4,
            OPS_SWEEP_PAIR * int(nmn.sum()) * int(xmn.sum()))

    def wide_timing(self):
        """The wide builds at 100 and 128 nodes, the node-unbounded builds at
        256 and 512 and E, S and F at 65,536 rows (:data:`WIDE_TIMED`) on
        :meth:`wide_kernels`' inputs: ms per call by CUDA events (plain,
        kernel, kernel, plain), and the kernel's device time from the
        profiler."""
        for key, calls in self.wide_calls.items():
            if key not in WIDE_TIMED:
                continue
            m = int(key.rsplit("nodes", 1)[1])
            for name, (kfn, pfn, *lib) in calls.items():
                p1 = self.event_ms(pfn, 3)
                k1 = self.event_ms(kfn, 20)
                k2 = self.event_ms(kfn, 20)
                p2 = self.event_ms(pfn, 3)
                b_ms, b_by = self.wide_bounds[key][name]
                rec = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2, "bound_ms": b_ms,
                       "bound_by": b_by,
                       "library_ms": self.event_ms(lib[0], 20) if lib else None}
                rec["device_ms"], rec["device_ops_per_call"] = self.device_ms(kfn, 20)
                self.times[f"{name}_m{m}" if key == f"nodes{m}" else f"{name}_{key}"] = rec
                dev = ("not measured" if rec["device_ms"] is None
                       else f"{rec['device_ms']:.4f} ms in {rec['device_ops_per_call']:g} ops")
                libs = "" if not lib else f"   torch.linalg.solve {rec['library_ms']:.4f} ms"
                log(f"  {name:12s} {key}: kernel {rec['ms']:.4f} ms (device {dev})   plain "
                    f"{rec['plain_ms']:.4f} ms{libs}   bound {b_ms:.6f} ms ({b_by})")

    def timing(self):
        np, torch = self.np, self.torch
        import dataclasses

        from trackdlo_tpu_torch.ops.cpd_lle import (
            CpdParams, _estep_one_stream, em_staging, fused_iteration, iteration_route,
        )
        from trackdlo_tpu_torch.ops.hopper_kernels import (
            fused_em_iteration_plain, fused_em_loop, fused_em_loop_plain, fused_estep_packed,
            fused_estep_packed_batch, fused_estep_packed_batch_plain, fused_estep_packed_plain,
            gauss_jordan_solve_batched, gauss_jordan_solve_batched_plain, nearest_point_sq,
            nearest_point_sq_plain, pursuit_walks, pursuit_walks_plain,
        )
        from trackdlo_tpu_torch.ops.preprocess import (
            cell_sums_plain, compact_occupied_channels, compact_occupied_channels_plain, split_groups,
            split_groups_plain,
        )
        from trackdlo_tpu_torch.ops.preprocess_kernel import cell_sums
        from trackdlo_tpu_torch.ops.visibility import compute_visibility
        from trackdlo_tpu_torch.ops.visibility_kernel import fused_visibility
        from trackdlo_tpu_torch.parallel.launch import run_ranks

        tracker, state, frames = self.tracker, self.state, self.frames_data
        for i in range(10):
            rgb, depth, occ = frames[i % len(frames)]
            state, _ = tracker.step(state, rgb, depth, occ)
        torch.cuda.synchronize()
        holder = {"s": state}

        def single(rgb, depth, occ):
            holder["s"], _ = tracker.step(holder["s"], rgb, depth, occ)

        from trackdlo_tpu_torch.models.trackdlo import build_step_fn

        eager = build_step_fn(self.params, self.intr, jit=False, device=self.dev)
        holder["e"] = holder["s"]

        def single_eager(rgb, depth, occ):
            occ_t = torch.from_numpy(occ != 0).to(self.dev)
            holder["e"], _ = eager(holder["e"], rgb, depth, occ_t)

        for i in range(10):
            single_eager(*frames[i % len(frames)])
        for key, fn in (("step", single), ("step_eager", single_eager)):
            rec = self.step_times(key, fn, frames, self.timing_frames)
            log(f"  Tracker.step per frame, {'one CUDA graph' if key == 'step' else 'eager'}: "
                f"median {rec['median_ms']:.3f} ms (p90 {rec['p90_ms']:.3f}, host wall median "
                f"{rec['wall_median_ms']:.3f})")
        c_tracker, holder["c"] = self.coarse
        for i in range(10):
            holder["c"], _ = c_tracker.step(holder["c"], *frames[i % len(frames)])

        def coarse(rgb, depth, occ):
            holder["c"], _ = c_tracker.step(holder["c"], rgb, depth, occ)

        rec = self.step_times("step_coarse", coarse, frames, self.timing_frames)
        log(f"  Tracker.step, parity_split=False, per frame: median {rec['median_ms']:.3f} ms "
            f"(p90 {rec['p90_ms']:.3f}, host wall median {rec['wall_median_ms']:.3f})")

        # The batched step: each frame set one CUDA graph, and eagerly
        # (build_batched_step_fn(jit=False)), in the same call.
        from trackdlo_tpu_torch.parallel import build_batched_step_fn

        fn_c8, fn_lock = self.batch_fns
        e_c8 = build_batched_step_fn(self.params, self.intr, cohort_size=COHORT, device=self.dev,
                                     jit=False)
        e_lock = build_batched_step_fn(self.params, self.intr, device=self.dev, jit=False)
        bframes = self.batch_frames_data
        for key, fn, b in (("batched_b16_c8", fn_c8, N_STREAMS), ("batched_b8_lockstep", fn_lock, 8),
                           ("batched_b16_c8_eager", e_c8, N_STREAMS),
                           ("batched_b8_lockstep_eager", e_lock, 8)):
            holder["b"] = type(self.batch_state)(*(v[:b] for v in self.batch_state))
            fr = [tuple(a[:b] for a in f) for f in bframes]

            def batched(rgb, depth, occ, fn=fn):
                holder["b"], _ = fn(holder["b"], rgb, depth, occ)

            for f in fr[:3]:
                batched(*f)
            torch.cuda.synchronize()
            rec = self.step_times(key, batched, fr, self.timing_frames)
            rec["streams"] = b
            rec["stream_frames_per_s"] = b / (rec["median_ms"] / 1e3)
            log(f"  {key}: per frame set median {rec['median_ms']:.3f} ms (p90 {rec['p90_ms']:.3f}, "
                f"host wall median {rec['wall_median_ms']:.3f}), {rec['stream_frames_per_s']:.1f} "
                f"stream-frames/s")

        # The single step with solver "lstsq" and the points step, each one
        # CUDA graph and eager.
        lt, holder["l"] = self.lstsq_state
        l_eager = build_step_fn(lt.params, self.intr, jit=False, device=self.dev)
        holder["le"] = holder["l"]

        def lstsq(rgb, depth, occ):
            holder["l"], _ = lt.step(holder["l"], rgb, depth, occ)

        def lstsq_eager(rgb, depth, occ):
            holder["le"], _ = l_eager(holder["le"], rgb, depth, torch.from_numpy(occ != 0).to(self.dev))

        from trackdlo_tpu_torch.models.trackdlo import build_points_step_fn

        pt_eager = build_points_step_fn(self.params, self.intr, jit=False, device=self.dev)
        cap = self.params.max_points
        padded = []
        for c in self.oracle_clouds:
            pts, msk = np.zeros((cap, 3), np.float32), np.zeros(cap, bool)
            pts[:len(c)], msk[:len(c)] = c[:cap], True
            padded.append((pts, msk))
        holder["p"] = holder["pe"] = self.state

        def points(cloud):
            holder["p"], _ = tracker.step_from_points(holder["p"], cloud)

        def points_eager(pts, msk):
            holder["pe"], _ = pt_eager(holder["pe"], pts, msk)

        for key, fn, fr in (("step_lstsq", lstsq, frames), ("step_lstsq_eager", lstsq_eager, frames),
                            ("step_from_points", points, [(c,) for c in self.oracle_clouds]),
                            ("step_from_points_eager", points_eager, padded)):
            for f in fr[:3]:
                fn(*f)
            torch.cuda.synchronize()
            rec = self.step_times(key, fn, fr, self.timing_frames)
            log(f"  {key}: per frame median {rec['median_ms']:.3f} ms (p90 {rec['p90_ms']:.3f}, "
                f"host wall median {rec['wall_median_ms']:.3f})")

        p = self.params
        m = p.M
        nodes = torch.as_tensor(self.rope.nodes(0.0, m), dtype=torch.float32, device=self.dev)
        st = em_staging(
            self.cloud.points, self.cloud.mask, nodes, torch.ones(m, dtype=torch.bool, device=self.dev),
            torch.tensor(p.sigma2_init, device=self.dev),
            CpdParams(beta=p.beta, lam=p.lam, lle_weight=p.lle_weight, mu=p.mu, max_iter=10,
                      tol=0.0, include_lle=False, k_vis=p.k_vis,
                      visibility_threshold=p.visibility_threshold, use_visibility=True),
            visible_count=torch.tensor(30, device=self.dev),
        )
        self.e_stage = st
        self.e_iters = fused_em_loop(*st.args, **st.kwargs)[1][1]
        # Kernel G at the batched main path's shape: the 8 systems of one
        # cohort's M-step (the live pre-registration system, then the SPD
        # systems), and at (16, 48, 48).
        a_l, b_l = self.prereg_system()
        self.g_args = (a_l.expand(COHORT, m, m).contiguous(), b_l.expand(COHORT, m, 3).contiguous())
        self.kernel_bounds()
        self.time_pair("cell_sums", lambda: cell_sums(*self.p_args, exact=True),
                       lambda: cell_sums_plain(*self.p_args, exact=True))
        self.times["cell_sums"]["note"] = "the exact route's build (the step's), live 720p frame"
        self.times["cell_sums"]["cold_l2"] = self.cold_l2(lambda: cell_sums(*self.p_args, exact=True),
                                                          "cell_sums")
        log(f"  cell_sums with the L2 flushed before each launch: device "
            f"{ms_or_not(self.times['cell_sums']['cold_l2']['device_ms'])}")
        self.time_pair("compact", lambda: compact_occupied_channels(*self.c_args),
                       lambda: compact_occupied_channels_plain(*self.c_args))
        self.times["compact"]["note"] = "the derived mode: thinning, pack and centroid division"
        ex, rows = self.x_args
        self.time_pair("split_cells", lambda: split_groups(ex, *(t.clone() for t in rows)),
                       lambda: split_groups_plain(ex, *rows))
        self.times["split_cells"]["note"] = ("the noisy 720p frame of check_exact_route, on fresh "
                                             "copies of kernel C's rows (X appends in place)")
        self.time_pair("visibility", lambda: fused_visibility(*self.v_args),
                       lambda: compute_visibility(*self.v_args))
        self.time_pair("walks", lambda: pursuit_walks(*self.w_args), lambda: pursuit_walks_plain(*self.w_args))
        self.time_pair("em_loop", lambda: fused_em_loop(*st.args, **st.kwargs),
                       lambda: fused_em_loop_plain(*st.args, **st.kwargs), n_kernel=20, n_plain=3)
        self.times["em_loop"]["note"] = "10 iterations (tol=0), main-pass configuration with the gate on"
        sa = self.s_args
        one = tuple(a[0] for a in sa)
        self.time_pair("estep", lambda: fused_estep_packed(*one, two_phase=True),
                       lambda: fused_estep_packed_plain(*one, two_phase=True))
        self.time_pair("estep_batch", lambda: fused_estep_packed_batch(*sa, two_phase=True),
                       lambda: fused_estep_packed_batch_plain(*sa, two_phase=True), n_plain=3)
        self.times["estep_batch"]["note"] = f"{sa[1].shape[0]} streams, gates mixed, two phases"
        ga = self.g_args
        self.time_pair("gj_solve", lambda: gauss_jordan_solve_batched(*ga),
                       lambda: gauss_jordan_solve_batched_plain(*ga),
                       library_fn=lambda: torch.linalg.solve(*ga))
        self.times["gj_solve"]["note"] = f"{ga[0].shape[0]} systems of {m} x {m}, 3 right-hand sides"
        spd = self.gj_spd
        self.bounds_ms["gj_solve_b16_m48"] = bound(16 * (48 * 48 + 6 * 48) * 4, 16 * gj_solve_ops(48))
        self.time_pair("gj_solve_b16_m48", lambda: gauss_jordan_solve_batched(*spd),
                       lambda: gauss_jordan_solve_batched_plain(*spd),
                       library_fn=lambda: torch.linalg.solve(*spd))
        for mode in ("votes", "cells"):
            a1, kw1 = self.p1_args[mode]
            self.time_pair(f"cell_sums_{mode}", lambda a1=a1, kw1=kw1: cell_sums(*a1, **kw1),
                           lambda a1=a1, kw1=kw1: cell_sums_plain(*a1, **kw1))
        st1, main = self.f_stage
        y1, s21 = st1.args[1], st1.args[0][:, 0]
        self.time_pair("em_iteration", lambda: fused_iteration(st1, y1, s21, main),
                       lambda: fused_iteration(st1, y1, s21, main, fused_em_iteration_plain),
                       n_plain=3)
        route = iteration_route(st1, dataclasses.replace(main, use_fused_mstep=False),
                                _estep_one_stream)
        route_ms = [self.event_ms(lambda: route(y1, s21), 50) for _ in range(2)]
        self.times["em_iteration"].update(
            note="one iteration, one stream, main-pass configuration with the gate on",
            periter_route_ms=sum(route_ms) / 2, periter_route_ms_runs=route_ms)
        log(f"  one iteration of the per-iteration route (S + M-step assembly + G): "
            f"{sum(route_ms) / 2:.4f} ms")
        if "sharded_step" in self.times:
            # The sharded step's route in one process: a one-rank model axis.
            one = run_ranks(shard_worker, 1, device="cuda:0", timeout_s=600.0,
                            args=(self.frames,))[0]
            self.times["sharded_step_one_rank"] = {
                "median_ms": float(np.median(one["timed_event_ms"])),
                "p90_ms": float(np.percentile(one["timed_event_ms"], 90)),
                "wall_median_ms": float(np.median(one["timed_wall_ms"])),
                "all_reduce_ms": one["all_reduce_ms"], "calls": len(one["timed_event_ms"])}
            log(f"  the sharded step on one rank (its route, no second process): median "
                f"{self.times['sharded_step_one_rank']['median_ms']:.3f} ms, p90 "
                f"{self.times['sharded_step_one_rank']['p90_ms']:.3f} ms; one-rank all-reduce "
                f"{one['all_reduce_ms']['cuda']:.4f} ms")
        self.time_pair("nearest", lambda: nearest_point_sq(*self.n_args),
                       lambda: nearest_point_sq_plain(*self.n_args))
        self.times["nearest"]["note"] = (f"{self.n_args[0].shape[0]} nodes, one shard of "
                                         f"{self.n_args[2].shape[0]} points, bool masks")
        # The route's own inputs: em_staging's float32 masks.
        route = {"ms": self.event_ms(lambda: nearest_point_sq(*self.n_args_route), 50)}
        route["device_ms"], route["device_ops_per_call"] = self.device_ms(
            lambda: nearest_point_sq(*self.n_args_route), 50)
        self.times["nearest"]["float_masks"] = route
        from trackdlo_tpu_torch.ops.graph_loop import loop_flag, loop_flag_plain

        self.time_pair("loop_flag", lambda: loop_flag(*self.l_args),
                       lambda: loop_flag_plain(*self.l_args))
        self.times["loop_flag"]["note"] = f"{COHORT} streams (a cohort's lockstep loop), alone"
        log(f"  nearest, float32 masks (the route's): kernel {route['ms']:.4f} ms (device "
            f"{ms_or_not(route['device_ms'])} in {route['device_ops_per_call']:g} ops)")


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="check,loop,batch,shard,timing",
                    help="comma list of check,loop,batch,shard,timing (toolchain and build always "
                         "run); anything but all five prints no result line")
    args = ap.parse_args()
    phases = set(args.phases.split(","))
    everything = {"check", "loop", "batch", "shard", "timing"}

    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import trackdlo_tpu_torch  # noqa: F401
        from trackdlo_tpu_torch import _build
        from trackdlo_tpu_torch.device import toolchain_probe
    except ImportError as e:
        print(f"chip_smoke: the port package is missing beside this script ({e})", file=sys.stderr)
        return 2

    t_start = time.perf_counter()
    card = card_line()
    log(f"[1] card: {card}")
    probe = toolchain_probe()
    log(f"    torch {probe['torch']}, torch.version.cuda {probe['torch_cuda']}, "
        f"nvcc {probe['nvcc']}, triton {probe['triton']}, python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    # The probe build of kernel E (fault 1's phase summary) compiles beside
    # the library.
    sys.path.insert(0, os.path.join(ROOT, "perf"))
    import port_em_probes

    probe: dict = {}

    def build_probe():
        try:
            probe["lib"] = port_em_probes.build_probe(os.path.join(ROOT, "trackdlo_tpu_torch", "csrc"),
                                                      "smoke")
        except BaseException as e:  # SystemExit carries nvcc's output
            probe["error"] = str(e)

    probe_thread = threading.Thread(target=build_probe)
    probe_thread.start()
    lib_path = _build.build(verbose=True)
    _build.lib()
    probe_thread.join()
    if "lib" not in probe:
        log(f"FAILED: the probe build of kernel E: {probe.get('error')}")
        return 1
    log(f"[2] build: {lib_path.name} in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 'cached'} s), "
        f"with the probe build of kernel E")

    smoke = Smoke()
    phase_s = {}
    if "check" in phases:
        log("[3] kernels against their plain versions on the card")
        t0 = time.perf_counter()
        smoke.cluster_launches()
        smoke.check_preprocess()
        smoke.check_exact_route()
        smoke.check_visibility()
        smoke.check_walks()
        smoke.check_em()
        smoke.check_prereg_frames(probe["lib"])
        smoke.check_gj()
        smoke.check_estep()
        smoke.check_em_periter()
        smoke.check_preprocess_single()
        smoke.check_fused()
        smoke.check_nearest()
        smoke.check_loop_flag()
        smoke.row_kernels()
        torch.cuda.synchronize()
        phase_s["check"] = time.perf_counter() - t0
    if "loop" in phases:
        log(f"[4] closed loop: {smoke.frames} frames against the float64 oracle, the compiled step "
            "against the eager step; the coarse and cells-only profiles")
        t0 = time.perf_counter()
        smoke.closed_loop()
        smoke.coarse_loops()
        log("    the reference cells: 45 occluded frames (full, same_pts), the native library's "
            "clouds, 40 frames' trips, the evaluation profile")
        smoke.reference_cells()
        log("    node counts past the narrow builds (49, 64, 100) and the wide builds (129, 192, "
            "256, 512, 1024), the long-cable cell, the TCP service, GLTP")
        smoke.node_counts()
        smoke.cable_cell()
        smoke.server()
        smoke.gltp()
        phase_s["loop"] = time.perf_counter() - t0
    if "batch" in phases and "loop" in phases and "check" in phases:
        log(f"[5] batched step: {N_STREAMS} streams in cohorts of {COHORT}, {smoke.frames} frames; "
            "then the lstsq route and the coarse batched step")
        t0 = time.perf_counter()
        smoke.batched_loop()
        smoke.batched_graph()
        smoke.lstsq_loop()
        smoke.fused_graph()
        smoke.bound("batched_graph_host_reads", getattr(smoke, "host_reads", 0))
        smoke.coarse_batched()
        phase_s["batch"] = time.perf_counter() - t0
    if "shard" in phases and "loop" in phases:
        log(f"[6] point-sharded step: 1 data x {SHARD_RANKS} model gloo ranks on cuda:0, "
            f"{smoke.frames} frames")
        t0 = time.perf_counter()
        smoke.sharded_loop()
        phase_s["shard"] = time.perf_counter() - t0
    if phases >= everything:
        log(f"[7] timing on {card}")
        t0 = time.perf_counter()
        smoke.timing()
        smoke.wide_timing()
        phase_s["timing"] = time.perf_counter() - t0
    phase_s["total"] = time.perf_counter() - t_start
    log(f"    seconds per phase: { {k: round(v, 1) for k, v in phase_s.items()} }")

    if any(k == "jax" or k.startswith(("jax.", "trackdlo_tpu.")) or k == "trackdlo_tpu"
           for k in sys.modules):
        smoke.failures.append("jax_or_jax_package_imported")
    record = {
        "card": card, "toolchain": probe, "metrics": smoke.metrics, "bounds": BOUNDS,
        "launches": smoke.launches, "path_launches": smoke.path_launches,
        "times": smoke.times,
        "bounds_ms": smoke.bounds_ms, "failures": smoke.failures, "phases": sorted(phases),
        "phase_seconds": phase_s,
    }
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    if smoke.bits:
        import numpy as np

        np.savez(os.path.join(ROOT, "chiprun_out", "exact_products_bits.npz"), **smoke.bits)
    if smoke.walk_bits:
        import numpy as np

        np.savez(os.path.join(ROOT, "chiprun_out", "walks_bits.npz"), **smoke.walk_bits)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1, default=str)
    if smoke.failures:
        log(f"FAILED: {smoke.failures}")
        return 1
    if not phases >= everything:
        log("partial run: no result line")
        return 0
    kernels = []
    traced = smoke.metrics["graph_replay_launches"]["traced_per_replay"]
    for name, (src, replaces) in KERNELS.items():
        launches = smoke.path_launches[LAUNCH_PATH.get(name, "single")][name]
        if launches <= 0:
            log(f"FAILED: kernel {name} was not launched on its path")
            return 1
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches, "max_abs_err": smoke.kernel_err[name],
            "ms": smoke.times[name]["ms"], "plain_ms": smoke.times[name]["plain_ms"],
            "bound_ms": smoke.bounds_ms[name][0], "bound_by": smoke.bounds_ms[name][1],
            "library_ms": smoke.times[name]["library_ms"],
            # Single-path kernels: the launches of the counted run's replays as
            # a profiler trace of replays sees them (graph_checks).
            "launches_traced": (traced[name] * smoke.frames
                                if LAUNCH_PATH.get(name, "single") == "single" else None),
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:
        traceback.print_exc()
        sys.exit(1)
