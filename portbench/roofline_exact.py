"""The least work of kernel X (the exact route's split channel-cells,
``csrc/split_cells.cu``), for its roofline share.

Kernel X reads, each launch, kernel P's two counts of each of its blocks
(split channel-cells, masked pixels without depth) and exits where all are
zero. Where a stream-frame has work it reads the bytes of the cells with a
split channel, those cells' pixels (rgb, depth and mask: 6 bytes each), the
valid flags of its eight candidate rows, and writes each group it appends
(centroid, count and flag: 17 bytes); the pixels' operations are kernel P's
per pixel (:data:`portbench.roofline.OPS_PER_PIXEL`). The work the data
decides comes from the kernel's own tally (the ``split_cells.*`` counters of
the port's ``_build``); the blocks from kernel P's strip layout, copied here
from ``csrc/cell_sums.cu`` (``strip_layout``).
"""

from __future__ import annotations

from portbench import roofline
from portbench.trace import base_name

# Kernel X in a trace: its function's name and its launch counter (looked up
# here: ``portbench.trace.KERNELS`` names the kernels of the first cells).
X_NAMES, X_COUNTER = ("split_cells_kernel",), "split_cells"
TILE_CELLS = 32
TILE_BUDGET = 128 * 1024
MAX_DYN_SMEM = 232448 - 4096
PIXEL_BYTES = 6   # rgb 3, depth 2, mask 1
GROUP_BYTES = 17  # centroid 12, count 4, valid 1
COUNT_BYTES = 8   # two int32 counts a block of kernel P


def _round16(n: int) -> int:
    return (n + 15) & ~15


def p_blocks(h: int, w: int, cell_px: int, mode: str = "parity") -> int:
    """Kernel P's blocks for one (h, w) frame: strips of up to 32 cells of
    one cell row, as many as fit its shared-memory budget."""
    nv = 6 if mode == "votes" else 3

    def nbytes(t: int, staged: bool) -> int:
        pitch = _round16(t * cell_px)
        return cell_px * pitch * (6 + (4 * nv + 1 if staged else 0)) + (
            cell_px * pitch // 2 if staged else 0)

    tile, staged = TILE_CELLS, True
    while tile > 1 and nbytes(tile, True) > TILE_BUDGET:
        tile >>= 1
    if nbytes(tile, True) > MAX_DYN_SMEM:
        staged = False
        while tile > 1 and nbytes(tile, False) > TILE_BUDGET:
            tile >>= 1
    if nbytes(tile, staged) > MAX_DYN_SMEM:
        raise ValueError(f"a cell of {cell_px} px does not fit kernel P's block")
    n_cols, n_rows = -(-w // cell_px), -(-h // cell_px)
    return -(-n_cols // tile) * n_rows


def split_cells_bound(stream_launches: int, blocks: int, cells: int, pixels: int, slots: int,
                      groups: int):
    """(least ms, what bounds it) of kernel X over ``stream_launches``
    stream-frames of a frame with ``blocks`` blocks of kernel P, in which it
    found ``cells`` cells with a split channel holding ``pixels`` pixels,
    scanned ``slots`` row slots and wrote ``groups`` groups."""
    nbytes = (stream_launches * blocks * COUNT_BYTES + cells + pixels * PIXEL_BYTES + slots
              + groups * GROUP_BYTES)
    return roofline.bound(nbytes, pixels * roofline.OPS_PER_PIXEL)


def split_cells_us(trace):
    """(launches, summed device µs) of kernel X in ``trace``, or None where
    the trace's count differs from its launch counter or it never ran."""
    events = [e for e in trace.device if base_name(e[0]) in X_NAMES]
    counted = trace.counts.get(X_COUNTER, 0)
    if counted == 0 or len(events) != counted:
        return None
    return len(events), sum(e[2] - e[1] for e in events)
