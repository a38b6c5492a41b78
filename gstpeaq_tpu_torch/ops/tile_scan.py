"""The host's side of csrc/tile_scan.cuh, shared by D3 (ops/cuda_dc.py) and
D1 (ops/cuda_fb.py): the launch plan of a first-order recurrence along rows
cut into tiles, one block each, and the exponents n of the powers a^n that
the kernels read, which each wrapper computes in float64.
"""

from __future__ import annotations

# csrc/tile_scan.cuh's kRun, kThreads, kTile and kGridLimit: a thread scans
# a run of RUN samples, a block of THREADS threads one tile of TILE samples.
RUN = 8
THREADS = 256
TILE = RUN * THREADS
LANES = 32            # a warp; it folds the carry in LANES segments
GRID_LIMIT = 2**31 - 1


def launch_plan(rows: int, t: int, name: str) -> tuple[int, int, int]:
    """(tiles, seg, blocks) of kernel `name` on [rows, t]: each row in
    `tiles` tiles of TILE samples (the last one ragged), one block each,
    `blocks` in all; a block folds its row's earlier tiles into its entry
    state in LANES segments of `seg` tiles."""
    tiles = -(-t // TILE)
    seg = -(-tiles // LANES)
    blocks = rows * tiles
    if blocks > GRID_LIMIT:
        raise ValueError(f"{name}: {rows} rows of {t} samples need "
                         f"{blocks} blocks, above CUDA's {GRID_LIMIT}")
    return tiles, seg, blocks


def scan_exponents(seg: int) -> list[int]:
    """The n of each power a^n after a itself, in the order tile_scan.cuh's
    Powers holds them: the warp scan's steps over runs (RUN 2^e), one warp
    (RUN LANES), one tile (TILE), the carry scan's steps over segments
    (TILE seg 2^e)."""
    return ([RUN << e for e in range(5)] + [RUN * LANES, TILE]
            + [TILE * seg << e for e in range(5)])


def real_powers(a: float, seg: int) -> list[float]:
    """a and each a^n of scan_exponents(seg), in float64."""
    return [a, *(a ** n for n in scan_exponents(seg))]
