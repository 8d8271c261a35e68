"""Tile-grid memory model (the port's copy of ``repro.memory.tiles``).

The reference pads the last two dims of every array to (sublane, lane)
tiles: (8, 128) for 4-byte types, (16, 128) for 2-byte, (32, 128) for
1-byte.  A logical tensor folded to (rows, cols) therefore occupies

    ceil(rows / sub) * sub * ceil(cols / 128) * 128 * itemsize

bytes -- the paper's Eq. 1 with W_BRAM = 128 lanes and D_BRAM = the sublane
count.  Co-locating several small tensors in one physical *bank* (rows
concatenated, cols padded to the max) amortizes the padding, which is the
paper's bin-packing problem on the tile grid.  The cardinality constraint
bounds the per-bank segment fan-out of the packed read
(`repro_torch.kernels.packed_gather`).

The grid is the reference's TPU grid, kept as it is so that plans are
held bit for bit against the reference; it is not a model of Hopper's
memory.
"""
from __future__ import annotations

from ..core.problem import BRAMSpec, Buffer, PackingProblem

LANES = 128
TILE_ROWS = {1: 32, 2: 16, 4: 8}  # itemsize -> sublane tile


def fold_2d(shape: tuple[int, ...]) -> tuple[int, int]:
    """Fold an N-D tensor to the (rows, cols) the tiler sees."""
    if len(shape) == 0:
        return (1, 1)
    if len(shape) == 1:
        return (1, int(shape[0]))
    rows = 1
    for s in shape[:-1]:
        rows *= int(s)
    return (rows, int(shape[-1]))


def padded_bytes(shape: tuple[int, ...], itemsize: int) -> int:
    rows, cols = fold_2d(shape)
    sub = TILE_ROWS.get(itemsize, 8)
    prows = -(-rows // sub) * sub
    pcols = -(-cols // LANES) * LANES
    return prows * pcols * itemsize


def logical_bytes(shape: tuple[int, ...], itemsize: int) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n * itemsize


def tile_bram_spec(itemsize: int) -> BRAMSpec:
    """The tile grid as a single-mode BRAM: one 'BRAM' = one (sub x 128)
    tile; 'bits' are elements (uniform dtype within a bank)."""
    sub = TILE_ROWS.get(itemsize, 8)
    return BRAMSpec(modes=((LANES, sub),), capacity_bits=LANES * sub)


def tile_grid_problem(
    entries: list[tuple[str, tuple[int, ...], int]],
    max_items: int = 4,
    name: str = "tpu-tiles",
) -> tuple[PackingProblem, list[str]]:
    """Build a PackingProblem over the tile grid.

    entries: (param_path, shape, itemsize) -- itemsize must be uniform.
    Buffer width = cols, depth = rows (transposed vs the FPGA convention
    where depth is the long axis; the core model is symmetric).  The layer
    id comes from the path's layer component when present (intra-layer
    packing keeps a layer's tensors in one bank).
    """
    itemsizes = {e[2] for e in entries}
    if len(itemsizes) != 1:
        raise ValueError("one packing problem per dtype class")
    itemsize = itemsizes.pop()
    buffers = []
    paths = []
    for path, shape, _ in entries:
        rows, cols = fold_2d(shape)
        buffers.append(Buffer(width=cols, depth=rows, layer=_layer_of(path), name=path))
        paths.append(path)
    prob = PackingProblem(
        buffers, bram=tile_bram_spec(itemsize), max_items=max_items, name=name
    )
    return prob, paths


def _layer_of(path: str) -> int:
    if "#" in path:  # split-stacked per-layer slice: layers/attn/q/kernel#7
        try:
            return int(path.rsplit("#", 1)[1])
        except ValueError:
            pass
    for part in path.split("/"):
        if part.startswith("layer_"):
            try:
                return int(part.split("_", 1)[1])
            except ValueError:
                pass
    return 0
