"""The launch shape of the dense-layout ADC kernel (``adc_slot_warps_kernel``)
in Python, for the tests: ``adc::slot_warps`` and ``adc::split_of`` of
``src/repro_torch/kernels/csrc/pq_scan.cu``, which pick the shape at every
launch. The CPU tests emulate the kernel's decomposition at these shapes;
``tests/test_torch_cuda.py`` holds this copy equal to the C entry
``adc_launch_shape`` on the card. Imports neither jax nor the reference.
"""
from repro_torch.kernels.fused_knn import SMEM_OPTIN_BYTES
from repro_torch.kernels.pq_scan import adc_smem_bytes

# adc::kWarps, kTileChunks, kLutKiB, kGridTarget, kMinRangeChunks, kChunk:
# most warps a block, 32-row chunks a tile holds at least, KiB of LUT rows a
# block stages at most when it takes more than one slot, blocks a split grid
# aims for (two waves of 3 on each of 132 SMs), chunks a split range holds at
# least, rows a chunk
WARPS, TILE_CHUNKS, LUT_KIB, GRID_TARGET, MIN_RANGE, CHUNK = 8, 4, 64, 2 * 3 * 132, 8, 32


def slot_warps(m: int, tq: int) -> tuple[int, int, int]:
    """(G, g, T): a block takes G live slots at a time, a slot's rows go to
    g warps (each every g-th 32-row chunk), a ring tile holds T chunks. G is
    the largest power of two with G·M ≤ 64 (64 KiB of LUT rows, three blocks
    an SM at M 8), at most 8 and no more than TQ needs; g fills eight warps,
    halved while the block does not fit shared memory; T is
    ``max(g, TILE_CHUNKS)`` where that fits, else g (G = g = T = 1 at the
    widest M)."""
    G = 1
    while 2 * G <= WARPS and 2 * G * m <= LUT_KIB and G < tq:
        G *= 2
    g = WARPS // G
    while g > 1 and adc_smem_bytes(m, G, g, g) > SMEM_OPTIN_BYTES:
        g //= 2
    T = max(g, TILE_CHUNKS)
    if adc_smem_bytes(m, G, g, T) > SMEM_OPTIN_BYTES:
        T = g
    return G, g, T


def adc_split(w: int, tq: int, tv: int, slots: int) -> tuple[int, int]:
    """(Y, S): blocks per unit, Y over its slot groups of ``slots`` slots
    (block y takes groups y, y + Y, ...) and then S over its rows, in ranges
    of whole 32-row chunks of at least ``MIN_RANGE``, until the grid reaches
    ``GRID_TARGET`` blocks. Groups come first: a group's LUT rows are staged
    once whichever block takes it, a range's once per range."""
    groups, nch = -(-tq // slots), -(-tv // CHUNK)
    Y = max(1, min(groups, GRID_TARGET // w))
    s = min(GRID_TARGET // (w * Y), nch // MIN_RANGE)
    if s <= 1:
        return Y, 1
    per = -(-nch // s)
    return Y, -(-nch // per)


def launch_shape(w: int, tq: int, tv: int, m: int, k: int) -> tuple[int, ...]:
    """(G, g, T, Y, S, scratch words), as ``adc_launch_shape`` writes them:
    the words hold the ranges' lists (scores, then ids) and a counter per
    (unit, slot group) where rows split, else 0."""
    G, g, T = slot_warps(m, tq)
    Y, S = adc_split(w, tq, tv, G)
    return G, g, T, Y, S, (2 * w * tq * S * k + w * -(-tq // G)) if S > 1 else 0
