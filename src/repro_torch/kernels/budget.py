"""Shared-memory budget of the port's kernels on Hopper.

The port of ``repro.kernels.budget``.  Where the reference budgets a
TPU core's VMEM, the port budgets what one CUDA block may hold on an
H100 (sm_90): 227 KB (232,448 bytes) of shared memory, of which at most
48 KB may be static; anything above that is dynamic shared memory and
needs ``cudaFuncAttributeMaxDynamicSharedMemorySize`` set on the
kernel.  Every number the stage-count heuristics of
:mod:`repro_torch.kernels.spec` rely on lives here, and
:func:`check_smem` refuses, before a launch, a plan the card would
refuse.
"""
from __future__ import annotations

__all__ = [
    "LANE",
    "ELEM_BYTES",
    "SMEM_PER_BLOCK",
    "STATIC_SMEM_MAX",
    "PIPELINE_BUFFERS",
    "MAX_DEPTH",
    "ROW_RING_BYTES",
    "ROW_WARPS",
    "ROW_THREADS",
    "ROW_WIDE_N",
    "ROW_BLOCKS_PER_SM",
    "MAX_ROW_BM",
    "ROW_HOLD_ROUNDS",
    "ROW_HOLD_N",
    "ROW_HOLD_BLOCKS_PER_SM",
    "WARP_HOLD",
    "INT_THREADS",
    "INT_BLOCKS_PER_SM",
    "INT_WIDE_PAIRS",
    "SMS",
    "SMEM_PER_SM",
    "SMEM_RESERVED_PER_BLOCK",
    "SMEM_ALLOC_UNIT",
    "round_up",
    "check_smem",
]

# row-sum grouping of the divider family (one lane per CUDA thread)
LANE = 128
ELEM_BYTES = 4

# streaming multiprocessors of an H100 SXM
SMS = 132

# dynamic + static shared memory one block may use on an H100
SMEM_PER_BLOCK = 232_448
# shared memory of one SM (the largest carveout), what the runtime
# reserves for each resident block, and the unit a block's shared memory
# is allocated in: the blocks of B bytes one SM holds at once are
# SMEM_PER_SM // (round_up(B, SMEM_ALLOC_UNIT) + SMEM_RESERVED_PER_BLOCK)
SMEM_PER_SM = 233_472
SMEM_RESERVED_PER_BLOCK = 1024
SMEM_ALLOC_UNIT = 128
# static (``__shared__``) shared memory a kernel may declare
STATIC_SMEM_MAX = 48 * 1024

# stages in flight when a spec leaves the depth to the heuristic; the
# reference's default, so every call runs the pipelined form (K7 / K8)
PIPELINE_BUFFERS = 2
MAX_DEPTH = 8

# K8: the input ring of one row-slab block (depth x bm rows) stays under
# this many bytes where a slab holds more than one row, and a slab holds
# at most MAX_ROW_BM rows.  A block runs ROW_WARPS warps: from
# ROW_WIDE_N elements a row all of them share one row (one thread per
# grouping lane), below it each warp takes a row of its own.  The
# kernel's launch bounds promise ROW_BLOCKS_PER_SM resident blocks (at
# most 64 registers a thread), the most a grid assumes an SM holds
ROW_RING_BYTES = 96 * 1024
ROW_WARPS = 4
ROW_THREADS = ROW_WARPS * 32
ROW_WIDE_N = 512
ROW_BLOCKS_PER_SM = 8
MAX_ROW_BM = 32

# K2 / K3 (the row dividers at depth 1) read each row once onto the
# chip.  The four-warp form copies a row's first ROW_HOLD_ROUNDS rounds
# of LANE (ROW_HOLD_N elements) into shared memory, two row buffers a
# block, so rows up to ROW_HOLD_N elements are read once; past it the
# rest of each lane's chain is streamed, read again (from L2) for the
# divides.  Its launch bounds promise ROW_HOLD_BLOCKS_PER_SM resident
# blocks.  A lane of the one-warp form holds WARP_HOLD values in
# registers (its rows x rounds x 4), under K8's ROW_BLOCKS_PER_SM
ROW_HOLD_ROUNDS = 32
ROW_HOLD_N = LANE * ROW_HOLD_ROUNDS
ROW_HOLD_BLOCKS_PER_SM = 4
WARP_HOLD = 16

# The streaming kernels, K9 / K10 (csrc/rapid_int.cu) and K5 / K6
# (csrc/fused_div.cu): threads a block, and the blocks an SM holds, which
# the launched instance's launch bounds promise (4 leave 64 registers a
# thread).  From INT_WIDE_PAIRS elements K9 / K10 index in 64 bits (K5 /
# K6 take fewer than 2^31)
INT_THREADS = 256
INT_BLOCKS_PER_SM = 4
INT_WIDE_PAIRS = 1 << 31


def round_up(v: int, mult: int) -> int:
    """Smallest multiple of ``mult`` >= ``v``."""
    return -(-v // mult) * mult


def check_smem(nbytes: int, what: str = "kernel") -> None:
    """Raise if a block would need more shared memory than the card
    gives one block (the launch would be refused)."""
    if nbytes > SMEM_PER_BLOCK:
        raise ValueError(
            f"{what}: {nbytes} B of shared memory per block exceeds the "
            f"H100's {SMEM_PER_BLOCK} B "
            "(repro_torch.kernels.budget.SMEM_PER_BLOCK)")
