"""Operations, bytes and least time of a column-pivoted Householder QR
(CPQR), counted from its shapes alone.

Frozen copies of the arithmetic the port's kernel checks use
(``cpqr_work``, ``cpqr_bound``, ``cpqr_batched_bound``).  They take the
element size in bytes rather than a dtype, so this module imports
nothing but the peaks beside it.  The count does not depend on which
kernel or route factors the matrix.
"""

from __future__ import annotations

from .peaks import HBM_BYTES_PER_S, PEAK_FLOPS


def cpqr_work(rows: int, cols: int, nsteps: int, itemsize: int):
    """(least bytes, flops, streamed bytes) of a CPQR with ``nsteps``
    steps.  Least bytes: the matrix read once and the packed result
    written once, plus tau and perm.  Flops: 2 per element for the first
    norms, then per step 2 (v^T B) + 2 (rank-1 update) + 2 (next norms)
    on the trailing block.  Streamed bytes: what a step-by-step
    factorization whose matrix does not fit on chip must move: two reads
    and one write of the trailing block every step."""
    kmax = min(rows, cols)
    least = 2 * rows * cols * itemsize + kmax * itemsize + cols * 4
    flops = 2 * rows * cols
    streamed = rows * cols * itemsize
    for k in range(nsteps):
        blk = (rows - k) * (cols - k - 1)
        flops += 6 * blk
        streamed += 3 * blk * itemsize
    return least, flops, streamed


def cpqr_bound(rows: int, cols: int, nsteps: int, itemsize: int):
    """(least ms, what bounds it: "bytes" or "operations", streamed ms)
    of one CPQR at the published peaks."""
    least, flops, streamed = cpqr_work(rows, cols, nsteps, itemsize)
    t_bytes = least / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[itemsize] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            streamed / HBM_BYTES_PER_S * 1e3)


def cpqr_batched_bound(batch: int, rows: int, cols: int, itemsize: int):
    """(least ms, what bounds it) of one batch factorization: every
    matrix read once and its packed form written once, plus tau and perm,
    over the memory rate; 6 flops per trailing element per step, all
    min(rows, cols) steps, over the peak rate."""
    kmax = min(rows, cols)
    nbytes = 2 * batch * rows * cols * itemsize + batch * (kmax * itemsize
                                                          + 4 * cols)
    flops = 6 * batch * sum((rows - k) * (cols - k) for k in range(kmax))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[itemsize] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
