"""B2's share of its roofline in the traced batches, in %: the least time
of the batched factorizations the batches need, over the device time of
B2's kernel (``cpqr_batched_kernel``, csrc/cpqr_batched.cu).

The work is counted from the shapes and the trip count, not from what
ran: every lockstep trip factors A_act^T (lanes x n x t) and J2 (lanes x
m x (n - t)), t the active constraints at the solution (HS65: 1), each at
the frozen ``cpqr_batched_bound`` of ``work/cpqr.py``."""

from portbench.work.cpqr import cpqr_batched_bound

KERNELS = ("cpqr_batched_kernel",)


def read(ctx):
    if ctx.entry != "batch" or ctx.trace is None:
        return None
    spans = [e - s for name, s, e in ctx.trace.kernels
             if any(k in name for k in KERNELS)]
    if not spans:
        return None
    p = ctx.problem
    n, m, t, B = p["n"], p["m"], p["active_at_solution"], ctx.lanes
    per_trip = (cpqr_batched_bound(B, n, t, ctx.itemsize)[0]
                + cpqr_batched_bound(B, m, n - t, ctx.itemsize)[0])
    least = sum(c["trips"] * per_trip for c in ctx.traced_counts)
    return 100.0 * least / (sum(spans) * 1e-3)
