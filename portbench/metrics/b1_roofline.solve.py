"""B1's share of its roofline in the traced solves, in %: the least time
of the factorizations the solves need, over the device time of B1's
kernels (``cpqr_resident``, ``cpqr_panels``).

The work is counted from the problem's shapes and the iteration count,
not from what ran: every iteration, and the last pass that ends the
solve, factors A_act^T (n x t, t steps) and J2 (m x (n - t), n - t
steps), t the active constraints at the solution (the equalities of
Chained Rosenbrock: t = n - 2); each at the frozen ``cpqr_bound`` of
``work/cpqr.py``.  A later kernel or route that replaces B1 leaves the
count unchanged."""

from portbench.work.cpqr import cpqr_bound

KERNELS = ("cpqr_resident", "cpqr_panels")


def least_ms_per_pass(n, m, t, itemsize):
    return (cpqr_bound(n, t, t, itemsize)[0]
            + cpqr_bound(m, n - t, n - t, itemsize)[0])


def read(ctx):
    if ctx.entry != "solve" or ctx.trace is None:
        return None
    spans = [e - s for name, s, e in ctx.trace.kernels
             if any(k in name for k in KERNELS)]
    if not spans:
        return None
    p = ctx.problem
    per_pass = least_ms_per_pass(p["n"], p["m"], p["active_at_solution"],
                                 ctx.itemsize)
    least = sum((c["iterations"] + 1) * per_pass for c in ctx.traced_counts)
    return 100.0 * least / (sum(spans) * 1e-3)
