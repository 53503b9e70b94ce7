"""Device milliseconds a solve in B1's kernels, from the trace of the
traced solves.  B1 is the port's column-pivoted QR of one matrix:
``cpqr_resident`` (csrc/cpqr.cu) where the matrix fits shared memory,
``cpqr_panels`` (csrc/cpqr_panels.cu) elsewhere.  None where neither ran
(a solve whose factorizations all take the rank-1 route)."""

KERNELS = ("cpqr_resident", "cpqr_panels")


def read(ctx):
    if ctx.entry != "solve" or ctx.trace is None:
        return None
    spans = [e - s for name, s, e in ctx.trace.kernels
             if any(k in name for k in KERNELS)]
    if not spans:
        return None
    return sum(spans) * 1e-3 / len(ctx.traced_counts)
