"""Device kernels a solve in the trace of the traced solves."""


def read(ctx):
    if ctx.entry != "solve" or ctx.trace is None or not ctx.trace.kernels:
        return None
    return len(ctx.trace.kernels) / len(ctx.traced_counts)
