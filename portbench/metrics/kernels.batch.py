"""Device kernels a batch in the trace of the traced batches."""


def read(ctx):
    if ctx.entry != "batch" or ctx.trace is None or not ctx.trace.kernels:
        return None
    return len(ctx.trace.kernels) / len(ctx.traced_counts)
