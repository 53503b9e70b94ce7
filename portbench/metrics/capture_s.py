"""Seconds the set-up spent capturing the cell's solve graph: the port's
own span (``enlsip_tpu_torch._graph.graph_stats()["capture_s"]``).  None
where nothing was captured (a run on the CPU)."""


def read(ctx):
    return ctx.capture_s if ctx.capture_s > 0 else None
