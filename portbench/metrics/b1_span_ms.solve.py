"""Device ms a solve in B1's factorizations, from the program's own
record of each call: the ``cpqr`` spans stamped on the card whose route
is B1's (``resident``, ``panels``, ``b1_lanes``), over the traced
solves, the solves whose kernels ``b1_ms.solve`` reads.  The route is
the dispatch's, so no kernel name is read."""

from portbench import spans


def read(ctx):
    if ctx.entry != "solve":
        return None
    return spans.route_ms(ctx, "solve", ("resident", "panels", "b1_lanes"))
