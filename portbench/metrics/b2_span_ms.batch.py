"""Device ms a batch in B2's factorizations: the ``cpqr`` spans stamped
on the card whose route is ``b2``, over the traced batches."""

from portbench import spans


def read(ctx):
    if ctx.entry != "batch":
        return None
    return spans.route_ms(ctx, "batch", ("b2",))
