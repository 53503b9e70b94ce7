"""Mean device ms of one lockstep trip of a batch (a ``trip`` span
stamped on the card) over the window's batches."""

from portbench import spans


def read(ctx):
    if ctx.entry != "batch":
        return None
    return spans.mean_ms(ctx, "batch", "trip")
