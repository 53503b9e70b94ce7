"""Mean device ms of one iteration of a solve (one WHILE trip of the
solver's loop, an ``iteration`` span stamped on the card) over the
window's solves."""

from portbench import spans


def read(ctx):
    if ctx.entry != "solve":
        return None
    return spans.mean_ms(ctx, "solve", "iteration")
