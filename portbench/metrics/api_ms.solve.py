"""Host ms a solve spends in the port's API outside the solve on the
card: the mean, over the window's solves, of the ``api.solve`` host span
less the ``solve`` span stamped on the card (``portbench/spans.py``).
The copies in, the graph launch, the read-back and the result."""

from portbench import spans


def read(ctx):
    if ctx.entry != "solve":
        return None
    return spans.api_ms(ctx, "api.solve", "solve")
