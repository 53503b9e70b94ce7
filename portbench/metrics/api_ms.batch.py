"""Host ms a batch spends in the port's API outside the batch on the
card: the mean, over the window's batches, of the ``api.solve_batched``
host span less the ``batch`` span stamped on the card
(``portbench/spans.py``)."""

from portbench import spans


def read(ctx):
    if ctx.entry != "batch":
        return None
    return spans.api_ms(ctx, "api.solve_batched", "batch")
