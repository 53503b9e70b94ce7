"""Device ms a batch spends in the graph's own loop nodes: the mean,
over the window's batches, of the ``batch`` span stamped on the card
less its children (``init``, each lockstep ``trip``): the WHILE node's
trips and conditions, and the batch's result (``portbench/spans.py``)."""

from portbench import spans


def read(ctx):
    if ctx.entry != "batch":
        return None
    return spans.self_ms(ctx, "batch")
