"""Device ms a solve spends in the graph's own loop nodes: the mean,
over the window's solves, of the ``solve`` span stamped on the card less
its children (``init``, each WHILE trip's ``iteration``, ``pack``): the
WHILE node's trips and conditions between the stages
(``portbench/spans.py``)."""

from portbench import spans


def read(ctx):
    if ctx.entry != "solve":
        return None
    return spans.self_ms(ctx, "solve")
