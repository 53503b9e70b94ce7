"""Device ms a batch in the exact Hessian contractions of every lane (the
``hessian`` spans stamped on the card inside the ``newton`` ones), over
the traced batches.  None where the program stamps no such span."""

from portbench import spans


def read(ctx):
    if ctx.entry != "batch":
        return None
    got = spans.calls(ctx, "batch")
    if got is None:
        return None
    inner = spans.within(got[1], "hessian")
    return sum(spans.ms(r) for r in inner) / len(got[1]) if inner else None
