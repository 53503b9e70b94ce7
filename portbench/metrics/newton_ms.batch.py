"""Device ms a batch in the Newton section of the lockstep body: the
``newton`` spans stamped on the card (the Newton IF body, run in a trip
where some live lane steps by Newton), over the traced batches.  None
where the program stamps no such span."""

from portbench import spans


def read(ctx):
    if ctx.entry != "batch":
        return None
    got = spans.calls(ctx, "batch")
    if got is None:
        return None
    inner = spans.within(got[1], "newton")
    return sum(spans.ms(r) for r in inner) / len(got[1]) if inner else None
