"""Lane-steps by Newton a batch: the sum of the ``newton`` spans'
payloads (each the count of live lanes that chose the Newton method in
its trip, read on the card when the span's stamp ran), mean over the
window's batches.  None where the program stamps no such span."""

from portbench import spans


def read(ctx):
    if ctx.entry != "batch":
        return None
    got = spans.calls(ctx, "batch")
    if got is None:
        return None
    inner = [r for r in spans.within(got[0], "newton")
             if r.payload is not None]
    return sum(r.payload for r in inner) / len(got[0]) if inner else None
