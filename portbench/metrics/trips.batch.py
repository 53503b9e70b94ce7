"""Mean lockstep trips a batch in the window
(``enlsip_tpu_torch.parallel.batch.run_batch.last_trips`` after each
batch): the slowest lane sets them."""


def read(ctx):
    trips = [c["trips"] for c in ctx.counts if "trips" in c]
    return sum(trips) / len(trips) if trips else None
