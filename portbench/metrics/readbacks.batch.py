"""Host read-backs a batch: the port's own counter
(``enlsip_tpu_torch._device.readback_count``) over the window's batches."""


def read(ctx):
    if ctx.entry != "batch" or not ctx.n_calls:
        return None
    return ctx.readbacks / ctx.n_calls
