"""Host read-backs a solve: the port's own counter
(``enlsip_tpu_torch._device.readback_count``) over the window's solves.
Since the solve became one graph replay it reads 1."""


def read(ctx):
    if ctx.entry != "solve" or not ctx.n_calls:
        return None
    return ctx.readbacks / ctx.n_calls
