"""Mean iterations a solve in the window, from each solve's result (the
rows of ``model_info.iterations_detail``)."""


def read(ctx):
    its = [c["iterations"] for c in ctx.counts if "iterations" in c]
    return sum(its) / len(its) if its else None
