"""What the readers of the program's spans share.

The port records spans (``enlsip_tpu_torch.utils.profiling``): host spans
of its API (``api.solve``, ``api.solve_batched``) and, for the solve
itself, spans stamped on the card inside the captured graph (``solve``,
``batch``, ``iteration``, ``trip``, ``cpqr`` with its route, ...), each
record with the ordinal of the call it belongs to on its clock.  Tracing
is on while a profiler session is open, so a ``--trace 1`` run records
every call of its set-up, its window and its traced calls.

A reader returns None, never a guess, where the records it needs are
not there: a program without spans, a ring that lost the window's start.
"""

from __future__ import annotations


def records():
    """Every span the program recorded, or None where it records none."""
    try:
        from enlsip_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    return None if read is None else read()


def ms(r) -> float:
    return (r.end_ns - r.start_ns) * 1e-6


def calls(ctx, name: str):
    """``(window, traced)``: the records named ``name`` (one a call: the
    call's root span, or its API span) of the window's calls, the
    ``ctx.n_calls`` complete calls before the last ``len(ctx.traced_counts)``,
    and of those traced calls.  None where fewer are recorded."""
    recs = records()
    if recs is None:
        return None
    roots = [r for r in recs if r.name == name]
    t, n = len(ctx.traced_counts), ctx.n_calls
    if n == 0 or t == 0 or len(roots) < n + t:
        return None
    k = len(roots) - t
    return roots[k - n:k], roots[k:]


def within(roots, name: str, routes=None) -> list:
    """The records named ``name`` (of a ``route`` in ``routes``, where
    given) that belong to the calls of ``roots``."""
    if not roots:
        return []
    clock, ids = roots[0].clock, {r.call for r in roots}
    return [r for r in records() if r.name == name and r.clock == clock
            and r.call in ids
            and (routes is None or r.attrs.get("route") in routes)]


def api_ms(ctx, api: str, root: str):
    """Mean over the window's calls of the API's host span less the
    call's root span on the card, in ms."""
    got, dev = calls(ctx, api), calls(ctx, root)
    if got is None or dev is None:
        return None
    pairs = list(zip(got[0], dev[0]))
    return sum(ms(a) - ms(d) for a, d in pairs) / len(pairs)


def mean_ms(ctx, root: str, name: str):
    """Mean ms of a ``name`` span over the window's calls."""
    got = calls(ctx, root)
    if got is None:
        return None
    inner = within(got[0], name)
    return sum(ms(r) for r in inner) / len(inner) if inner else None


def route_ms(ctx, root: str, routes):
    """Device ms a traced call in ``cpqr`` spans of the given routes (the
    traced calls: the calls the kernel readers of the same layer read)."""
    got = calls(ctx, root)
    if got is None:
        return None
    inner = within(got[1], "cpqr", routes)
    return sum(ms(r) for r in inner) / len(got[1]) if inner else None


def self_ms(ctx, root: str):
    """Mean device ms, over the window's calls, of the ``root`` span less
    its children: the graph's own nodes between the stages (the WHILE
    node's trips and conditions, and for a batch its result)."""
    got = calls(ctx, root)
    if got is None:
        return None
    recs = records()
    window = {r.call for r in got[0]}
    inner = dict.fromkeys(window, 0.0)
    for r in recs:
        if r.parent is not None and r.call in window and \
                r.clock == got[0][0].clock and recs[r.parent].name == root:
            inner[r.call] += ms(r)
    return sum(ms(r) - inner[r.call] for r in got[0]) / len(got[0])
