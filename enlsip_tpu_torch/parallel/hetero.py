"""Heterogeneous fused batching: instances of DIFFERENT problem families
solved in ONE batched solve.

Counterpart of ``enlsip_tpu/parallel/hetero.py``.  Families have
different (n, m, q, l); the fused batch pads every family into shared
max-size buffers and threads the TRUE dimensions through the solver as
per-lane :class:`~enlsip_tpu_torch.core.types.RDims` (the decision logic
compares against them; the factorizations run on the padded buffers).
The padding is inert:

* residuals: rows >= m_f are exactly 0 (zero J rows, nothing added to
  ||r||^2);
* parameters: coordinates >= n_f never enter a closure, so their
  Jacobian columns are 0 — the pivoted factorizations treat them like
  the dead columns they already handle (ties go to the lowest index, so
  a zero column never leads a live one), and the Newton block leaves
  them out;
* constraints: rows >= l_f return the constant ``PAD_CX`` (large,
  positive, zero A rows) — never activated by INIALC/EVADD, never
  violated, never capping a step — and the driver's ||c||^2 leaves them
  out (``core/driver._cx_sq_sum``).

Per lane the trajectory is that of the same instance in its family's own
batch up to rounding (the padded buffers change how some sums are
ordered).

**The union closures.**  A lane's ``data["fam"]`` names its family.  The
JAX package selects a branch with ``lax.switch``; JAX differentiates each
branch on its own and only then, under ``vmap``, turns the switch into a
select, so a branch that overflows at another family's point never
reaches the selected lane's derivatives.  Here every family is evaluated
on every lane under ``torch.func.vmap`` (no Python branch on a tensor)
and the outputs are selected with ``torch.where`` — but a select AFTER
the call alone is not enough.  Reverse mode (the Newton direction's
Hessian is ``jacrev`` of ``jacrev``) sends a zero
cotangent into each unselected branch; a branch that overflowed at the
lane's point (hs57's ``exp(-x1 (a - 8))`` is inf in float32 for x1 below
about -2.6, an ordinary coordinate of another family) turns it into
0 * inf = NaN, and that NaN is summed into the lane's x cotangent.  So
each family's closure also gets ``x`` only on lanes of that family:
``torch.where(fam == i, x, x_safe_i)`` BEFORE the call, where
``x_safe_i`` is a fixed start of family i (its first lane's, padded).
Whatever branch i computes on another family's lane then flows back only
into the constant ``x_safe_i``: the select's backward (and its forward
tangent) is a select, never a product, so every lane gets exactly its
own family's values and first and second derivatives.

No reference counterpart: the reference (Enlsip.jl) solves one instance
at a time.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .._device import resolve_device
from ..core.driver import Functions
from ..core.types import Dims, Options, RDims
from .batch import BatchResult, solve_batched
from .suite import _no_mesh

PAD_CX = 1e4  # inert padding constraint value (>> EVADD's delta = 0.1)


class FusedSuite(NamedTuple):
    """A fused heterogeneous batch ready for one solve_batched call."""

    fns: Functions        # union closures taking (x, data)
    dims: Dims            # buffer maxima over all families
    x0: torch.Tensor      # (B, n_max) zero-padded starts, float64
    data: dict            # {'fam': (B,) int64}
    rdims: RDims          # per-lane true dims, (B,) int64 leaves
    slices: dict          # {family name: slice into the B lanes}
    fstar: dict           # {family name: known optimum or None}


def _pad_family(fns: Functions, d: Dims, dmax: Dims) -> Functions:
    """Closures over the padded x that compute with the family's true
    leading coordinates and emit padded, inert outputs."""
    n, m, l = d.n, d.m, d.l
    N, M, L = dmax.n, dmax.m, dmax.l

    def res(x):
        return F.pad(fns.res(x[:n]).to(x.dtype), (0, M - m))

    def jac_res(x):
        return F.pad(fns.jac_res(x[:n]).to(x.dtype), (0, N - n, 0, M - m))

    def cons(x):
        return F.pad(fns.cons(x[:n]).to(x.dtype), (0, L - l), value=PAD_CX)

    def jac_cons(x):
        return F.pad(fns.jac_cons(x[:n]).to(x.dtype), (0, N - n, 0, L - l))

    return Functions(res=res, jac_res=jac_res, cons=cons, jac_cons=jac_cons)


def _union(branches, x_safe: dict):
    """``f(x, data)``: family ``data["fam"]``'s branch at ``x``, each
    branch fed ``x`` only on its own lanes (see the module docstring).
    ``x_safe[dtype]`` is a (families, n_max) tensor of fixed points."""
    def f(x, data):
        fam = data["fam"]
        safe = x_safe[x.dtype]
        out = None
        for i, branch in enumerate(branches):
            mine = fam == i
            y = branch(torch.where(mine, x, safe[i]))
            out = y if out is None else torch.where(mine, y, out)
        return out

    return f


def fuse_families(families: dict, device=None) -> FusedSuite:
    """Build the union closures + per-lane metadata for one fused batch
    on ``device`` (default: the card; raises if there is none).

    ``families``: {name: FamilySpec} as produced by
    :func:`enlsip_tpu_torch.parallel.suite.hs_scenario_batch`.
    """
    dev = resolve_device(device)
    specs = list(families.items())
    dmax = Dims(n=max(s.dims.n for _, s in specs),
                m=max(s.dims.m for _, s in specs),
                q=max(s.dims.q for _, s in specs),
                l=max(s.dims.l for _, s in specs))
    padded = [_pad_family(s.fns, s.dims, dmax) for _, s in specs]

    x0s, fam_ids, rd_rows, slices = [], [], [], {}
    off = 0
    for fid, (name, s) in enumerate(specs):
        x0f = torch.as_tensor(s.x0_batch).to(device=dev, dtype=torch.float64)
        Bf = x0f.shape[0]
        x0s.append(F.pad(x0f, (0, dmax.n - s.dims.n)))
        fam_ids.append(torch.full((Bf,), fid, device=dev))
        rd_rows.append(torch.tensor([s.dims.n, s.dims.m, s.dims.q, s.dims.l],
                                    device=dev).expand(Bf, 4))
        slices[name] = slice(off, off + Bf)
        off += Bf
    x0 = torch.cat(x0s)
    # each family's fixed point: its first lane's start
    safe = x0[[sl.start for sl in slices.values()]]
    x_safe = {torch.float64: safe, torch.float32: safe.to(torch.float32)}
    fns = Functions(*(_union([getattr(p, field) for p in padded], x_safe)
                      for field in ("res", "jac_res", "cons", "jac_cons")))
    rd = torch.cat(rd_rows)
    return FusedSuite(
        fns=fns, dims=dmax, x0=x0, data={"fam": torch.cat(fam_ids)},
        rdims=RDims(n=rd[:, 0], m=rd[:, 1], q=rd[:, 2], l=rd[:, 3]),
        slices=slices, fstar={name: s.fstar for name, s in specs})


def solve_suite_fused(families: dict, opts: Options, tols_fn,
                      mesh=None, dtype=torch.float32, fused=None,
                      escalate_f64: bool = False,
                      device=None) -> dict:
    """Solve a mixed-family scenario batch as ONE fused batch; returns
    {name: BatchResult} (split back per family).  Runs on ``device``
    (default: the card; raises if there is none).

    Compare :func:`enlsip_tpu_torch.parallel.suite.solve_suite_batched`,
    which runs one batch per family.

    ``fused``: optional prebuilt :func:`fuse_families` result.  In the
    JAX package it is the jit cache key; PyTorch compiles nothing here,
    so reusing one only saves rebuilding the closures.
    ``escalate_f64``: re-solve the lanes with exit code <= 0 at float64
    (``parallel.batch.escalate_lanes_f64``, which carries their RDims)."""
    _no_mesh(mesh)
    if fused is None:
        fused = fuse_families(families, device)
    res = solve_batched(fused.fns, fused.x0, fused.dims, opts,
                        tols_fn(dtype), dtype=dtype, data=fused.data,
                        rdims=fused.rdims, escalate_f64=escalate_f64,
                        device=device)
    out = {}
    for name, sl in fused.slices.items():
        nf = families[name].dims.n
        out[name] = BatchResult(
            exit_code=res.exit_code[sl], x=res.x[sl, :nf], f=res.f[sl],
            n_iter=res.n_iter[sl],
            counters=type(res.counters)(*(c[sl] for c in res.counters)),
            escalated=(None if res.escalated is None
                       else res.escalated[sl]))
    return out
