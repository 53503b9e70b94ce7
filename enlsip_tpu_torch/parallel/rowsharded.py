"""Giant-m problems: one solve with its residual rows sharded over ranks.

Counterpart of ``enlsip_tpu/parallel/rowsharded.py`` on
``torch.distributed``.  The long axis — the m residual rows of r and J
and everything made from them (JQ1, the J2 buffer and its reflectors) —
is split into D contiguous blocks of m / D rows, one a rank (rank-major),
while the small n-space core (x, the active set, every triangular
factor, every decision) is replicated: each rank computes it from the
same reduced values, so every rank takes the same host branches and ends
with the same x to the bit.

Where GSPMD partitions the JAX package's jitted iteration, this package
states the collectives: inside ``_dist.row_scope`` every contraction over
the rows is a local product plus one ``all_reduce`` (``rows_sum`` in
``core/``), J2 takes the distributed pivot loop of ``ops/rows_qr.py``
(``tsqr=False``: two n-vector collectives a pivot step) or the two-stage
factorizations of ``ops/tsqr.py`` (a tall J2, or ``tsqr=True``: one
collective a factorization).  On the card each rank's block goes through
the same fused WY kernels as a one-card solve, gated on the block's
shape; their Gram and projection are then summed by that one collective.

The user passes RANK-LOCAL closures: ``res`` returns this rank's m / D
residuals, ``jac_res`` its (m / D, n) block, ``jac_rowscale`` /
``jac_base`` / ``res_trial`` its rows; ``cons`` / ``jac_cons`` are
replicated.  ``dims.m`` stays the global m.  :func:`local_functions`
slices closures of the whole problem for small problems and tests;
``problems/giant_m.py`` draws a rank's rows of the benchmark problem.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from .._device import to_host
from .._dist import Mesh, make_mesh, row_scope
from ..core.driver import Functions, init_carry, iterate_body
from ..core.types import (Carry, Dims, Options, Tols,
                          matmul_precision_scope)


def row_mesh(group=None, device=None, axis: str = "rows") -> Mesh:
    """The 1-D mesh over the residual rows (see ``_dist.make_mesh``)."""
    return make_mesh(group, device, axis)


def local_functions(fns: Functions, dims: Dims, mesh: Mesh) -> Functions:
    """This rank's closures of a problem given by closures of the whole
    problem: each residual-row output sliced to the rank's block.  Every
    call still evaluates the whole problem, so this is for small
    problems and tests."""
    rows = dims.m // mesh.size
    sl = slice(mesh.rank * rows, (mesh.rank + 1) * rows)

    def rows_of(f):
        return None if f is None else (lambda *a: f(*a)[sl])

    trial = None if fns.res_trial is None else \
        (lambda x, p: rows_of(fns.res_trial(x, p)))
    return Functions(res=rows_of(fns.res), jac_res=rows_of(fns.jac_res),
                     cons=fns.cons, jac_cons=fns.jac_cons, res_trial=trial,
                     jac_rowscale=rows_of(fns.jac_rowscale),
                     jac_base=rows_of(fns.jac_base))


def solve_rowsharded(fns: Functions, x0, dims: Dims, opts: Options,
                     tols: Tols, mesh: Optional[Mesh] = None,
                     axis: str = "rows", dtype=None, tsqr: bool = False,
                     on_iteration: Optional[Callable[[Carry], None]] = None
                     ) -> Carry:
    """Solve ONE giant-m instance with its residual rows sharded over
    ``mesh`` (``fns``: this rank's closures, see the module docstring).
    ``dims.m`` must divide over the ranks.  Returns the final carry, the
    same on every rank apart from its own rows of rx and J.

    ``tsqr=True`` sets ``Options.tsqr_axis``: J2 always takes a two-stage
    factorization (CholeskyQR with ``tall_qr="cholqr"``, the TSQR of the
    ranks' blocks with ``"qr"``; one collective a factorization) instead
    of the pivot loop's two collectives a step; it needs m / D >= n.
    ``on_iteration(carry)`` is called after every iteration."""
    mesh = mesh or row_mesh(axis=axis)
    if dims.m % mesh.size:
        raise ValueError(f"m = {dims.m} rows do not divide over "
                         f"{mesh.size} ranks")
    rows = dims.m // mesh.size
    if tsqr:
        opts = dataclasses.replace(opts, tsqr_axis=mesh.axis)
        if rows < dims.n:
            raise ValueError("tsqr needs m / D >= n row panels")
    if dtype is None:
        dtype = x0.dtype if isinstance(x0, torch.Tensor) else torch.float64
    dev = mesh.device
    tols = Tols(*(torch.as_tensor(v).to(device=dev, dtype=dtype)
                  for v in tols))
    with row_scope(mesh), matmul_precision_scope(opts):
        carry = init_carry(fns, x0, dims, opts, dtype, device=dev)
        if carry.rx.shape[-1] != rows:
            raise ValueError(
                f"res returned {carry.rx.shape[-1]} rows; a rank of "
                f"{mesh.size} holds {rows} (pass rank-local closures, "
                "e.g. local_functions)")
        while to_host(carry.exit_code) == 0:
            carry = iterate_body(carry, fns, dims, opts, tols)
            if on_iteration is not None:
                on_iteration(carry)
    return carry
