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

The solve is device-resident, as the JAX package's jitted ``run_chunk``
is: on a CUDA device with NCCL, init, the whole loop and its collectives
are ONE captured graph on every rank (the collectives inside the
conditional nodes' bodies), replayed once and read back once.  A gloo
group moves a card's tensors through host memory, which a graph cannot
hold: ``graph=False`` runs the eager loop (one read-back a branch).

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
from torch.utils import _pytree as pytree

from .. import _graph
from .._device import to_host, to_host_list
from .._dist import Mesh, check_capturable, make_mesh, row_scope
from .._lanes import _dense_state
from ..core.driver import (Functions, _solve_carry_graph, init_carry,
                           iterate_body)
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
                     on_iteration: Optional[Callable[[Carry], None]] = None,
                     graph: bool = True) -> Carry:
    """Solve ONE giant-m instance with its residual rows sharded over
    ``mesh`` (``fns``: this rank's closures, see the module docstring).
    ``dims.m`` must divide over the ranks.  Returns the final carry, the
    same on every rank apart from its own rows of rx and J.

    ``tsqr=True`` sets ``Options.tsqr_axis``: J2 always takes a two-stage
    factorization (CholeskyQR with ``tall_qr="cholqr"``, the TSQR of the
    ranks' blocks with ``"qr"``; one collective a factorization) instead
    of the pivot loop's two collectives a step; it needs m / D >= n.

    ``graph`` (default): the solve is device-resident, ONE replay of a
    captured graph on a CUDA device (a CPU rehearsal of the same code on
    the CPU) and ONE read-back on each rank, of the exit code and the
    iteration count (``solve_rowsharded.last``).  ``graph=False`` runs
    the eager loop, which ``on_iteration(carry)`` needs (it is called
    after every iteration, on the host); a gloo group with a card's
    tensors needs it too.  Neither switches by itself: both raise with
    ``graph=True``."""
    mesh = mesh or row_mesh(axis=axis)
    if graph and on_iteration is not None:
        raise ValueError("on_iteration needs the host after every "
                         "iteration: pass graph=False")
    if graph:
        check_capturable(mesh, mesh.device)
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
    x0 = torch.as_tensor(x0).to(device=dev, dtype=dtype)
    with row_scope(mesh), matmul_precision_scope(opts), \
            _graph.linalg_scope(dev):
        if graph:
            out, head = _solve_carry_graph(x0, tols, fns, dims, opts, dtype)
            _check_rows(out, rows, mesh)
            carry = pytree.tree_map(
                lambda a: a.clone() if isinstance(a, torch.Tensor) else a,
                out)
            solve_rowsharded.last = tuple(to_host_list(head))
            return carry
        carry = init_carry(fns, x0, dims, opts, dtype, device=dev)
        _check_rows(carry, rows, mesh)
        # the layout a WHILE node's buffers give the graph's trips
        carry = _dense_state(carry)
        while to_host(carry.exit_code) == 0:
            carry = iterate_body(carry, fns, dims, opts, tols)
            if on_iteration is not None:
                on_iteration(carry)
    return carry


solve_rowsharded.last = None


def _check_rows(carry: Carry, rows: int, mesh: Mesh) -> None:
    if carry.rx.shape[-1] != rows:
        raise ValueError(
            f"res returned {carry.rx.shape[-1]} rows; a rank of "
            f"{mesh.size} holds {rows} (pass rank-local closures, "
            "e.g. local_functions)")
