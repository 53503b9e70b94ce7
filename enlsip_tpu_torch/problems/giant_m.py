"""The giant-m data fit: millions of residual rows, a hundred parameters.

The package's own copy of the reference benchmark's tall problem
(``bench.py::bench_giant_m``; ``examples/giant_m.py`` at other sizes):

    r(x) = Y - phi(W x),   phi(z) = z + c tanh(z),   W (m, n) constant,

so the residual Jacobian is a row-scaled constant matrix,
``J(x) = diag(-(1 + c (1 - tanh(W x)^2))) @ W``, which is what the three
``Functions`` hooks exist for: ``jac_rowscale`` / ``jac_base`` hand the
solver the scale and the base instead of the 4 m n bytes of J, and
``res_trial`` evaluates line-search trials along the ray
``W x + alpha (W p)`` in O(m).

Constraints, all inequalities (>= 0): ``x_j >= blo_j`` for the first
``len(blo)`` parameters (with ``blo = xtrue[:5] + 0.2`` they cut off the
unconstrained optimum, so the solve ends with them ACTIVE),
``x_j + 5 >= 0`` for the next ``l - 1 - len(blo)``, and
``4 n - x.x >= 0``.

:func:`giant_m` draws the data ON THE DEVICE from an explicit
``torch.Generator`` (a 5,000,000 x 100 draw on the host costs gigabytes
and many seconds); :func:`giant_m_from_arrays` builds the same problem
from given arrays, so a test can hand both packages one numpy draw.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

import dataclasses

from .._device import resolve_device
from ..core.driver import Functions
from ..core.types import Dims


class GiantM(NamedTuple):
    factored: Functions     # res_trial + jac_rowscale/jac_base, no dense J
    dense: Functions        # the four plain callables, J materialized
    dims: Dims
    x0: torch.Tensor        # (n,) zeros
    xtrue: torch.Tensor     # (n,) the parameters the data was made from
    blo: torch.Tensor       # lower bounds of the leading parameters
    W: torch.Tensor         # (m, n)
    Y: torch.Tensor         # (m,)


NONLIN = 0.1        # c of phi(z) = z + c tanh(z)


def giant_m_from_arrays(W, Y, xtrue, blo, l: int, dtype=torch.float32,
                        device=None) -> GiantM:
    """The problem over given data (numpy arrays or tensors), on
    ``device`` (default: the card; raises if there is none)."""
    dev = resolve_device(device)
    conv = lambda a: torch.as_tensor(a).to(device=dev, dtype=dtype)
    W, Y, xtrue, blo = conv(W), conv(Y), conv(xtrue), conv(blo)
    W = W.contiguous()
    m, n = W.shape
    n_lo = blo.shape[0]
    if not n_lo <= l - 1 <= n:
        raise ValueError(f"giant_m needs len(blo) <= l - 1 <= n, got "
                         f"len(blo) = {n_lo}, l = {l}, n = {n}")
    eye_rows = torch.eye(n, dtype=dtype, device=dev)[:l - 1]

    def phi(z):
        return z + NONLIN * torch.tanh(z)

    def res(x):
        return Y - phi(W @ x)

    def rowscale(x):
        return -(1.0 + NONLIN * (1.0 - torch.tanh(W @ x) ** 2))

    def jac(x):
        return rowscale(x)[:, None] * W

    def res_trial(x, p):
        # both ray end points from ONE pass over W ((n, 2) right side)
        zxp = W @ torch.stack([x, p], dim=1)              # (m, 2)
        zx, zp = zxp[:, 0], zxp[:, 1]
        return lambda a: Y - phi(zx + a.to(zx.dtype) * zp)

    def cons(x):
        return torch.cat([x[:n_lo] - blo, x[n_lo:l - 1] + 5.0,
                          (4.0 * n - torch.dot(x, x))[None]])

    def jac_cons(x):
        return torch.cat([eye_rows, -2.0 * x[None, :]])

    dense = Functions(res=res, jac_res=jac, cons=cons, jac_cons=jac_cons)
    factored = Functions(res=res, jac_res=None, cons=cons, jac_cons=jac_cons,
                         res_trial=res_trial, jac_rowscale=rowscale,
                         jac_base=lambda: W)
    return GiantM(factored=factored, dense=dense,
                  dims=Dims(n=n, m=m, q=0, l=l),
                  x0=torch.zeros(n, dtype=dtype, device=dev), xtrue=xtrue,
                  blo=blo, W=W, Y=Y)


def giant_m(m: int = 5_000_000, n: int = 100, l: int = 50, seed: int = 3,
            dtype=torch.float32, device=None, shard=None) -> GiantM:
    """The benchmark's problem at (m, n, l), data drawn on ``device``
    from ``torch.Generator(device).manual_seed(seed)``:
    W ~ N(0, 1/n), xtrue ~ N(0, 1), Y = phi(W xtrue) + 0.01 N(0, 1),
    ``blo = xtrue[:5] + 0.2`` (fewer where ``l - 1 < 5``).

    ``shard=(rank, D)``: rank ``rank``'s rows of the same draw for the
    row-sharded solve (``parallel/rowsharded.py``): rows
    [rank m / D, (rank + 1) m / D) of W and Y, the closures over them and
    ``dims.m`` the global m.  The whole draw is made on the device and
    freed once the block is copied out."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    W = torch.randn((m, n), generator=g, dtype=dtype, device=dev)
    W *= n ** -0.5
    xtrue = torch.randn(n, generator=g, dtype=dtype, device=dev)
    z = W @ xtrue
    Y = z + NONLIN * torch.tanh(z)
    Y += 0.01 * torch.randn(m, generator=g, dtype=dtype, device=dev)
    blo = xtrue[:min(5, l - 1)] + 0.2
    if shard is None:
        return giant_m_from_arrays(W, Y, xtrue, blo, l, dtype, dev)
    rank, D = shard
    if m % D:
        raise ValueError(f"m = {m} rows do not divide over {D} ranks")
    sl = slice(rank * (m // D), (rank + 1) * (m // D))
    W, Y = W[sl].clone(), Y[sl].clone()
    gm = giant_m_from_arrays(W, Y, xtrue, blo, l, dtype, dev)
    return gm._replace(dims=dataclasses.replace(gm.dims, m=m))
