"""State structures and static configuration of the solver.

Counterpart of ``enlsip_tpu/core/types.py``.  The reference threads a
mutable ``Iteration`` record plus a ``WorkingSet`` through its loop;
here the solver state is one :class:`Carry` of tensors, the working set
is a boolean mask over the ``l`` constraints, and every data-dependent
dimension (t, rankA, rankJ2, dimA, dimJ2), code and count is a 0-d
int64 tensor that stays on the device (a branch on it is a conditional
node of the solve's graph, or one read-back in an eager loop).

A batch of solves uses the same structures with a leading lane axis on
every tensor: vectors ``(B, n)``, per-lane scalars ``(B,)``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class Dims:
    """Static problem dimensions.

    n: parameters, m: residuals, q: equality constraints,
    l: total constraints.
    """

    n: int
    m: int
    q: int
    l: int

    @property
    def tmax(self) -> int:
        """Working-set slot-buffer size.  The reference's INIALC can
        activate every non-positive inequality — t is NOT capped at n at
        initialization; only EVADD enforces t <= min(l, n).  Buffers are
        therefore l-sized."""
        return self.l

    @property
    def ka(self) -> int:
        """Rank cap of the active-constraint factorization:
        rankA <= min(n, l) (the R factor of A^T is (ka, l))."""
        return min(self.n, self.l)


class RDims(NamedTuple):
    """Runtime problem dimensions: the SEMANTIC dimensions the decision
    logic compares against (GNDCHK's ``m == n - t``, the EVADD capacity
    bound ``min(l, n)``, TERCRI's ``t > q``), as opposed to the buffer
    shapes fixed by :class:`Dims`.  For ordinary solves the two
    coincide.  A batch may give each lane its own (fields are then
    ``(B,)`` int64 tensors)."""

    n: int
    m: int
    q: int
    l: int

    @staticmethod
    def of(dims: "Dims") -> "RDims":
        return RDims(n=dims.n, m=dims.m, q=dims.q, l=dims.l)


def rdims_or(rdims, dims: "Dims") -> RDims:
    """The semantic dims to use: ``rdims`` if given, else the static ones."""
    return rdims if rdims is not None else RDims.of(dims)


@dataclasses.dataclass(frozen=True)
class Options:
    """Solver options; mirrors the reference's ``enlsip(...)`` keywords."""

    scaling: bool = False
    second_derivatives: bool = True
    weight_code: int = 2  # 0 = max-norm, 2 = euclidean norm
    max_iter: int = 100
    # Inner-loop trip caps (the reference loops are unbounded but
    # terminate in practice).
    linesearch_max_refine: int = 30
    gac_max_halvings: int = 60
    eucmod_max_passes: int = 16
    # Precision of float32 matrix products inside this solve: "float32"
    # (full float32 passes, the default), "tensorfloat32" or "bfloat16"
    # (faster tensor-core passes, fewer digits), or None to inherit the
    # process setting.  See :func:`matmul_precision_scope`.
    matmul_precision: str | None = "float32"
    # D13 (float32 only; no effect at float64): allow the second-order
    # working-set deletion round on a pseudo-rank-DEFICIENT
    # factorization when the iterate is otherwise stationary, holds a
    # genuinely negative multiplier, and shows stall evidence.  See
    # core/driver._ws_round1.
    rank_deficient_deletion: bool = True
    # Factorization of a tall J2 panel (rows >= 32 n and rows >= 4096):
    # "cholqr" (default) = Gram + shifted Cholesky with an implicit Q
    # (ops/tsqr.CholQRF: matrix-product speed, accurate while cond(J2)
    # stays below about eps^(-1/2)); "qr" = a Householder thin QR first
    # stage (slower on a very tall buffer, unconditionally stable).
    tall_qr: str = "cholqr"
    # Row-sharded solves only (parallel/rowsharded.solve_rowsharded with
    # tsqr=True sets it to the row mesh's axis name): J2 always takes the
    # two-stage factorization of ops/tsqr.py ("cholqr" as above, "qr" the
    # TSQR of the ranks' blocks), whatever its height.
    tsqr_axis: str | None = None


_TORCH_PRECISION = {"float32": "highest", "tensorfloat32": "high",
                    "bfloat16": "medium"}


@contextlib.contextmanager
def matmul_precision_scope(opts: "Options"):
    """Set ``torch.set_float32_matmul_precision`` for one solve and
    restore it on exit (torch's setting is process-wide)."""
    if opts.matmul_precision is None:
        yield
        return
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(_TORCH_PRECISION[opts.matmul_precision])
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(before)


def acc(v):
    """Promote decision-path scalars/vectors to float64 (a no-op for
    float64 solves; see linesearch.py for the rationale)."""
    if isinstance(v, torch.Tensor):
        return v.to(torch.float64)
    return torch.as_tensor(v, dtype=torch.float64)


class Tols(NamedTuple):
    """Tolerance bundle (0-d tensors of the solve dtype)."""

    eps_abs: torch.Tensor
    eps_rel: torch.Tensor
    eps_x: torch.Tensor
    eps_c: torch.Tensor
    eps_rank: torch.Tensor

    @classmethod
    def for_dtype(cls, dtype, device="cpu") -> "Tols":
        """The reference's eps(T)-scaled defaults (incl. the internal
        eps_abs = 1e-10): rel = sqrt(eps(T)), c/x/rank tolerances = rel."""
        rel = float(torch.finfo(dtype).eps) ** 0.5
        return cls(*(torch.tensor(v, dtype=dtype, device=device)
                     for v in (1e-10, rel, rel, rel, rel)))


class Counters(NamedTuple):
    """Evaluation counters, observable via ExecutionInfo: int64 tensors
    in the solver's carry (0-d for one solve, ``(B,)`` for a batch); a
    single solve's result reports them as host ints."""

    nb_res: int
    nb_jacres: int
    nb_cons: int
    nb_jaccons: int

    @staticmethod
    def zeros(lead=(), device=None) -> "Counters":
        """All-zero counters: host ints with neither lane axes ``lead`` nor
        a ``device``, else int64 tensors (0-d for one solve on a
        device)."""
        if not lead and device is None:
            return Counters(0, 0, 0, 0)
        return Counters(*(torch.zeros(lead, dtype=torch.int64, device=device)
                          for _ in range(4)))

    def bump(self, res=0, jacres=0, cons=0, jaccons=0) -> "Counters":
        """Counters advanced by host ints or per-lane int tensors."""
        return Counters(self.nb_res + res, self.nb_jacres + jacres,
                        self.nb_cons + cons, self.nb_jaccons + jaccons)


class PrevIter(NamedTuple):
    """Snapshot of the previous iteration, as read by GNDCHK / SUBSPC /
    STPLNG / TERCRI.  ``x``/``rx_sum``/``cx_sum`` are the values at the
    *start* of that body (the point where its direction was computed)."""

    x: torch.Tensor          # (n,)
    rx_sum: torch.Tensor     # ||r(x_prev)||^2
    cx_sum: torch.Tensor     # ||c(x_prev)||^2 (full vector)
    t: torch.Tensor          # working-set size at direction time
    alpha: torch.Tensor
    beta: torch.Tensor
    code: torch.Tensor       # 1 GN, -1 subspace, 2 Newton
    w: torch.Tensor          # (l,) penalty weights used
    progress: torch.Tensor
    predicted_reduction: torch.Tensor
    rankA: torch.Tensor
    rankJ2: torch.Tensor
    dimA: torch.Tensor
    dimJ2: torch.Tensor


class Carry(NamedTuple):
    """The full solver loop state."""

    x: torch.Tensor          # (n,) current point
    rx: torch.Tensor         # (m,)
    cx: torch.Tensor         # (l,)
    J: torch.Tensor          # (m, n)
    A: torch.Tensor          # (l, n)
    gf: torch.Tensor         # (n,) gradient J^T rx
    active_mask: torch.Tensor  # (l,) bool working set
    w: torch.Tensor          # (l,) current penalty weights
    K: torch.Tensor          # (4, l) penalty history (largest-4 per constraint)
    prev: PrevIter
    restart: torch.Tensor    # bool, current iter restart flag (carried)
    index_del: torch.Tensor  # global constraint index, -1 = none (carried)
    nb_newton_steps: torch.Tensor  # int64, 0-d; (B,) in a batch
    nb_iter: torch.Tensor    # likewise
    exit_code: torch.Tensor  # likewise
    counters: Counters
    display: torch.Tensor    # (max_iter+1, 5): objective, act_cx_sum, |p|, alpha, progress
    n_display: torch.Tensor  # int64, 0-d; (B,) in a batch


class WorkingView(NamedTuple):
    """Derived view of the working set for one mask state.

    active_list: (l,) int64 — first t entries are the sorted active
      constraint indices, the remaining l-t entries are the sorted
      inactive ones.
    t: per-lane int64 active count (0-d for one solve).
    """

    active_list: torch.Tensor
    t: torch.Tensor


def working_view(mask: torch.Tensor) -> WorkingView:
    l = mask.shape[-1]
    idx = torch.arange(l, device=mask.device)
    # The key has no ties, so the order does not depend on sort stability.
    key = torch.where(mask, idx, idx + l)
    return WorkingView(active_list=torch.argsort(key, dim=-1),
                       t=torch.sum(mask, dim=-1))
