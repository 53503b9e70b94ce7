"""Judge a solver's answers by the plain equations of their problem.

For each answer (a point x, the objective f the solver reported for it)
the reference works out, at float64:

- ``f_gap``: |f reported - f(x)| / f(x), the objective recomputed from
  the residuals at the returned point;
- ``c_viol``: the largest violation of a constraint at x, |c_i(x)| for
  an equality and max(0, -c_i(x)) for an inequality (bounds included);
- ``kkt``: the first-order optimality residual at x.  With the gradient
  g = 2 J^T r, the equalities and the inequalities with c_i(x) <= 1e-4
  taken as active (rows A_act of the constraint Jacobian), the
  multipliers are the least-squares solution of A_act^T lam = g, and
  ``kkt`` is the larger of ||g - A_act^T lam|| / ||g|| and the most
  negative multiplier of an active inequality, times its row's norm,
  over ||g||.

Each is computed for every answer, in blocks of answers small enough to
hold the block's constraint Jacobians on the device.
"""

from __future__ import annotations

import torch

ACTIVE_SLACK = 1e-4
BLOCK_BYTES = 1 << 30


def _block_kkt(ref, X, q):
    g = ref.gradient(X)
    c = ref.constraints(X)
    A = ref.constraint_jacobian(X)
    l = c.shape[1]
    is_eq = torch.arange(l, device=X.device) < q
    active = is_eq | (c <= ACTIVE_SLACK)
    Am = A * active[..., None].to(A.dtype)
    M = Am @ Am.transpose(1, 2)
    M = M + torch.diag_embed((~active).to(A.dtype))
    rhs = (Am @ g[..., None])
    L, info = torch.linalg.cholesky_ex(M)
    lam = torch.cholesky_solve(rhs, L)[..., 0]
    resid = g - (Am.transpose(1, 2) @ lam[..., None])[..., 0]
    gnorm = torch.linalg.vector_norm(g, dim=1).clamp_min(1e-300)
    stat = torch.linalg.vector_norm(resid, dim=1) / gnorm
    row_norm = torch.linalg.vector_norm(A, dim=2)
    neg = torch.where(active & ~is_eq, (-lam).clamp_min(0.0) * row_norm,
                      torch.zeros_like(lam))
    dual = neg.amax(1) / gnorm if l else torch.zeros_like(stat)
    kkt = torch.maximum(stat, dual)
    kkt = torch.where(info == 0, kkt, torch.full_like(kkt, float("inf")))
    viol = torch.where(is_eq, c.abs(), (-c).clamp_min(0.0))
    return kkt, viol.amax(1) if l else torch.zeros_like(kkt)


def judge(ref, X, f_reported, device) -> dict:
    """Per-answer ``f_gap``, ``c_viol`` and ``kkt`` (float64 tensors on
    the host) of the answers X (N, n) with reported objectives (N,)."""
    X = torch.as_tensor(X).to(device=device, dtype=torch.float64)
    f_rep = torch.as_tensor(f_reported).to(device=device,
                                           dtype=torch.float64)
    N, n = X.shape
    q = ref.equalities(X[:1])
    l = ref.constraints(X[:1]).shape[1]
    per_lane = 8 * (2 * l * n + 2 * l * l + 4 * (n + l))
    block = max(1, BLOCK_BYTES // per_lane)
    out = {"f_gap": [], "c_viol": [], "kkt": []}
    for s in range(0, N, block):
        Xb = X[s:s + block]
        f_ref = ref.objective(Xb)
        out["f_gap"].append(((f_rep[s:s + block] - f_ref).abs()
                             / f_ref.abs().clamp_min(1e-300)).cpu())
        kkt, viol = _block_kkt(ref, Xb, q)
        out["kkt"].append(kkt.cpu())
        out["c_viol"].append(viol.cpu())
    return {k: torch.cat(v) if v else torch.zeros(0, dtype=torch.float64)
            for k, v in out.items()}
