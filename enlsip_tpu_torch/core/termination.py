"""Termination criteria — the TERCRI exit-code lattice.

Counterpart of ``enlsip_tpu/core/termination.py``.  Convergence codes
are additive (+10000, +2000, +300, +40); abnormal codes are negative
(-2 max iters, -3/-4/-5 passthrough, -9 too many Newton steps, -6
merit-derivative inconsistency, -10 infeasible stall, -11 time limit,
which the host loop of core/driver.solve assigns).  The infeasibility
negation is reproduced even though the necessary conditions already
imply it cannot fire.
"""

from __future__ import annotations

import torch

from .._lanes import const, mtv, norm, take
from ..ops.qr import prefix_dot
from .types import Dims, Tols, rdims_or


def check_termination(p, code, restart, deleted, d_gn, dimJ2, grad_res,
                      act_cx, act_A, act_valid, t, x, prev_x, cx, mask,
                      rx_sum, gf, nb_iter, max_iter: int, tols: Tols,
                      error_code, sigma_min, lam_abs_max, psi_error,
                      nb_newton_steps, w, active_global,
                      dims: Dims, rdims=None) -> torch.Tensor:
    """TERCRI.  All inputs are post-step values except the factorization
    products (grad_res, d_gn, act_*) which come from the direction
    computation at the pre-step point, exactly as in the reference.
    Control-flow free; returns a per-lane int64 exit code (0 = continue;
    0-d for one solve, ``(B,)`` for a batch)."""
    m, q = dims.m, rdims_or(rdims, dims).q
    dtype, dev = x.dtype, x.device
    rel = torch.finfo(dtype).eps
    is_f32 = rel > torch.finfo(torch.float64).eps
    alfnoi = rel / (norm(p) + rel)
    T, F = (torch.ones((), dtype=torch.bool, device=dev),
            torch.zeros((), dtype=torch.bool, device=dev))
    as_t = lambda v: const(v, dev)
    code, error_code, psi_error = as_t(code), as_t(error_code), as_t(psi_error)
    restart, deleted = as_t(restart), as_t(deleted)

    preliminary = ~(restart | ((code == -1) & (alfnoi <= 0.25)))

    zero_s = torch.zeros_like(act_cx)
    act_cx_nrm = torch.sqrt(torch.sum(torch.where(act_valid, act_cx * act_cx,
                                                  zero_s), dim=-1))
    gf_nrm = norm(gf)
    necessary = (~deleted) & (act_cx_nrm < tols.eps_c) & \
                (grad_res < torch.sqrt(tols.eps_rel) * (1 + gf_nrm))
    inact = ~mask
    n_inact = torch.sum(inact, dim=-1)
    inact_ok = torch.all(torch.where(inact, cx > 0.0, T), dim=-1)
    necessary = necessary & torch.where(n_inact > 0, inact_ok, T)
    factor = torch.where(t == 1, 1.0 + rx_sum, lam_abs_max)
    necessary = necessary & torch.where(
        t > q, sigma_min >= tols.eps_rel * factor, T)

    d1sq = prefix_dot(d_gn, torch.clamp(as_t(dimJ2), 0, m))
    x_diff = norm(prev_x - x)
    xnrm = norm(x)
    conv = (torch.where(d1sq <= rx_sum * tols.eps_rel ** 2, 10000, 0)
            + torch.where(rx_sum <= tols.eps_abs ** 2, 2000, 0)
            + torch.where(x_diff < tols.eps_x * xnrm, 300, 0)
            + torch.where(alfnoi > 0.25, 40, 0))
    # Infeasibility negation — dead under the necessary conditions
    # above, kept for exactness.
    any_viol = torch.any(torch.where(inact, cx <= 0.0, F), dim=-1)
    conv = torch.where((conv > 0) & (n_inact > 0) & any_viol, -conv, conv)
    exit_code = torch.where(preliminary & necessary, conv,
                            torch.zeros_like(conv))

    # Abnormal termination, priority order preserved.
    Atcx = mtv(act_A, torch.where(act_valid, act_cx, zero_s))
    Atcx_nrm = norm(Atcx)
    w_act = take(w, active_global)
    pen_sum = torch.sum(torch.where(act_valid, w_act * w_act, zero_s), dim=-1)
    pen_sum = torch.where(t == 0, torch.zeros_like(pen_sum), pen_sum)
    stuck = (x_diff <= 10.0 * tols.eps_x) & (Atcx_nrm <= 10.0 * tols.eps_c) & \
            (pen_sum >= 1.0)
    code_m6 = torch.full_like(conv, -6)
    code_m4 = error_code
    if is_f32:
        # float32-aware stall discrimination: the absolute window
        # x_diff <= 10*eps_x sits at the float32 step-noise floor, so
        # iterates converging normally land in it before a sufficient
        # convergence code fires.  A genuinely stuck-infeasible iterate
        # has a LARGE active-constraint violation; a converged-but-noisy
        # one has act_cx ~ 0.  float64 keeps the reference-shaped test.
        stuck = stuck & (act_cx_nrm > tols.eps_c)
        # D12 (float32 robustness): at a stationary point dpsi0 is pure
        # rounding noise and GN "stall" (which GNDCHK escalates to a
        # Newton request) IS convergence; the -6 non-descent abort and
        # the -4 Newton-disallowed abort race the sufficient convergence
        # codes.  When the iterate already satisfies every NECESSARY
        # first-order condition the abort is noise-limited-steplength
        # evidence — the reference's own +40 class.  -6 claims a genuine
        # merit-derivative inconsistency, so its upgrade additionally
        # requires the step to look noise-limited or the projected
        # gradient to sit at the noise scale eps_rel*(1+|gf|); -4 claims
        # nothing inconsistent and converts on ``necessary`` alone.
        # -3/-5 are never converted.  float64 is untouched.
        noise_step = (alfnoi > 0.25) | (x_diff <= 10.0 * tols.eps_x * xnrm) \
            | (grad_res < tols.eps_rel * (1 + gf_nrm))
        code_m6 = torch.where(necessary & noise_step, 40, code_m6)
        code_m4 = torch.where((error_code == -4) & necessary, 40, error_code)
    abn = torch.where(as_t(nb_iter >= max_iter), -2,
          torch.where((error_code >= -5) & (error_code <= -3), code_m4,
          torch.where(as_t(nb_newton_steps > 5), -9,
          torch.where(psi_error == -1, code_m6,
          torch.where(stuck, -10, 0)))))
    return torch.where(exit_code == 0, abn, exit_code)
