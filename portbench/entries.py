"""The entries of the port that the benchmark's window drives.

``solve``: the public ``enlsip_tpu_torch.solve`` on one ``CnlsModel``
built once from the configuration's closures; each call sets the model's
starting point and solves it with the time unlimited, so each call is one
replay of the graph the set-up captured and one read-back.

``solve_batched``: ``enlsip_tpu_torch.parallel.solve_batched`` on a
(lanes, n) stack of starts, on the captured graph, with the closures the
configuration gives and the constraints stacked as the port's models
stack them: [equalities; inequalities; x - lower; upper - x].

A call returns its answers (points, objectives as the solver reports
them, whether the solver reports first-order stationarity) and its
counts (iterations of a solve, trips of a batch).
"""

from __future__ import annotations

import numpy as np
import torch


class SolveEntry:
    kind = "solve"

    def __init__(self, et, prob, dtype, device, options):
        kw = dict(residuals=prob["res"], nb_parameters=prob["n"],
                  nb_residuals=prob["m"], starting_point=prob["x0"],
                  jacobian_residuals=prob["jac_res"])
        if prob["q"]:
            kw.update(eq_constraints=prob["eq"], nb_eqcons=prob["q"],
                      jacobian_eqcons=prob["jac_eq"])
        if prob["p"]:
            kw.update(ineq_constraints=prob["ineq"], nb_ineqcons=prob["p"],
                      jacobian_ineqcons=prob["jac_ineq"])
        if prob["x_low"] is not None:
            kw.update(x_low=prob["x_low"], x_upp=prob["x_upp"])
        self.et = et
        self.model = et.CnlsModel(**kw)
        self.dtype, self.device, self.options = dtype, device, options
        self.lanes = 1

    def call(self, x0) -> dict:
        m = self.model
        m.starting_point = x0
        self.et.solve(m, time_limit=None, dtype=self.dtype,
                      device=self.device, **self.options)
        return {"x": np.asarray(m.sol, dtype=np.float64)[None, :],
                "f": np.array([m.obj_value]),
                "ok": np.array([m.status_code == 1]),
                "iterations": len(m.model_info.iterations_detail)}


class BatchEntry:
    kind = "batch"

    def __init__(self, et, prob, dtype, device, options, lanes):
        from enlsip_tpu_torch.parallel import solve_batched
        from enlsip_tpu_torch.parallel.batch import run_batch
        n = prob["n"]
        lo_idx = hi_idx = torch.zeros(0, dtype=torch.int64, device=device)
        lo = hi = torch.zeros(n, dtype=dtype, device=device)
        if prob["x_low"] is not None:
            lo_idx = torch.as_tensor(np.flatnonzero(np.isfinite(prob["x_low"])),
                                     device=device)
            hi_idx = torch.as_tensor(np.flatnonzero(np.isfinite(prob["x_upp"])),
                                     device=device)
            lo = torch.as_tensor(prob["x_low"], dtype=dtype, device=device)
            hi = torch.as_tensor(prob["x_upp"], dtype=dtype, device=device)
        eye = torch.eye(n, dtype=dtype, device=device)
        vals = [f for f in (prob["eq"], prob["ineq"]) if f is not None]
        jacs = [f for f in (prob["jac_eq"], prob["jac_ineq"]) if f is not None]

        def cons(x):
            return torch.cat([torch.atleast_1d(f(x)) for f in vals]
                             + [(x - lo)[lo_idx], (hi - x)[hi_idx]])

        def jac_cons(x):
            return torch.cat([torch.atleast_2d(g(x)) for g in jacs]
                             + [eye[lo_idx], -eye[hi_idx]])

        l = prob["q"] + prob["p"] + int(lo_idx.numel()) + int(hi_idx.numel())
        self.fns = et.Functions(prob["res"], prob["jac_res"], cons, jac_cons)
        self.dims = et.Dims(n=n, m=prob["m"], q=prob["q"], l=l)
        self.opts = et.Options(**options)
        self.tols = et.Tols.for_dtype(dtype, device)
        self.solve_batched, self.run_batch = solve_batched, run_batch
        self.dtype, self.device, self.lanes = dtype, device, int(lanes)

    def call(self, x0) -> dict:
        res = self.solve_batched(self.fns, x0, self.dims, self.opts,
                                 self.tols, dtype=self.dtype,
                                 device=self.device)
        # answers stay on the device until the window has closed
        return {"x": res.x, "f": res.f, "ok": res.exit_code > 0,
                "trips": int(self.run_batch.last_trips)}


def make(et, entry: str, prob, dtype, device, options, lanes=None):
    if entry == "solve":
        return SolveEntry(et, prob, dtype, device, options)
    if entry == "solve_batched":
        return BatchEntry(et, prob, dtype, device, options, lanes)
    raise ValueError(f"unknown entry {entry!r}")
