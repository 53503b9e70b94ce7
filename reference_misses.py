#!/usr/bin/env python3
"""Which float32 lanes or families does the JAX package miss on the CPU?

``chip_smoke.py`` prints what the PyTorch port misses on the card: the
ODE-fit lanes that miss f < 1e-3 before and after the float64 escalation
(``batched_ode_fit``, ``missed_lanes``) and the HS families the fused
multistart still misses (``hs_suite``, ``misses_multistart``).  This
script runs the same inputs through the JAX package (``enlsip_tpu``) on
the CPU, so the two can be compared.  It prints one JSON line.

    JAX_PLATFORMS=cpu python3 reference_misses.py ode_fit 1994 9543 ...
    JAX_PLATFORMS=cpu python3 reference_misses.py ode_fit --all
    JAX_PLATFORMS=cpu python3 reference_misses.py ode_fit --float64 1994 ...
    JAX_PLATFORMS=cpu python3 reference_misses.py hs_multistart hs13 ...

``ode_fit``: lanes of the 10,000-lane batch (the same numpy starts and
observations, ``problems/ode_fit.py``; the JAX bench's functions and
options) solved at float32, or all of them with ``--all`` (minutes).  A
lane's result does not depend on the other lanes, up to the rounding of
batched products.  ``--float64`` solves the lanes at float64 in both
packages, from the float32 observations, as the port's escalation does.

``hs_multistart``: the multistart of ``benchmarks/hs_suite_bench.py``
(K = 32 starts a family at scale 1.0, lane 0 the standard start, one
fused float32 batch, a float64 re-solve of the families still missed)
for the families named, in the order the smoke lists them, with each
missed family's converged float32 lanes' f.  Float32 runs without JAX's
64-bit mode, as the JAX bench runs it: with it, float64 constants in a
closure (bounds, the ODE fit's time grid) lift float32 arithmetic to
float64; the float64 solves turn it on.
"""

from __future__ import annotations

import json
import sys

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

LANES = 10_000


def _jax_tols(dtype):
    from enlsip_tpu.core.types import Tols
    rel = float(np.sqrt(float(jnp.finfo(dtype).eps)))
    return Tols(*(jnp.asarray(v, dtype) for v in (1e-10, rel, rel, rel, rel)))


def ode_fit(args) -> dict:
    import enlsip_tpu as ej
    from enlsip_tpu.core.driver import Functions
    from enlsip_tpu.core.types import Dims, Options
    from enlsip_tpu.models.model import (build_constraint_functions,
                                         total_nb_constraints)
    from enlsip_tpu.parallel import solve_batched
    from enlsip_tpu.problems import ode_fit as jode

    f64 = "--float64" in args
    if f64 and not jax.config.jax_enable_x64:
        with jax.enable_x64(True):
            return ode_fit(args)
    lanes = np.arange(LANES) if "--all" in args else \
        np.array([int(a) for a in args if not a.startswith("--")], int)
    model = ej.CnlsModel(**jode.model_kwargs())
    cons, jac = build_constraint_functions(model)
    fns = Functions(res=jode.residuals_data,
                    jac_res=jax.jacfwd(jode.residuals_data),
                    cons=lambda x, y: cons(x), jac_cons=lambda x, y: jac(x))
    dims = Dims(n=model.nb_parameters, m=model.nb_residuals, q=0,
                l=total_nb_constraints(model))
    dtype = jnp.float64 if f64 else jnp.float32
    starts = jode.perturbed_starts(LANES)[lanes]
    ys = jode.scenario_observations(LANES).astype(np.float32)[lanes]
    opts = Options(second_derivatives=False)
    res = solve_batched(fns, starts, dims, opts, _jax_tols(dtype),
                        dtype=dtype, data=ys.astype(dtype))
    rows = {"enlsip_tpu": (np.asarray(res.exit_code), np.asarray(res.f))}
    if f64:
        import torch
        import enlsip_tpu_torch as et
        from enlsip_tpu_torch.models.model import \
            build_constraint_functions as t_build
        from enlsip_tpu_torch.parallel import solve_batched as t_solve
        from enlsip_tpu_torch.problems import ode_fit as tode
        tc, tj = t_build(et.CnlsModel(**tode.model_kwargs()), "cpu")
        tfns = et.Functions(res=tode.residuals_data,
                            jac_res=torch.func.jacfwd(tode.residuals_data),
                            cons=lambda x, y: tc(x),
                            jac_cons=lambda x, y: tj(x))
        tres = t_solve(tfns, starts, et.Dims(dims.n, dims.m, dims.q, dims.l),
                       et.Options(second_derivatives=False),
                       et.Tols.for_dtype(torch.float64), dtype=torch.float64,
                       data=ys.astype(np.float64), device="cpu")
        rows["enlsip_tpu_torch"] = (tres.exit_code.numpy(), tres.f.numpy())
    out = {"problem": "ode_fit", "dtype": "float64" if f64 else "float32",
           "lanes_solved": int(lanes.size)}
    for pkg, (ec, f) in rows.items():
        miss = ~(np.asarray(f, float) < 1e-3)
        out[pkg] = {"missed_lanes": lanes[miss].tolist()}
        if lanes.size <= 64:
            out[pkg]["per_lane"] = {int(i): {"exit_code": int(e),
                                             "f": float(v)}
                                    for i, e, v in zip(lanes, ec, f)}
    return out


def hs_multistart(names, K: int = 32) -> dict:
    from enlsip_tpu.core.types import Options
    from enlsip_tpu.parallel.batch import solve_batched
    from enlsip_tpu.parallel.hetero import fuse_families, solve_suite_fused
    from enlsip_tpu.parallel.suite import hs_scenario_batch
    from enlsip_tpu.problems import get_problem

    def starts():
        fams = hs_scenario_batch(names, per_family=K, scale=1.0)
        for n in names:
            xb = np.asarray(fams[n].x0_batch).copy()
            xb[0] = np.asarray(get_problem(n)[0]["starting_point"], float)
            fams[n] = fams[n]._replace(x0_batch=jnp.asarray(xb))
        return fams

    def hits(f, ec, fstar):
        f, ec = np.asarray(f, float), np.asarray(ec)
        return (ec > 0) & (np.abs(f - fstar) <= 1e-5 * (1 + abs(fstar)))

    fams = starts()
    out = solve_suite_fused(fams, Options(), _jax_tols, dtype=jnp.float32)
    misses = [n for n in names if not hits(out[n].f, out[n].exit_code,
                                           fams[n].fstar).any()]
    conv = {n: sorted(float(f) for f, e in zip(np.asarray(out[n].f),
                                                np.asarray(out[n].exit_code))
                      if e > 0) for n in misses}
    if misses:      # the float64 re-solve of the still-missed families
        with jax.enable_x64(True):
            fams = starts()
            fused = fuse_families({n: fams[n] for n in misses})
            res = solve_batched(fused.fns, fused.x0, fused.dims, Options(),
                                _jax_tols(jnp.float64), dtype=jnp.float64,
                                data=fused.data, rdims=fused.rdims)
            misses = [n for n in misses if not hits(
                res.f[fused.slices[n]], res.exit_code[fused.slices[n]],
                fams[n].fstar).any()]
    return {"problem": "hs_multistart", "multistart_k": K,
            "misses_multistart": misses, "converged_f_float32": conv}


def main() -> None:
    what, args = sys.argv[1], sys.argv[2:]
    out = ode_fit(args) if what == "ode_fit" else hs_multistart(args)
    print(json.dumps({"platform": jax.devices()[0].platform, **out}))


if __name__ == "__main__":
    main()
