"""The batched iteration body against the port's own single body, trip
by trip and lane by lane (float64, CPU; no JAX compile).

From one batched carry, ``batched_guarded_body`` advances all lanes and
``iterate_body`` advances each live lane's slice; the two must agree.
Integer and boolean fields (exit code, iteration count, the four
evaluation counters, masks, dimensions) compare exactly and floats to
1e-10 relative while the lane's objective still moves.  Once a lane's
objective is flat to 1e-9 relative its last line search is limited by
rounding noise — batched and single matrix products round differently in
the last bit — so there only the outcome is held: exit code and
iteration count exactly, x to 1e-8."""

import numpy as np
import torch

import enlsip_tpu_torch as et
from enlsip_tpu_torch.core import batched as tbat
from enlsip_tpu_torch.core import driver as tdrv
from enlsip_tpu_torch.core.driver import Functions
from enlsip_tpu_torch.core.types import Dims, Options, Tols
from enlsip_tpu_torch.models.model import (_model_functions,
                                           total_nb_constraints)
from enlsip_tpu_torch.parallel import init_batch
from enlsip_tpu_torch.problems import classic as tprob

from torch_port_helpers import (CPU, F64, flat_fields, hs65_batch_setup,
                                lane_of, twin_callables, twin_data)

TOLS = Tols.for_dtype(F64)
NOISE_FIELDS = ("w", "K", "prev.w", "prev.alpha", "prev.progress",
                "prev.predicted_reduction", "display")


def _compare_lane(one, got, moving, what):
    fa, fb = flat_fields(one), flat_fields(got)
    assert int(fa["exit_code"]) == int(fb["exit_code"]), what
    assert int(fa["nb_iter"]) == int(fb["nb_iter"]), what
    if not moving:
        assert float((fa["x"] - fb["x"]).abs().max()) <= \
            1e-8 * (1.0 + float(fa["x"].abs().max())), what
        return
    for k in fa:
        a, b = fa[k], fb[k]
        if a.dtype.is_floating_point:
            scale = 1.0 + float(a.abs().max())
            assert float((a - b).abs().max()) <= 1e-10 * scale, (what, k)
        else:
            assert torch.equal(a, b.to(a.dtype)), (what, k)


def _count_calls(monkeypatch, module, name, when=lambda *a, **kw: True):
    """Wrap ``module.<name>`` to count its calls (those ``when`` accepts)."""
    calls = []
    real = getattr(module, name)

    def counted(*a, **kw):
        if when(*a, **kw):
            calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(module, name, counted)
    return calls


def _run_lockstep(fns, starts, dims, opts, data=None, max_trips=60,
                  newton_calls=()):
    """Advance a batch to the end, checking every live lane of every
    trip against the single body.  Returns per-trip records;
    ``newton_calls`` is the call list of the batch's Newton section."""
    carry = init_batch(fns, starts, dims, opts, F64, data=data, device="cpu")
    lf = tbat.lane_functions(fns, data)
    hs = tbat.lane_hessians(fns, data)
    B = starts.shape[0]
    records = []
    for trip in range(max_trips):
        alive = carry.exit_code == 0
        if not bool(alive.any()):
            break
        newton_before = len(newton_calls)
        new = tbat.batched_guarded_body(carry, lf, dims, opts, TOLS, None, hs)
        for b in range(B):
            lane_fns = fns if data is None else tbat.bind_data(
                fns, {k: v[b] for k, v in data.items()})
            if not bool(alive[b]):
                # frozen: nothing of a terminated lane changes
                fa, fb = flat_fields(lane_of(carry, b)), flat_fields(lane_of(new, b))
                assert all(torch.equal(fa[k], fb[k]) for k in fa), (trip, b)
                continue
            old = lane_of(carry, b)
            one = tdrv.iterate_body(old, lane_fns, dims, opts, TOLS)
            f_old = float(old.rx @ old.rx)
            f_new = float(one.rx @ one.rx)
            moving = abs(f_new - f_old) > 1e-9 * max(f_old, 1e-300)
            _compare_lane(one, lane_of(new, b), moving, (trip, b))
        records.append(dict(
            alive=alive.clone(), code=new.prev.code.clone(),
            t=new.prev.t.clone(), rankA=new.prev.rankA.clone(),
            newton_ran=len(newton_calls) > newton_before))
        carry = new
    assert not bool((carry.exit_code == 0).any())
    return carry, records


def test_hs65_batch_every_trip_equals_single_body(monkeypatch):
    _, fns, starts, (n, m, q, l) = hs65_batch_setup(B=8)
    # (the single body calls direction.newton_direction, not this name)
    newton = _count_calls(monkeypatch, tbat, "newton_direction")
    carry, records = _run_lockstep(fns, starts, Dims(n, m, q, l), Options(),
                                   newton_calls=newton)
    assert (carry.exit_code > 0).all()
    assert float((carry.rx * carry.rx).sum(-1).sub(tprob.HS65_FSTAR)
                 .abs().max()) < 1e-6
    # the Newton gate runs exactly in the trips where a live lane steps
    # by Newton, and is skipped (counted) in all the others
    for r in records:
        assert r["newton_ran"] == bool((r["alive"] & (r["code"] == 2)).any())
    assert any(not r["newton_ran"] for r in records)


def test_chained_wood_batch_newton_lanes_every_trip_equals_single_body(
        monkeypatch):
    kw = tprob.chained_wood(20)
    model = et.CnlsModel(**kw)
    fns = Functions(*_model_functions(model, F64, CPU))
    dims = Dims(n=20, m=model.nb_residuals, q=model.nb_eqcons,
                l=total_nb_constraints(model))
    rng = np.random.default_rng(0)
    starts = np.asarray(kw["starting_point"])[None, :] + \
        0.05 * rng.normal(size=(6, 20))
    newton = _count_calls(monkeypatch, tbat, "newton_direction")
    carry, records = _run_lockstep(fns, starts, dims, Options(),
                                   newton_calls=newton)
    assert (carry.exit_code > 0).all()
    took = [(r["alive"] & (r["code"] == 2)) for r in records]
    assert any(bool(v.any()) for v in took), "no lane took a Newton step"
    # a trip where only SOME live lanes need the Newton section
    assert any(bool(v.any()) and not bool(v[r["alive"]].all())
               for v, r in zip(took, records))
    for r, v in zip(records, took):
        assert r["newton_ran"] == bool(v.any())


LOWER, UPPER = (0,), (2,)


def _count_batched_calls(monkeypatch, name, arg):
    """Count the calls of ``driver.<name>`` made for a batch (argument
    ``arg`` carries a lane axis), not those of the single body."""
    single_ndim = 0 if name == "factor_l11" else 1
    return _count_calls(monkeypatch, tdrv, name,
                        lambda *a, **kw: a[arg].ndim > single_ndim)


def _twin_fns():
    def res(x, d):
        return twin_callables(d, LOWER, UPPER, torch, torch.cat)[0](x)

    def cons(x, d):
        return twin_callables(d, LOWER, UPPER, torch, torch.cat)[1](x)

    return Functions(res=res, jac_res=torch.func.jacfwd(res), cons=cons,
                     jac_cons=torch.func.jacfwd(cons))


def test_per_lane_data_some_lanes_rank_deficient(monkeypatch):
    """Lanes 1 and 3 repeat an equality row (rank-deficient A: they need
    F_L11 and the stabilized path), the others do not; each lane has its
    own problem data through ``data=``."""
    n, m, q, n_ineq = 5, 8, 2, 1
    per_lane, x0s = [], []
    for b in range(5):
        d, x0 = twin_data(20 + b, n, m, q, n_ineq, LOWER, UPPER,
                          dup_eq=b in (1, 3))
        per_lane.append(d)
        x0s.append(x0)
    data = {k: torch.tensor(np.stack([d[k] for d in per_lane]), dtype=F64)
            for k in per_lane[0]}
    dims = Dims(n=n, m=m, q=q, l=q + n_ineq + 2)
    calls = _count_batched_calls(monkeypatch, "factor_l11", 2)
    carry, records = _run_lockstep(_twin_fns(), np.stack(x0s), dims,
                                   Options(max_iter=40), data=data)
    deficient = [(r["alive"] & (r["rankA"] < r["t"])) for r in records]
    assert any(bool(v.any()) and not bool(v[r["alive"]].all())
               for v, r in zip(deficient, records)), \
        "no trip where only some live lanes were rank-deficient"
    assert len(calls) > 0


def test_f_l11_gate_is_skipped_when_no_live_lane_needs_it(monkeypatch):
    _, fns, starts, (n, m, q, l) = hs65_batch_setup(B=4, seed=5)
    calls = _count_batched_calls(monkeypatch, "factor_l11", 2)
    rounds2 = _count_batched_calls(monkeypatch, "_ws_round2", 1)
    carry, records = _run_lockstep(fns, starts, Dims(n, m, q, l), Options())
    full_rank_trips = sum(1 for r in records
                          if not bool((r["alive"] & (r["rankA"] < r["t"])).any()))
    assert full_rank_trips > 0
    # stage 1 factors F_L11 at most once per round; trips where every
    # live lane is full-rank and no second round ran add no call
    assert len(calls) <= (len(records) - full_rank_trips) + 2 * len(rounds2)
    assert len(rounds2) < len(records)
