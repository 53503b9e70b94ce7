"""A run with the timed path broken underneath comes out not correct:
once for each fault a cell can have (one chip: no exchange between chips
to leave out)."""

from __future__ import annotations

import pytest
import torch

import enlsip_tpu_torch.core.driver as driver
import enlsip_tpu_torch.parallel.batch as batch


def _keep_point(step):
    """A step that runs, counts its iteration and returns the point it
    was given: the solver's state never moves."""
    def unchanged(carry, *a, **k):
        new = step(carry, *a, **k)
        return new._replace(x=carry.x, rx=carry.rx, cx=carry.cx, J=carry.J,
                            A=carry.A, gf=carry.gf)
    return unchanged


def _state_unchanged_single(monkeypatch):
    monkeypatch.setattr(driver, "iterate_body",
                        _keep_point(driver.iterate_body))


def _state_unchanged_batch(monkeypatch):
    monkeypatch.setattr(batch, "batched_guarded_body",
                        _keep_point(batch.batched_guarded_body))


def _answer_altered_single(monkeypatch):
    orig = driver._pack_result

    def altered(carry, f):
        flat = orig(carry, f).clone()
        flat[driver._HEAD] = flat[driver._HEAD] * (1.0 + 1e-6)
        return flat
    monkeypatch.setattr(driver, "_pack_result", altered)


def _answer_altered_batch(monkeypatch):
    orig = batch.finalize

    def altered(carry):
        res = orig(carry)
        x = res.x.clone()
        x[0, 0] = x[0, 0] * (1.0 + 1e-6)
        return res._replace(x=x)
    monkeypatch.setattr(batch, "finalize", altered)


def _half_left_out_batch(monkeypatch):
    """The second half of the lanes never solved: each keeps its start,
    reported with the mean objective of the solved half."""
    orig = batch._solve_batched_graph

    def half(x0, tols, data, rdims, fns, dims, opts, dtype, cap, *a, **k):
        h = x0.shape[0] // 2
        res, head = orig(x0[:h], tols, data, rdims, fns, dims, opts, dtype,
                         cap, *a, **k)
        f = torch.cat([res.f, res.f.mean().expand(x0.shape[0] - h)])
        pad = lambda t: torch.cat([t, t[:x0.shape[0] - h]])
        res = res._replace(x=torch.cat([res.x, x0[h:]]), f=f,
                           exit_code=pad(res.exit_code),
                           n_iter=pad(res.n_iter),
                           counters=type(res.counters)(
                               *(pad(c) for c in res.counters)))
        return res, torch.cat([head[:1], res.exit_code])
    monkeypatch.setattr(batch, "_solve_batched_graph", half)


FAULTS = [
    ("cr1000.f64", _state_unchanged_single),
    ("cr1000.f64", _answer_altered_single),
    ("hs65.f64.b4096", _state_unchanged_batch),
    ("hs65.f64.b4096", _answer_altered_batch),
    ("hs65.f64.b4096", _half_left_out_batch),
]


@pytest.mark.parametrize("workload,fault", FAULTS,
                         ids=[f"{w}-{f.__name__.strip('_')}" for w, f in FAULTS])
def test_fault_comes_out_not_correct(rehearse, monkeypatch, workload, fault):
    fault(monkeypatch)
    got = rehearse(workload)
    assert got["attempted"] > 0
    assert not got["correct"], got["checks"]
