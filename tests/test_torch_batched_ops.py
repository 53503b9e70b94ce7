"""The lane-generic linear-algebra helpers on a leading batch axis: each
batched call equals the per-lane calls (float64, CPU, 1e-12)."""

import numpy as np
import pytest
import torch

from enlsip_tpu_torch import _lanes
from enlsip_tpu_torch.ops import blocked_qr as tb
from enlsip_tpu_torch.ops import qr as tq

from torch_port_helpers import tt

ATOL = 1e-12
B = 6


def _factored(rows, cols, seed=0):
    M = tt(np.random.default_rng(seed).normal(size=(B, rows, cols)))
    M[:, :, cols - 1:] = 0.0
    return M, tb.cpqr_blocked(M, device="cpu")


@pytest.mark.parametrize("rows,cols", [(7, 4), (5, 9), (12, 12)])
@pytest.mark.parametrize("apply", ["qt_vec", "qt_mat", "q_vec", "q_mat",
                                   "right"])
def test_batched_q_applies_equal_per_lane(rows, cols, apply):
    rng = np.random.default_rng(1)
    M, f = _factored(rows, cols)
    x = tt(rng.normal(size=(B, rows)))
    X = tt(rng.normal(size=(B, rows, 3)))
    J = tt(rng.normal(size=(B, 5, rows)))
    fn, arg = {"qt_vec": (tb.qt_apply, x), "qt_mat": (tb.qt_apply, X),
               "q_vec": (tb.q_apply, x), "q_mat": (tb.q_apply, X),
               "right": (tb.right_q_apply, J)}[apply]
    out = fn(f, arg)
    for b in range(B):
        g = tb._cpqr_xla(M[b], tb.NB, None)
        assert float((out[b] - fn(g, arg[b])).abs().max()) <= ATOL
    if apply == "q_vec":     # Q is orthogonal: Q Q^T x = x
        assert float((tb.q_apply(f, tb.qt_apply(f, x)) - x).abs().max()) <= 1e-12


@pytest.mark.parametrize("device", ["cpu", pytest.param(
    "cuda", marks=pytest.mark.gpu)])
@pytest.mark.parametrize("op", ["mv", "mtv", "qt_vec", "q_vec"])
def test_lane_products_do_not_follow_the_batch_size(op, device):
    """A lane's product is the same to the bit whether its batch holds
    4096 lanes or half of them (on the card a batched matrix product picks
    its kernel by the number of lanes, which would make a sharded rank's
    lanes round otherwise than the whole batch).  The shapes are HS65's."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(3)
    lanes, half = 4096, 2048
    A = torch.tensor(rng.normal(size=(lanes, 3, 7)), device=device)
    v = {"mv": torch.tensor(rng.normal(size=(lanes, 7)), device=device),
         "mtv": torch.tensor(rng.normal(size=(lanes, 3)), device=device)}
    if op in ("mv", "mtv"):
        fn = lambda sl: getattr(_lanes, op)(A[sl], v[op][sl])
    else:
        f = tb.cpqr_blocked(A.transpose(-1, -2).contiguous(), device=device)
        apply = tb.qt_apply if op == "qt_vec" else tb.q_apply
        fn = lambda sl: apply(type(f)(*(
            None if a is None else a[sl] for a in f)), v["mv"][sl])
    whole = fn(slice(None))
    for sl in (slice(0, half), slice(half, lanes)):
        assert torch.equal(fn(sl), whole[sl])


@pytest.mark.parametrize("upper", [True, False])
def test_masked_triangular_solves_with_per_lane_k(upper):
    rng = np.random.default_rng(2)
    c = 6
    R = tt(rng.normal(size=(B, c, c + 2))) + 3.0 * torch.eye(c, c + 2)
    R = torch.triu(R) if upper else torch.tril(R)
    b = tt(rng.normal(size=(B, c + 1)))
    k = torch.tensor([0, 1, 3, 6, 4, 6])
    solve = tq.solve_upper if upper else tq.solve_lower
    out = solve(R, b, k)
    for lane in range(B):
        one = solve(R[lane], b[lane], k[lane])
        assert float((out[lane] - one).abs().max()) <= ATOL
        assert float(out[lane, int(k[lane]):].abs().max()
                     if int(k[lane]) < c else 0.0) == 0.0
    # a host int serves every lane
    same = solve(R, b, 4)
    assert float((same[2] - solve(R[2], b[2], 4)).abs().max()) <= ATOL


def test_pseudo_rank_prefix_and_invperm_per_lane():
    rng = np.random.default_rng(3)
    diag = tt(rng.normal(size=(B, 5)))
    diag[1, 2:] = 1e-12
    diag[2] = 0.0
    length = torch.tensor([5, 5, 3, 0, 2, 4])
    r = tq.pseudo_rank(diag, length, 1e-8)
    v = tt(rng.normal(size=(B, 7)))
    k = torch.tensor([0, 7, 3, 1, 5, 2])
    pd, pn = tq.prefix_dot(v, k), tq.prefix_norm(v, k)
    perm = torch.stack([torch.randperm(7, generator=torch.Generator()
                                       .manual_seed(i)) for i in range(B)])
    inv = tq.invperm(perm)
    for lane in range(B):
        assert int(r[lane]) == int(tq.pseudo_rank(diag[lane], length[lane],
                                                  1e-8))
        assert abs(float(pd[lane] - tq.prefix_dot(v[lane], k[lane]))) <= ATOL
        assert abs(float(pn[lane] - tq.prefix_norm(v[lane], k[lane]))) <= ATOL
        assert torch.equal(inv[lane], tq.invperm(perm[lane]))
        assert torch.equal(perm[lane][inv[lane]], torch.arange(7))
    assert r.tolist()[1:4] == [2, 0, 0]


def test_lane_indexing_helpers():
    rng = np.random.default_rng(4)
    v = tt(rng.normal(size=(B, 5)))
    A = tt(rng.normal(size=(B, 5, 3)))
    idx = torch.stack([torch.randperm(5, generator=torch.Generator()
                                      .manual_seed(i))[:4] for i in range(B)])
    got, rows = _lanes.take(v, idx), _lanes.take_rows(A, idx)
    placed = _lanes.put(torch.zeros(5, dtype=v.dtype), idx, got)
    for lane in range(B):
        assert torch.equal(got[lane], v[lane][idx[lane]])
        assert torch.equal(rows[lane], A[lane][idx[lane]])
        want = torch.zeros(5, dtype=v.dtype)
        want[idx[lane]] = v[lane][idx[lane]]
        assert torch.equal(placed[lane], want)
    assert torch.equal(_lanes.take1(v, idx[:, 0]),
                       v[torch.arange(B), idx[:, 0]])
    # one solve's tensors go through the same helpers
    assert torch.equal(_lanes.take(v[0], idx[0]), v[0][idx[0]])
    assert torch.equal(_lanes.mv(A[0], v[0, :3]), A[0] @ v[0, :3])


def test_cond_and_while_loop_lockstep_semantics():
    calls = []
    t = lambda: (calls.append("t"), torch.full((4,), 1.0))[1]
    f = lambda: (calls.append("f"), torch.full((4,), 2.0))[1]
    pred = torch.tensor([True, False, True, False])
    assert _lanes.cond(pred, t, f).tolist() == [1.0, 2.0, 1.0, 2.0]
    assert sorted(calls) == ["f", "t"]
    calls.clear()
    assert _lanes.cond(torch.zeros(4, dtype=torch.bool), t, f).tolist() == [2.0] * 4
    assert _lanes.cond(pred, t, f, lanes=~pred).tolist() == [2.0] * 4
    assert calls == ["f", "f"]            # the side no (live) lane takes is skipped
    calls.clear()
    assert float(_lanes.cond(torch.tensor(True), lambda: torch.tensor(1.0),
                             f)) == 1.0 and calls == []
    # lanes count down from their own start; finished lanes are frozen
    start = torch.tensor([3, 0, 5, 1])
    end, trips = _lanes.while_loop(lambda s: s[0] > 0,
                                   lambda s: (s[0] - 1, s[1] + 1),
                                   (start, torch.zeros(4, dtype=torch.int64)))
    assert end.tolist() == [0, 0, 0, 0] and trips.tolist() == [3, 0, 5, 1]
    capped, _ = _lanes.while_loop(lambda s: s[0] > 0,
                                  lambda s: (s[0] - 1, s[1] + 1),
                                  (start, torch.zeros(4, dtype=torch.int64)),
                                  max_trips=2)
    assert capped.tolist() == [1, 0, 3, 0]
