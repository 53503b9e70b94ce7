#!/usr/bin/env python3
"""Which operation of the port's batched solve gives a lane other bits when
the lane is solved in a batch of another size, on one CUDA card.

    python3 chip_batch_bits.py [--lanes B] [--parts P]

It runs ``solve_batched`` on HS65 x B lanes (the starts of
``chip_smoke.batched_hs65``), float32 and float64, and on the fused
five-family float32 batch of ``chip_smoke.hetero_suite`` (2,560 lanes),
each under a dispatch mode
that, for every ATen operation whose tensor inputs and outputs lead with
the lane axis (length B), runs the operation again on each of P equal
parts of those inputs and compares the part's output with the same rows
of the whole-batch output, bit for bit.  It also holds the batched QR
kernel (B2, which is not an ATen operation) to the same test on the
HS65 batch's J2 and A_act^T shapes, and the whole solve's x and exit codes
against the P part solves.  One JSON line a solve lists every operation
that differed: its name, input shapes, how often, the largest
difference, and the port's innermost lines that called it.  The last line is the card's name and power limit.

It needs one CUDA device and ``nvcc`` and exits non-zero without them.
"""

from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
import traceback

import torch

if not torch.cuda.is_available():
    sys.stderr.write("chip_batch_bits.py needs a CUDA device; none is "
                     "available\n")
    sys.exit(1)

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils._pytree import tree_flatten, tree_map  # noqa: E402

import chip_smoke as cs  # noqa: E402
import enlsip_tpu_torch as et  # noqa: E402
from enlsip_tpu_torch.parallel import solve_batched  # noqa: E402
from enlsip_tpu_torch.ops import _build  # noqa: E402
from enlsip_tpu_torch.ops.cpqr_batched_hopper import \
    cpqr_batched_packed  # noqa: E402


def _same(a, b):
    if a.dtype.is_floating_point:
        return bool(((a == b) | (a.isnan() & b.isnan())).all())
    return torch.equal(a, b)


class PartsMode(TorchDispatchMode):
    """Re-runs each lane-leading operation on ``parts`` slices of the lane
    axis and records those whose slice differs from the whole's rows."""

    def __init__(self, B, parts):
        super().__init__()
        self.B, self.parts = B, parts
        self.seen = 0
        self.skipped = collections.Counter()
        self.diff = collections.defaultdict(lambda: [0, 0.0, set()])

    def _lane(self, t):
        return isinstance(t, torch.Tensor) and t.dim() >= 1 \
            and t.shape[0] == self.B

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func._schema.is_mutable or "empty" in str(func):
            return out
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        if not ins or not outs or not any(map(self._lane, ins)) \
                or not all(map(self._lane, outs)) \
                or any(t.is_meta for t in ins + outs):
            return out
        self.seen += 1
        per = self.B // self.parts
        for p in range(self.parts):
            sl = slice(p * per, (p + 1) * per)
            # sizes given as arguments (expand, view, new_zeros) shrink too
            cut = lambda t: t[sl] if self._lane(t) else \
                per if type(t) is int and t == self.B else t
            try:
                got = func(*tree_map(cut, args), **tree_map(cut, kwargs))
            except RuntimeError:
                self.skipped[str(func)] += 1
                return out
            got = [t for t in tree_flatten(got)[0]
                   if isinstance(t, torch.Tensor)]
            for g, w in zip(got, outs):
                w = w[sl]
                if g.shape != w.shape or _same(g, w):
                    continue
                key = (str(func), tuple(tuple(t.shape) for t in ins),
                       str(w.dtype))
                d = self.diff[key]
                d[0] += 1
                d[2].add(" < ".join([
                    f"{f.filename.split('enlsip_tpu_torch/')[-1]}:{f.lineno}"
                    for f in traceback.extract_stack()[::-1]
                    if "enlsip_tpu_torch/" in f.filename][:3]))
                if w.dtype.is_floating_point:
                    d[1] = max(d[1], float((g - w).abs().nan_to_num().max()))
        return out


def b2_parts(B, parts, dtype):
    """B2 on the batch's J2 (m, n) and A_act^T (n, l) shapes, whole
    against parts; returns the shapes whose outputs differ."""
    g = torch.Generator(device="cuda").manual_seed(0)
    bad = []
    for rows, cols in ((cs.HS65_DIMS.m, cs.HS65_DIMS.n),
                       (cs.HS65_DIMS.n, cs.HS65_DIMS.l)):
        M = torch.randn(B, rows, cols, generator=g, device="cuda",
                        dtype=dtype)
        whole = cpqr_batched_packed(M)
        per = B // parts
        for p in range(parts):
            sl = slice(p * per, (p + 1) * per)
            part = cpqr_batched_packed(M[sl])
            if not all(_same(a, b[sl]) for a, b in zip(part, whole)):
                bad.append([rows, cols])
                break
    return bad


def _hs65(dtype, B):
    fns, starts = cs._hs65_batch(dtype, B)
    tols = et.Tols.for_dtype(dtype, cs.DEV)
    return lambda sl: solve_batched(fns, starts[sl], cs.HS65_DIMS,
                                   et.Options(), tols, dtype=dtype)


def _hetero(dtype, per_family):
    """The fused five-family batch of ``chip_smoke.hetero_suite``."""
    fused = cs.fuse_families(cs.hs_scenario_batch(
        cs.HETERO_FAMILIES, per_family=per_family, seed=0))
    tols = cs._tols_fn(dtype)
    return lambda sl: solve_batched(
        fused.fns, fused.x0[sl], fused.dims, et.Options(max_iter=60), tols,
        dtype=dtype, data={"fam": fused.data["fam"][sl]},
        rdims=type(fused.rdims)(*(v[sl] for v in fused.rdims)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--lanes", type=int, default=cs.HS65_LANES)
    ap.add_argument("--parts", type=int, default=2)
    a = ap.parse_args()
    _build.build_all()
    per_family = 512
    for problem, dtype, B, solve in (
            ("hs65", torch.float32, a.lanes, _hs65(torch.float32, a.lanes)),
            ("hs65", torch.float64, a.lanes, _hs65(torch.float64, a.lanes)),
            ("hetero_suite", torch.float32,
             per_family * len(cs.HETERO_FAMILIES),
             _hetero(torch.float32, per_family))):
        whole = solve(slice(None))
        per = B // a.parts
        parts = [solve(slice(p * per, (p + 1) * per))
                 for p in range(a.parts)]
        x_parts = torch.cat([p.x for p in parts])
        ec_parts = torch.cat([p.exit_code for p in parts])
        mode = PartsMode(B, a.parts)
        with mode:
            solve(slice(None))
        print(json.dumps({
            "problem": problem, "dtype": str(dtype).replace("torch.", ""),
            "lanes": B, "parts": a.parts,
            "solve_x_bits_equal_share": float(
                (whole.x == x_parts).all(-1).double().mean()),
            "solve_max_abs_dx": float((whole.x - x_parts).abs().max()),
            "solve_codes_equal_share": float(
                (whole.exit_code == ec_parts).double().mean()),
            "ops_checked": mode.seen, "ops_not_sliceable": mode.skipped,
            "ops_differing": [
                {"op": k[0], "input_shapes": k[1], "dtype": k[2],
                 "times": v[0], "max_abs_diff": v[1],
                 "called_from": sorted(v[2])}
                for k, v in sorted(mode.diff.items(),
                                   key=lambda kv: -kv[1][0])]}), flush=True)
        if problem == "hs65":
            print(json.dumps({"dtype": str(dtype).replace("torch.", ""),
                              "b2_shapes_differing": b2_parts(B, a.parts,
                                                              dtype)}),
                  flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
