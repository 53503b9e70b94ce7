#!/usr/bin/env python3
"""Design measurements of the batched CPQR kernel (B2) on one NVIDIA GPU.

Run from the repository root, after or instead of ``chip_smoke.py``:

    python3 chip_b2_variants.py

It needs one CUDA device and ``nvcc``, and exits non-zero at once without
them.  It builds ``enlsip_tpu_torch/csrc/cpqr_batched.cu`` as it is and in
variants that each change one decision of its design (into
``build/b2_variants/``), then prints one JSON object per line:

* ``variants``: the launch's time on the card (``chip_smoke.device_ms``)
  of each variant at the main paths' shapes and the gate's edge, both
  dtypes, at the group size ``group_size`` picks; every variant but the
  three that leave a phase out is held against the plain version;
* ``ode_fit_trips``: the ODE fit x 10,000 float32 batch solve with the
  kernel as built, with the reciprocal-tail variant and with the plain
  version on the card: lockstep trips, seconds, share with f < 1e-3, and
  the lanes that took the most iterations.

Variants: ``no_factorization``, ``no_load`` (shared memory filled with a
pattern in place of the global loads) and ``no_store`` leave a phase out,
to show where the time goes; ``rows_unrolled_4`` unrolls the row loops;
``reciprocal_tail`` scales a reflector's tail by 1 / (alpha - beta) as
LAPACK's dlarfg does; ``even_row_stride`` drops the odd row stride that
keeps a warp's rows on distinct banks.  Each is a text substitution of one
line of the source, and the script stops if that line has changed.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time

import torch

if not torch.cuda.is_available():
    sys.stderr.write("chip_b2_variants.py needs a CUDA device; none is available\n")
    sys.exit(1)

import numpy as np

import chip_smoke as cs
from enlsip_tpu_torch.ops import _build
from enlsip_tpu_torch.ops import cpqr_batched_hopper as cb
from enlsip_tpu_torch.parallel import run_batch, solve_batched

FACTOR = "    factor_lane<T, G>(mats"
LOAD = "for (int e = lid; e < nelem; e += 32, w.next()) mats[w.s] = base[w.g];"
STORE = "for (int e = lid; e < nelem; e += 32, w.next()) base[w.g] = mats[w.s];"
TAIL = "      if (t + G * r > k) q.row(r)[k] = q.row(r)[k] / denom;"
VARIANTS = {
    "as_built": [],
    "no_factorization": [(FACTOR, "    if (rows < 0) factor_lane<T, G>(mats")],
    "no_load": [(LOAD, LOAD.replace("base[w.g]", "T(e % 7 - 3)"))],
    "no_store": [(STORE, "if (rows < 0) " + STORE)],
    "rows_unrolled_4": [("#pragma unroll 1\n", "#pragma unroll 4\n")],
    "reciprocal_tail": [(TAIL, "      if (t + G * r > k) q.row(r)[k] *= T(1) / denom;")],
    "even_row_stride": [("return cols | 1;", "return cols;")],
}
CHECKED = ("as_built", "rows_unrolled_4", "reciprocal_tail", "even_row_stride")


def build_variants():
    src = (_build.CSRC / "cpqr_batched.cu").read_text()
    out = _build.build_dir() / "b2_variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"variant {name}: the source no longer holds {old!r}")
            text = text.replace(old, new)
        (out / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out / f"{name}.so"),
             str(out / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        ptr, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for fn in cb._CTYPES.values():
            getattr(lib, fn).argtypes = [ptr, ll, ll, ll, ptr, ptr, ptr,
                                         i, i, i, i, i, ptr]
            getattr(lib, fn).restype = i
        lib.cpqr_batched_shared_bytes.argtypes = [i, i, i, i, i]
        lib.cpqr_batched_shared_bytes.restype = ll
        lib.cpqr_batched_error_string.argtypes = [i]
        lib.cpqr_batched_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def time_variants(libs):
    rows_out = []
    for name, B, rows, cols, live, kind, main in cs.batched_kernel_cases():
        if not (main or name.startswith("gate edge")) or kind == "transposed_view":
            continue
        for dtype in (torch.float32, torch.float64):
            M = cs._batched_case_matrix(kind, B, rows, cols, live, dtype,
                                        seed=B + rows + cols)
            pp, ptau, pperm = cb.cpqr_batched_packed_plain(M)
            G, L = cb.launch_shape(rows, cols, dtype)
            row = {"case": name, "shape": [B, rows, cols],
                   "dtype": str(dtype).replace("torch.", ""), "G": G,
                   "device_ms": {}}
            for vname, lib in libs.items():
                outs = [torch.empty_like(x) for x in (pp, ptau, pperm)]
                fn = getattr(lib, cb._CTYPES[dtype])
                args = (M.data_ptr(), *M.stride(), *(o.data_ptr() for o in outs),
                        rows, cols, B, G, L, torch.cuda.current_stream().cuda_stream)
                assert fn(*args) == 0, vname
                torch.cuda.synchronize()
                if vname in CHECKED:
                    lane_equal = (outs[2] == pperm).all(dim=1)
                    assert float(lane_equal.double().mean()) >= 0.99, vname
                    err = float((outs[0] - pp)[lane_equal].abs().max()
                                / pp.abs().max())
                    assert err <= (1e-9 if dtype == torch.float64 else 1e-5), \
                        (vname, err)
                row["device_ms"][vname] = cs.device_ms(lambda: fn(*args), 20)
            rows_out.append(row)
    return rows_out


def ode_fit_trips(libs):
    fns, starts, ys, opts, tols = cs._ode_batch()
    out = []
    built, library = cb.cpqr_batched_packed, cb._library
    runs = [("as_built", lambda: None),
            ("reciprocal_tail",
             lambda: setattr(cb, "_library", lambda: libs["reciprocal_tail"])),
            ("plain_version_on_the_card",
             lambda: setattr(cb, "cpqr_batched_packed",
                             cb.cpqr_batched_packed_plain))]
    for name, setup in runs:
        setup()
        try:
            solve = lambda: solve_batched(fns, starts, cs.ODE_DIMS, opts, tols,
                                          dtype=torch.float32, data=ys)
            solve()
            torch.cuda.synchronize()
            t0 = time.time()
            res = solve()
            torch.cuda.synchronize()
            seconds = time.time() - t0
        finally:
            cb.cpqr_batched_packed, cb._library = built, library
        f = res.f.double().cpu().numpy()
        iters = res.n_iter.cpu().numpy()
        ec = res.exit_code.cpu().numpy()
        slow = np.argsort(-iters)[:3]
        out.append({"kernel": name, "trips": run_batch.last_trips,
                    "seconds_per_batch_solve": seconds,
                    "share_f_below_1e-3": float(np.mean(f < 1e-3)),
                    "slowest_lanes": [{"lane": int(i), "iterations": int(iters[i]),
                                       "exit_code": int(ec[i])} for i in slow]})
    return out


def main() -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    cs.emit({"device": {"nvidia_smi": smi, "torch": torch.__version__}})
    _build.build_all(["cpqr_batched"])
    libs = build_variants()
    cs.emit({"variants": time_variants(libs)})
    cs.emit({"ode_fit_trips": ode_fit_trips(libs)})
    print(smi, flush=True)


if __name__ == "__main__":
    main()
