#!/usr/bin/env python3
"""Design measurements of the float64 fused WY kernel
(``enlsip_tpu_torch/csrc/wy_gram_f64.cu``, B3-B6 at float64) on one
NVIDIA GPU.

Run from the repository root, after or instead of ``chip_smoke.py``:

    python3 chip_wy64_variants.py

It needs one CUDA device and ``nvcc``, and exits non-zero at once without
them.  It builds ``wy_gram_f64.cu`` as it is and in variants that each
change one decision of its design (into ``build/wy64_variants/``), then prints one JSON object per line:

* ``build``: for every variant, what ptxas reported for each kernel
  (registers, spill bytes) and how many float64 tensor-core instructions
  (``DMMA``) its SASS holds (``cuobjdump -sass``);
* ``cases``: for every variant, each of the four entry points at the
  float64 edge shapes of ``chip_smoke.WY_EDGE_CASES_F64`` and at the
  giant-m shapes (5,000,000 and 200,000 rows x 100, k = 50), held against
  the plain version as ``chip_smoke.check_wy_case`` holds them (1e-11
  relative, two launches equal to the bit, G symmetric to the bit), with
  the kernel's ms on the card beside the plain chain's ms and the bound;
  a variant that fails a check is reported with the failure and not timed
  further;
* ``dmma_rate``: the float64 tensor-core rate a probe kernel reaches with
  its fragments in registers (no shared-memory loads), 8 independent
  accumulators a warp, one block of 4, 8, 12 or 16 warps on every SM, for
  each mma depth (m16n8k4, m16n8k8, m16n8k16), in TFLOP/s: the ceiling
  of the kernel's products on this card.

Variants, each a text substitution of one constant of the source (the
script stops if the substituted text has changed): ``as_built`` (m16n8k8
steps for X and the apply, m16n8k16 for the Gram, 16-row warp tiles, 8
warps a block); ``gram_k8`` (the Gram in m16n8k8 steps too); ``k16`` (X
and the apply in m16n8k16 steps, half the mma instructions); ``m32`` (X
and apply warp tiles of 32 rows, one B fragment serving two A
fragments); ``warps_12`` (12 warps a block to hide the fragment loads'
latency, at 168 registers a thread); ``no_mma`` (every mma left out, and
with it the fragment loads: the copies, the stores and the block's
schedule alone; wrong by design, so timed and not held).
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time

import torch

if not torch.cuda.is_available():
    sys.stderr.write("chip_wy64_variants.py needs a CUDA device; none is available\n")
    sys.exit(1)

import chip_smoke as cs
from enlsip_tpu_torch.ops import _build
from enlsip_tpu_torch.ops import wy_hopper as wy

MMA = '  asm("mma.sync.aligned.'
# name -> text substitutions of the source
VARIANTS = {"as_built": [],
            "gram_k8": [("kStepGram = 16;", "kStepGram = 8;")],
            "k16": [("kStep = 8;", "kStep = 16;")],
            "m32": [("kRowBlocks = 1;", "kRowBlocks = 2;")],
            "warps_12": [("kWarps = 8;", "kWarps = 12;")],
            "no_mma": [(MMA, "  if (false) " + MMA.strip())]}
# variants whose results are wrong by design: timed, not held
TIMED_ONLY = {"no_mma"}
PROBE = r"""
#include <cuda_runtime.h>
template <int K> __device__ __forceinline__ void mma(double (&d)[4],
    const double (&a)[K / 2], const double (&b)[K / 4]);
template <> __device__ __forceinline__ void mma<4>(double (&d)[4],
    const double (&a)[2], const double (&b)[1]) {
  asm volatile("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
      "{%4,%5}, {%6}, {%0,%1,%2,%3};" : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]),
      "+d"(d[3]) : "d"(a[0]), "d"(a[1]), "d"(b[0]));
}
template <> __device__ __forceinline__ void mma<8>(double (&d)[4],
    const double (&a)[4], const double (&b)[2]) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};" : "+d"(d[0]), "+d"(d[1]),
      "+d"(d[2]), "+d"(d[3]) : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]),
      "d"(b[0]), "d"(b[1]));
}
template <> __device__ __forceinline__ void mma<16>(double (&d)[4],
    const double (&a)[8], const double (&b)[4]) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, {%0,%1,%2,%3};"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3]) : "d"(a[0]), "d"(a[1]),
      "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]), "d"(a[7]),
      "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}
template <int K> __global__ void __launch_bounds__(512) rate(double* out,
                                                             int iters) {
  double a[K / 2], b[K / 4], acc[8][4];
  for (int v = 0; v < K / 2; ++v) a[v] = 1e-3 * (threadIdx.x + v);
  for (int v = 0; v < K / 4; ++v) b[v] = 1e-3 * (threadIdx.x - v);
  for (int c = 0; c < 8; ++c) for (int q = 0; q < 4; ++q) acc[c][q] = c + q;
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) mma<K>(acc[c], a, b);
  double s = 0;
  for (int c = 0; c < 8; ++c) for (int q = 0; q < 4; ++q) s += acc[c][q];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int dmma_probe(int K, int blocks, int threads, int iters, double* out,
                          void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (K == 4) rate<4><<<blocks, threads, 0, st>>>(out, iters);
  else if (K == 8) rate<8><<<blocks, threads, 0, st>>>(out, iters);
  else rate<16><<<blocks, threads, 0, st>>>(out, iters);
  return (int)cudaGetLastError();
}
extern "C" const char* probe_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
"""
MAIN_CASES = [c for c in cs.WY_CASES if c[1] in (cs.GIANT_M, cs.GIANT64_M)]


def build_variants():
    out = _build.build_dir() / "wy64_variants"
    out.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "wy_gram_f64.cu").read_text()
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"variant {name}: the source no longer holds {old!r}")
            text = text.replace(old, new)
        (out / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", str(out / f"{name}.so"), str(out / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, report = {}, {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        path = out / f"{name}.so"
        path.with_suffix(".log").write_text(log)
        lib = ctypes.CDLL(str(path))
        ptr, i = ctypes.c_void_p, ctypes.c_int
        lib.wy_gram_f64.argtypes = [ptr] * 8 + [i] * 5 + [ptr]
        lib.wy_gram_f64.restype = i
        lib.wy_gram_error_string.argtypes = [i]
        lib.wy_gram_error_string.restype = ctypes.c_char_p
        lib._enlsip_bound = True
        libs[name] = lib
        dmma = _build.sass_opcodes(path, "DMMA")
        report[name] = [{**row, "dmma": dmma.get(row["kernel"])}
                        for row in _build.ptxas_rows(log)]
    return libs, report


def time_only(case):
    """The four entry points' ms at one case, nothing held."""
    name, m, n, k, _ = case
    d = torch.float64
    J = torch.randn(m, n, dtype=d, device="cuda")
    V, T = torch.randn(n, k, dtype=d, device="cuda"), torch.eye(k, dtype=d,
                                                                device="cuda")
    rx, s = torch.randn(m, dtype=d, device="cuda"), torch.randn(m, dtype=d,
                                                                device="cuda")
    reps = 3 if m * n >= 10 ** 8 else 10
    runs = {"wy_right_apply": lambda: wy.wy_right_apply(J, V, T),
            "wy_gram_project": lambda: wy.wy_gram_project(J, V, T, rx),
            "wy_gram_project_rowscale": lambda: wy.wy_gram_project(J, V, T,
                                                                   rx, s),
            "wy_gram_project_noapply": lambda: wy.wy_gram_project_noapply(
                J, V, T, rx, s)}
    return [{"kernel": kname, "case": name, "shape": [m, n, k],
             "ms": cs.cuda_ms(run, reps=reps)} for kname, run in runs.items()]


def run_variant(name, lib):
    """Every case with ``lib`` in place of the float64 library."""
    original = wy._library
    wy._library = lambda dtype=torch.float32: lib if dtype == torch.float64 \
        else original(dtype)
    rows = []
    try:
        if name in TIMED_ONLY:
            for case in MAIN_CASES:
                rows += time_only(case)
            return rows
        for case in cs.WY_EDGE_CASES_F64 + MAIN_CASES:
            try:
                got = cs.check_wy_case(*case, torch.float64)
            except Exception as err:          # reported, and the variant stops
                rows.append({"case": case[0], "failed": repr(err)[:2000]})
                break
            rows += [{k: r[k] for k in ("kernel", "case", "shape", "rel_err",
                                        "bits_equal", "ms", "plain_ms",
                                        "bound_ms", "bound_by")}
                     for r in got]
            torch.cuda.empty_cache()
    finally:
        wy._library = original
    return rows


def dmma_rate():
    """TFLOP/s of back-to-back float64 mma with register operands."""
    out = _build.build_dir() / "wy64_variants"
    out.mkdir(parents=True, exist_ok=True)
    (out / "dmma_probe.cu").write_text(PROBE)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                    str(out / "dmma_probe.so"), str(out / "dmma_probe.cu")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(out / "dmma_probe.so"))
    lib.dmma_probe.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    lib.probe_error.argtypes = [ctypes.c_int]
    lib.probe_error.restype = ctypes.c_char_p
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    buf = torch.empty(sms * 512, dtype=torch.float64, device="cuda")
    rates, iters = {}, 4096
    for K in (4, 8, 16):
        for warps in (4, 8, 12, 16):
            launch = lambda: lib.dmma_probe(K, sms, 32 * warps, iters,
                                            buf.data_ptr(),
                                            torch.cuda.current_stream().cuda_stream)
            err = launch()
            torch.cuda.synchronize()
            if err != 0:
                rates[f"m16n8k{K} x {warps} warps"] = \
                    f"launch failed: {lib.probe_error(err).decode()} ({err})"
                continue
            ms = cs.cuda_ms(launch, reps=5)
            flops = 2 * 16 * 8 * K * 8 * iters * 32 * warps / 32 * sms
            rates[f"m16n8k{K} x {warps} warps"] = flops / (ms * 1e-3) / 1e12
    return rates


def main() -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"device": smi, "torch": torch.__version__,
                      "cuda": torch.version.cuda}), flush=True)
    t0 = time.time()
    libs, report = build_variants()
    print(json.dumps({"build": report, "seconds": time.time() - t0}), flush=True)
    for name, lib in libs.items():
        t0 = time.time()
        print(json.dumps({"variant": name, "cases": run_variant(name, lib),
                          "seconds": time.time() - t0}), flush=True)
    print(json.dumps({"dmma_rate_TFLOPs": dmma_rate()}), flush=True)


if __name__ == "__main__":
    main()
