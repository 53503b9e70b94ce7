"""Where the time of B1's panel kernel goes, phase by phase, on the card.

Builds ``enlsip_tpu_torch/csrc/cpqr_panels.cu`` a second time with
``-DCPQR_PANELS_CLOCKS`` (block 0's first thread adds the %globaltimer ns
of each phase of its step loop and prints the sums when the launch ends)
and factors cr5000's A_act^T (5000 x 4998, every step) and J2 (9998 x
5000, 2 live columns) at float32 and float64 with it, after one call of
the kernel as built for the package, timed with CUDA events.  Prints the
card's name and power limit, then one JSON line a case: the phase sums
(ns) and the two times (ms).  Phases: start (transposition, first
norms), P (this block's candidate), B1, pivot, A (bcol), B2, refl (the
reflector), tails+w2 (v's tail, v staged, Vp^T v), w1 (W^T v), B3, C (F
column, row k, downdate), end (panel ends).  Needs one NVIDIA GPU and
nvcc; exits 1 without a card.

    python3 chip_panels_phases.py
"""

import json
import os
import re
import subprocess
import sys

import torch

if not torch.cuda.is_available():
    sys.stderr.write("chip_panels_phases.py needs a CUDA device\n")
    sys.exit(1)

from enlsip_tpu_torch.ops import _build
from enlsip_tpu_torch.ops import cpqr_hopper as ch

PHASES = ("start", "P", "B1", "pivot", "A", "B2", "refl", "tails+w2", "w1",
          "B3", "C", "end")


def cases(dtype):
    g = torch.Generator(device="cuda").manual_seed(5)
    A = torch.randn(5000, 4998, generator=g, dtype=dtype, device="cuda")
    J2 = torch.zeros(9998, 5000, dtype=dtype, device="cuda")
    J2[:, -2:] = torch.randn(9998, 2, generator=g, dtype=dtype, device="cuda")
    return [("A_act^T cr5000", A, 4998), ("J2 cr5000", J2, 2)]


def ms(fn):
    fn()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    a.record()
    fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b)


def main():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _build.build_all(["cpqr", "cpqr_panels"])
    timed = {}
    for dtype in (torch.float32, torch.float64):
        for name, M, ns in cases(dtype):
            timed[name, dtype] = ms(lambda: ch.cpqr_hopper_panels(M, ns))
    clocked = _build.build_dir() / f"libcpqr_panels_clocks_{os.getpid()}.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-DCPQR_PANELS_CLOCKS",
                    "-o", str(clocked), str(_build.CSRC / "cpqr_panels.cu")],
                   check=True, capture_output=True)
    for dtype in (torch.float32, torch.float64):
        for name, M, ns in cases(dtype):
            # the kernel's printf reaches the process's stdout at the sync
            out = subprocess.run(
                [sys.executable, "-c", _CHILD, str(clocked), name,
                 str(dtype).replace("torch.", "")],
                capture_output=True, text=True, check=True,
                env=dict(os.environ, PYTHONPATH=os.getcwd())).stdout
            nums = [int(v) for v in re.search(r"phase ns: (.*)", out)
                    .group(1).split()[1::2]]
            print(json.dumps({"case": name, "dtype": str(dtype),
                              "ms": timed[name, dtype],
                              "clocked_ms": float(re.search(r"ms (\S+)", out)
                                                  .group(1)),
                              "phase_ns": dict(zip(PHASES, nums))}),
                  flush=True)
    clocked.unlink()


# A child process per clocked case, so that the kernel's printf (flushed
# to the child's stdout) is read whole.
_CHILD = r"""
import ctypes, sys, torch
from enlsip_tpu_torch.ops import _build, cpqr_hopper as ch
sys.path.insert(0, '.')
from chip_panels_phases import cases, ms
_build._loaded['cpqr_panels'] = ctypes.CDLL(sys.argv[1])
dtype = getattr(torch, sys.argv[3])
M, ns = [(M, ns) for name, M, ns in cases(dtype) if name == sys.argv[2]][0]
ch.cpqr_hopper_panels(M, ns)
torch.cuda.synchronize()
print('ms', ms(lambda: ch.cpqr_hopper_panels(M, ns)), flush=True)
"""

if __name__ == "__main__":
    main()
