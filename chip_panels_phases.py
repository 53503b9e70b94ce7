"""Where the time of B1's panel kernel goes, phase by phase, and its bits
against another version of the kernel, on the card.

    python3 chip_panels_phases.py [--parent REV_OR_FILE]

Factors cr5000's A_act^T (5000 x 4998, every step: ``randn``, and the
solve's own, the constraint Jacobian at the documented start transposed,
which is what the solve's first pass factors) and J2 (9998 x 5000, 2 live
columns) at float32 and float64.

* ``bits`` lines (with ``--parent``): the other version's
  ``csrc/cpqr_panels.cu`` (a git revision read with ``git show``, or a
  file, where the checkout has no git) is built into its own library;
  both factor every case on all the card's SMs and on half of them, and
  the packed result, tau and perm must be equal to the bit.  Each line
  has both launches' times (CUDA events, median of three after a warm-up).
* ``phases`` lines: the source built again with ``-DCPQR_PANELS_CLOCKS``
  (block 0's first thread adds the %globaltimer ns of each phase of its
  step loop and prints the sums when the launch ends), as it is, with its
  W^T v sweep walked forward at every step (``one_way``), and the other
  version's (``parent``); one launch a case.  Phases: start
  (transposition, first norms), P (this block's candidate), B1, pivot, A
  (bcol), B2, refl (the reflector), tails+w2 (v's tail, v staged, Vp^T
  v), w1 (W^T v), B3, C (F column, row k, downdate), end (panel ends).
  Beside them: the bytes the sweep reads (live columns times the rows
  from k & ~127 on, every step), its rate over block 0's w1 phase and
  over w1 + B3 (the grid's sweep, B3 being block 0's wait for the
  slowest block), and ``B3_wait_ns``.

Prints the card's name and power limit first.  Needs one NVIDIA GPU and
nvcc; exits 1 without a card.
"""

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

if not torch.cuda.is_available():
    sys.stderr.write("chip_panels_phases.py needs a CUDA device\n")
    sys.exit(1)

from enlsip_tpu_torch.ops import _build
from enlsip_tpu_torch.ops import cpqr_hopper as ch

PHASES = ("start", "P", "B1", "pivot", "A", "B2", "refl", "tails+w2", "w1",
          "B3", "C", "end")
SOURCE = "enlsip_tpu_torch/csrc/cpqr_panels.cu"
# the kernel's choice of direction, which the one-way build replaces
ALTERNATE = "const bool fwd = (k & 1) == 0;"


def cases(dtype):
    """(name, matrix, nsteps) of each case, the same on every call."""
    from portbench.configs.chained_rosenbrock import problem
    g = torch.Generator(device="cuda").manual_seed(5)
    A = torch.randn(5000, 4998, generator=g, dtype=dtype, device="cuda")
    prob = problem(dtype, "cuda", 5000)
    x0 = torch.as_tensor(prob["x0"], dtype=dtype, device="cuda")
    real = prob["jac_eq"](x0).t().contiguous()
    J2 = torch.zeros(9998, 5000, dtype=dtype, device="cuda")
    J2[:, -2:] = torch.randn(9998, 2, generator=g, dtype=dtype, device="cuda")
    return [("A_act^T cr5000", A, 4998),
            ("A_act^T cr5000, the solve's", real, 4998),
            ("J2 cr5000", J2, 2)]


def sweep_bytes(rows, cols, nsteps, itemsize):
    """Bytes the W^T v sweep reads in a launch: at step k the live
    columns (cols - k - 1) from row k & ~127 to the padded end."""
    ldw = (rows + 3) & ~3
    return sum((cols - k - 1) * (ldw - (k & ~127)) * itemsize
               for k in range(min(nsteps, rows, cols)))


def ms(fn, reps=3):
    fn()
    times = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def read_source(parent: str) -> str:
    if Path(parent).is_file():
        return Path(parent).read_text()
    return subprocess.run(["git", "show", f"{parent}:{SOURCE}"],
                          capture_output=True, text=True, check=True).stdout


def build(sources: dict) -> dict:
    """One nvcc a (name: (source text, extra flags)), all at once."""
    out_dir = _build.build_dir() / f"panels_{os.getpid()}"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, (text, flags) in sources.items():
        src = out_dir / f"{name}.cu"
        src.write_text(text)
        lib = out_dir / f"lib{name}.so"
        jobs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-I", str(_build.CSRC),
             "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    # the resident route's library answers the wrapper's device query
    resident = (None if _build.library_path("cpqr").exists()
                else _build._start_build("cpqr"))
    libs = {}
    for name, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        print(json.dumps({"build": name, "ptxas": _build.ptxas_rows(log)}),
              flush=True)
        libs[name] = lib
    if resident:
        _build._finish_build("cpqr", *resident)
    return libs


def using(lib_path):
    """Make the wrapper launch the kernel of ``lib_path`` from now on."""
    _build._loaded["cpqr_panels"] = ctypes.CDLL(str(lib_path))


def check_bits(tree_lib, parent_lib):
    sms = ch._device_limits("cuda")[0]
    for dtype in (torch.float32, torch.float64):
        for name, M, ns in cases(dtype):
            row = {"case": name, "dtype": str(dtype).replace("torch.", ""),
                   "shape": list(M.shape), "nsteps": ns}
            got = {}
            for side, lib in (("tree", tree_lib), ("parent", parent_lib)):
                using(lib)
                for blocks in (sms, sms // 2):
                    got[side, blocks] = ch._launch("panels", M, ns, blocks)
                row[f"{side}_ms"] = ms(lambda: ch._launch("panels", M, ns))
            for blocks in (sms, sms // 2):
                row[f"bits_equal_parent_{blocks}_blocks"] = all(
                    torch.equal(a, b) for a, b in
                    zip(got["tree", blocks], got["parent", blocks]))
            row["bits_equal_tree_blocks"] = all(
                torch.equal(a, b) for a, b in
                zip(got["tree", sms], got["tree", sms // 2]))
            print(json.dumps(row), flush=True)
            assert all(v for k, v in row.items() if k.startswith("bits_")), row
            del got, M


def phases(libs):
    for build_name, lib in libs.items():
        # one child a build: the kernel's printf reaches the child's stdout
        # (one line a launch, in launch order) when the child ends
        out = subprocess.run(
            [sys.executable, "-c", _CHILD, str(lib)], capture_output=True,
            text=True, check=True,
            env=dict(os.environ, PYTHONPATH=os.getcwd())).stdout
        sums = [[int(v) for v in line.split()[1::2]] for line in
                re.findall(r"phase ns: (.*)", out)][1:]   # after the small one
        timed = [json.loads(line[5:]) for line in out.splitlines()
                 if line.startswith("CASE ")]
        assert len(sums) == len(timed), (build_name, len(sums), len(timed))
        for nums, t in zip(sums, timed):
            ph = dict(zip(PHASES, nums))
            nbytes = sweep_bytes(*t["shape"], t["nsteps"], t["itemsize"])
            print(json.dumps({
                "phases": build_name, "case": t["case"], "dtype": t["dtype"],
                "clocked_ms": t["ms"], "phase_ns": ph,
                "launch_ns": sum(nums),
                "sweep_bytes": nbytes,
                "sweep_GBps_w1": nbytes / max(ph["w1"], 1),
                "sweep_GBps_w1_B3": nbytes / max(ph["w1"] + ph["B3"], 1),
                "B3_wait_ns": ph["B3"]}), flush=True)


_CHILD = r"""
import json, sys, torch
sys.path.insert(0, '.')
from chip_panels_phases import cases, using
from enlsip_tpu_torch.ops import cpqr_hopper as ch
using(sys.argv[1])
# a small launch first, so that loading the module falls outside the times
ch._launch("panels", torch.ones(64, 64, device="cuda"), 64)
torch.cuda.synchronize()
for dtype in (torch.float32, torch.float64):
    for name, M, ns in cases(dtype):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        a.record()
        ch._launch("panels", M, ns)
        b.record()
        torch.cuda.synchronize()
        print("CASE " + json.dumps({
            "case": name, "dtype": str(dtype).replace("torch.", ""),
            "shape": list(M.shape), "nsteps": ns,
            "itemsize": M.element_size(), "ms": a.elapsed_time(b)}),
            flush=True)
"""


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="the other version's cpqr_panels.cu: "
                    "a git revision, or a file")
    args = ap.parse_args()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    tree = (_build.CSRC / "cpqr_panels.cu").read_text()
    assert tree.count(ALTERNATE) == 1, "the sweep's direction rule moved"
    clocks = ["-DCPQR_PANELS_CLOCKS"]
    sources = {"tree": (tree, []), "tree_clocks": (tree, clocks),
               "one_way_clocks": (tree.replace(ALTERNATE,
                                               "const bool fwd = true;"),
                                  clocks)}
    if args.parent:
        parent = read_source(args.parent)
        sources.update(parent=(parent, []), parent_clocks=(parent, clocks))
    libs = build(sources)
    if args.parent:
        check_bits(libs["tree"], libs["parent"])
    phases({"tree": libs["tree_clocks"], "one_way": libs["one_way_clocks"],
            **({"parent": libs["parent_clocks"]} if args.parent else {})})


if __name__ == "__main__":
    main()
