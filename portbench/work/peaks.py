"""Published peaks of one NVIDIA H100 SXM (80 GB HBM3), the card the
benchmark runs on, and the card's power limit read at run time.

Source: NVIDIA H100 Tensor Core GPU data sheet, SXM form factor, dense
rates (no sparsity), at the full 700 W power limit: HBM3 at 3.35 TB/s;
FP64 at 34 TFLOP/s outside the tensor cores and 67 TFLOP/s on the FP64
tensor cores; FP32 at 67 TFLOP/s outside the tensor cores.  The rates
below are the ones the port's kernel checks have used since its first
kernel (float64 at half the float32 rate outside the tensor cores), kept
here unchanged so that every share the benchmark reports is held to the
same peaks.  A card set below 700 W runs slower under load: every run
reports its ``power.limit`` beside the shares.
"""

from __future__ import annotations

import subprocess

HBM_BYTES_PER_S = 3.35e12

# Arithmetic peaks outside the tensor cores, by element size in bytes.
PEAK_FLOPS = {4: 67e12, 8: 33.5e12}


def power_limit_w(index: int = 0):
    """The card's power limit in watts as ``nvidia-smi`` reports it, or
    None where it cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", f"--id={index}"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None
