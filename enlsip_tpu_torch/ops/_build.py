"""Build the package's CUDA sources with ``nvcc`` into shared libraries
with a plain C interface, loaded through ``ctypes``.

Nothing here runs at import time.  :func:`load_library` compiles
``csrc/<name>.cu`` for ``sm_90a`` at first use into the build directory
(``build/`` beside the package), keyed by a hash of every file under
``csrc/`` so an edited source is rebuilt and an unchanged one is reused.
:func:`build_all` starts one ``nvcc`` per source at once.  The compiler
runs with ``-Xptxas -v``; its output is kept beside the library and
:func:`resource_usage` condenses it to one line a kernel (registers,
spill, static shared memory).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    return CSRC.parent.parent / "build"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels of enlsip_tpu_torch "
                       "are compiled at first use and need the CUDA toolkit")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return build_dir() / f"lib{name}_{_source_hash()}.so"


def _start_build(name: str):
    """Start nvcc for ``csrc/<name>.cu``; returns (process, tmp, final)."""
    out = library_path(name)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(name: str, proc, tmp: Path, out: Path) -> Path:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)        # atomic: a reader never sees a partial file
    return out


def resource_usage(name: str) -> list[dict]:
    """What ptxas reported for every kernel of ``csrc/<name>.cu`` when the
    library was built: mangled name, registers, spill bytes (stores,
    loads), static shared memory."""
    log = library_path(name).with_suffix(".log")
    return ptxas_rows(log.read_text()) if log.exists() else []


def ptxas_rows(log: str) -> list[dict]:
    """One row a kernel from the text ``nvcc -Xptxas -v`` printed."""
    rows, kernel = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            kernel = {"kernel": m.group(1)}
            rows.append(kernel)
            continue
        if kernel is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            kernel["spill_bytes"] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m:
            kernel["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            kernel["static_shared_bytes"] = int(sm.group(1)) if sm else 0
    return rows


def sass_opcodes(path: Path, opcode: str) -> dict:
    """How many instructions of ``opcode`` (for example ``DMMA``, the
    float64 tensor-core product) the SASS of every kernel of the library
    at ``path`` holds, by mangled kernel name, as ``cuobjdump -sass``
    lists it."""
    tool = Path(_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(path)],
                          capture_output=True, text=True, check=True).stdout
    counts, kernel = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            kernel = m.group(1)
            counts[kernel] = 0
        elif kernel is not None and re.search(rf"\b{opcode}\b", line):
            counts[kernel] += 1
    return counts


def build_all(names=None) -> dict[str, Path]:
    """Build every (or the named) ``csrc/*.cu`` not built yet, all
    compilers started together."""
    names = list(names) if names else sorted(p.stem for p in CSRC.glob("*.cu"))
    jobs = {n: _start_build(n) for n in names if not library_path(n).exists()}
    for n, (proc, tmp, out) in jobs.items():
        _finish_build(n, proc, tmp, out)
    return {n: library_path(n) for n in names}


def load_library(name: str) -> ctypes.CDLL:
    """The shared library of ``csrc/<name>.cu``, built at first use."""
    if name not in _loaded:
        path = build_all([name])[name]
        _loaded[name] = ctypes.CDLL(str(path))
    return _loaded[name]
