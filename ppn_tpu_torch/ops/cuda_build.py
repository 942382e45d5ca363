"""nvcc build and ctypes loading of the port's CUDA sources.

Each source in ``ppn_tpu_torch/csrc/`` compiles on its own, for ``sm_90a``,
into a shared library with a plain C interface under
``build/ppn_tpu_torch/`` (a directory ``.gitignore`` lists), at first use.
``build`` starts one ``nvcc`` per out-of-date source, all at once, and
waits for all of them, so that a caller holding several kernels pays for
the slowest build, not the sum.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ppn_tpu_torch"
# --fmad=false keeps every product and sum rounded on its own, as the plain
# PyTorch versions round them; no fast math (full-precision expf and
# IEEE division).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler",
              "-fPIC")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found (looked on PATH and in {home})")
    return path


def lib_path(source: str) -> Path:
    """The shared library built from ``csrc/<source>``."""
    return BUILD_DIR / f"libppn_{Path(source).stem}.so"


def build(sources, force: bool = False) -> dict[str, str]:
    """Compile each ``csrc/<source>`` whose library is missing or older
    than it (every one with ``force``), all nvcc processes in parallel.
    Returns nvcc's report (ptxas registers and shared memory) by source,
    "" for one already up to date. Raises on any failed build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, reports = {}, {}
    for source in sources:
        src, lib = CSRC / source, lib_path(source)
        if (not force and lib.exists()
                and lib.stat().st_mtime >= src.stat().st_mtime):
            reports[source] = ""
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        procs[source] = (tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for source, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        reports[source] = out
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {CSRC / source}:\n{out}")
        else:
            # atomic: no process loads a half-written library
            os.replace(tmp, lib_path(source))
    if failed:
        raise RuntimeError("\n".join(failed))
    return reports


def load(source: str) -> ctypes.CDLL:
    """The library of ``csrc/<source>``, built first if out of date."""
    build([source])
    return ctypes.CDLL(str(lib_path(source)))
