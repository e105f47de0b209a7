"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/*.cu`` source becomes one shared library with a plain C
interface, compiled for Hopper (``sm_90a``) into ``ctrl_sim_tpu_torch/_build/``
under a name keyed by a hash of the source and the flags, so an edited
source is rebuilt and an unchanged one is not. ``build`` starts one nvcc per
missing library, all at once, and waits for them; a failed build raises with
nvcc's stderr. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = ("decode_attention.cu", "decode_attention_q8.cu", "flash_attention.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",  # registers, shared memory and spills of each kernel
)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def library_path(source: str) -> Path:
    digest = hashlib.sha256((CSRC_DIR / source).read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}_{digest.hexdigest()[:16]}.so"


def build(sources: tuple[str, ...] = SOURCES) -> dict[str, str]:
    """Compile every source whose library is missing, in parallel. Returns
    nvcc's ptxas report for each source it compiled."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for source in sources:
        target = library_path(source)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / source)]
        procs[source] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
            tmp,
            target,
        )
    reports, failures = {}, []
    for source, (proc, tmp, target) in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed on {source} (exit {proc.returncode}):\n{out}{err}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, target)  # atomic: a concurrent loader sees all or nothing
        reports[source] = out + err
    if failures:
        raise RuntimeError("\n".join(failures))
    return reports


@functools.lru_cache(maxsize=None)
def load(source: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if it is missing."""
    build((source,))
    return ctypes.CDLL(str(library_path(source)))
