"""Build the port's CUDA sources at first use and load them with ``ctypes``.

Each ``raydp_tpu_torch/csrc/<name>.cu`` exposes a plain ``extern "C"``
interface and is compiled by ``nvcc`` for Hopper (``sm_90a``) into
``raydp_tpu_torch/_build/<name>-<hash>.so``. The hash covers the source, every
shared header ``csrc/*.cuh`` and the flags, so an edited source or header is
rebuilt and an unchanged one is reused. A
missing compiler, a failed build or a failed load raises: there is no
fallback. ``nvcc``'s own report (``-Xptxas=-v``: registers, shared memory,
spills per kernel) is kept beside the library as ``<name>-<hash>.log``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc`` (default ``/usr/local/cuda``),
    else ``nvcc`` on ``PATH``."""
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    candidate = home / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            f"nvcc not found at {candidate} or on PATH: the port's kernels "
            "are compiled from raydp_tpu_torch/csrc with the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives. Any source may
    include any shared header, so each header's name and content count."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists."""
    lib = library_path(name)
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build {name}.cu:\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    return lib


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load the library of ``csrc/<name>.cu``, once."""
    return ctypes.CDLL(str(build(name)))
