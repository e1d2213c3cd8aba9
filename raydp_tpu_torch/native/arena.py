"""ctypes binding + on-demand build of the C++ shared-memory arena — the
port's copy of :mod:`raydp_tpu.native.arena`.

The C core (``raydp_tpu_torch/csrc/store/arena.cpp``, a verbatim copy of the
reference's ``csrc/store/arena.cpp``) is compiled by ``g++`` into the
git-ignored ``raydp_tpu_torch/_build/librdtstore.so`` the first time a
session needs it (guarded by a file lock so concurrently-spawning actor
processes don't race the compiler). Readers of arena-resident objects do not need this library at all —
they attach the segment with :mod:`multiprocessing.shared_memory` and slice a
zero-copy memoryview; only writers (``rdt_alloc``) and the head's free path
(``rdt_free``) go through the native calls.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading
from typing import Dict, Optional, Tuple

from raydp_tpu_torch.log import get_logger

logger = get_logger("native.arena")

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "store", "arena.cpp")
_LIB_DIR = os.path.join(_PKG, "_build")
_LIB = os.path.join(_LIB_DIR, "librdtstore.so")

_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_failed = False


def _build() -> None:
    os.makedirs(_LIB_DIR, exist_ok=True)
    lock_path = os.path.join(_LIB_DIR, ".store.build.lock")
    with open(lock_path, "w") as lock_file:
        fcntl.flock(lock_file, fcntl.LOCK_EX)
        try:
            if os.path.exists(_LIB) and (
                    not os.path.exists(_SRC)  # prebuilt lib shipped sans csrc/
                    or os.path.getmtime(_LIB) >= os.path.getmtime(_SRC)):
                return
            tmp = _LIB + ".tmp"
            subprocess.run(
                ["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
                 "-o", tmp, _SRC, "-lpthread", "-lrt"],
                check=True, capture_output=True, text=True)
            os.replace(tmp, _LIB)
            logger.info("built native store core -> %s", _LIB)
        finally:
            fcntl.flock(lock_file, fcntl.LOCK_UN)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_failed
    with _lib_lock:
        if _lib is not None or _lib_failed:
            return _lib
        try:
            _build()
            lib = ctypes.CDLL(_LIB)
            lib.rdt_arena_create.restype = ctypes.c_void_p
            lib.rdt_arena_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
            lib.rdt_arena_attach.restype = ctypes.c_void_p
            lib.rdt_arena_attach.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint64)]
            lib.rdt_alloc.restype = ctypes.c_int64
            lib.rdt_alloc.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
            lib.rdt_free.restype = ctypes.c_int
            lib.rdt_free.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
            lib.rdt_stats.restype = None
            lib.rdt_stats.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64)]
            lib.rdt_detach.restype = ctypes.c_int
            lib.rdt_detach.argtypes = [ctypes.c_void_p]
            lib.rdt_unlink.restype = ctypes.c_int
            lib.rdt_unlink.argtypes = [ctypes.c_char_p]
            _lib = lib
        except Exception as e:
            _lib_failed = True
            logger.warning("native store core unavailable (%s); "
                           "falling back to per-object segments", e)
        return _lib


def native_store_available() -> bool:
    return _load() is not None


class Arena:
    """One session-wide shared-memory arena holding all object payloads.

    ``segment`` is the Python-style segment name (no leading slash), the same
    name :class:`multiprocessing.shared_memory.SharedMemory` uses, so readers
    without the native library can still attach it.
    """

    def __init__(self, segment: str, base: int, size: int, owner: bool):
        self.segment = segment
        self.size = size
        self._base = base
        self._owner = owner
        self._closed = False

    # -- construction -------------------------------------------------------
    @classmethod
    def create(cls, segment: str, size: int) -> "Arena":
        lib = _load()
        if lib is None:
            raise RuntimeError("native store core unavailable")
        base = lib.rdt_arena_create(("/" + segment).encode(), size)
        if not base:
            raise RuntimeError(
                f"failed to create arena segment {segment} ({size} bytes)")
        return cls(segment, base, size, owner=True)

    @classmethod
    def attach(cls, segment: str) -> "Arena":
        lib = _load()
        if lib is None:
            raise RuntimeError("native store core unavailable")
        size = ctypes.c_uint64()
        base = lib.rdt_arena_attach(("/" + segment).encode(), ctypes.byref(size))
        if not base:
            raise RuntimeError(f"failed to attach arena segment {segment}")
        return cls(segment, base, size.value, owner=False)

    # -- allocation ---------------------------------------------------------
    def alloc(self, size: int) -> Optional[int]:
        """Payload offset for ``size`` bytes, or None if the arena is full."""
        off = _load().rdt_alloc(self._base, size)
        return None if off < 0 else off

    def free(self, offset: int) -> bool:
        return _load().rdt_free(self._base, offset) == 0

    def view(self, offset: int, size: int) -> memoryview:
        """Zero-copy writable view of the payload at ``offset``."""
        if offset < 0 or offset + size > self.size:
            raise ValueError(f"view [{offset}, {offset + size}) outside arena")
        if size == 0:
            return memoryview(b"")
        buf = (ctypes.c_ubyte * size).from_address(self._base + offset)
        return memoryview(buf).cast("B")

    def stats(self) -> Dict[str, int]:
        out = (ctypes.c_uint64 * 4)()
        _load().rdt_stats(self._base, out)
        return {"arena_size": out[0], "bytes_in_use": out[1],
                "num_allocs": out[2], "peak_bytes": out[3]}

    # -- lifetime -----------------------------------------------------------
    def detach(self) -> None:
        if not self._closed:
            self._closed = True
            _load().rdt_detach(self._base)

    def unlink(self) -> None:
        _load().rdt_unlink(("/" + self.segment).encode())

    def close(self) -> None:
        owner = self._owner
        self.detach()
        if owner:
            self.unlink()
