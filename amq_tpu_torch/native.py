"""ctypes bindings for the port's native host runtime (``csrc/amq_native.cpp``).

The library is compiled with the host C++ compiler (``g++ -O3 -fPIC
-std=c++17 -shared``) at first use into ``amq_tpu_torch/_build/``, under a
name that carries a hash of the source, so an edited source is rebuilt.
A failed build or load raises: nothing here falls back quietly.  The
pure-Python scheduler is a separate, explicit path
(``ContinuousBatcher(use_native=False)`` or ``AMQ_NATIVE_SCHED=0``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent / "csrc" / "amq_native.cpp"
_BUILD = Path(__file__).resolve().parent / "_build"
_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
_lib: Optional[ctypes.CDLL] = None

#: widths the C++ packer implements
_NATIVE_BITS = (1, 2, 3, 4, 8)


def _lib_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:12]
    return _BUILD / f"libamq_native_{digest}.so"


def _build(out: Path) -> None:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no host C++ compiler (g++ or c++) to build "
                           f"{_SRC.name}; set CXX")
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *_FLAGS, "-o", str(tmp), str(_SRC)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building {_SRC.name} failed:\n{proc.stderr}")
    os.replace(tmp, out)


def get_lib() -> ctypes.CDLL:
    """The loaded native library, built on first use."""
    global _lib
    if _lib is None:
        path = _lib_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
        _bind(lib)
        _lib = lib
    return _lib


def _bind(lib: ctypes.CDLL) -> None:
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    h, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    sigs = {
        "amq_pack": ([u32p, u32p, i64, i64, i64, ctypes.c_int], ctypes.c_int),
        "amq_unpack": ([u32p, u32p, i64, i64, i64, ctypes.c_int],
                       ctypes.c_int),
        "amq_sched_create": ([i32], h),
        "amq_sched_destroy": ([h], None),
        "amq_sched_submit2": ([h, i64, i32, i32, i32], None),
        "amq_sched_fill2": ([h, i32, i32p, i64p, i32], i32),
        "amq_sched_preempt": ([h, i32p, i64p, i32p, i32], i32),
        "amq_sched_step2": ([h, u8p, i32p, i32], i32),
        "amq_sched_active": ([h], i32),
        "amq_sched_pending": ([h], i64),
        "amq_sched_prefill": ([h, i32], i32),
    }
    for name, (argtypes, restype) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype


def pack_native(codes: np.ndarray, nbits: int,
                group_size: int = 128) -> Optional[np.ndarray]:
    """Native pack of codes ``[K, N]`` into words ``[K*b/32, N]``; None for
    a width the packer does not implement (callers take core.bitpack)."""
    if nbits not in _NATIVE_BITS:
        return None
    lib = get_lib()
    codes = np.ascontiguousarray(codes, np.uint32)
    K, N = codes.shape
    out = np.empty((K * nbits // 32, N), np.uint32)
    rc = lib.amq_pack(codes, out, K, N, group_size, nbits)
    if rc != 0:
        raise ValueError(f"amq_pack failed rc={rc}")
    return out


def unpack_native(words: np.ndarray, nbits: int, K: int,
                  group_size: int = 128) -> Optional[np.ndarray]:
    """Native unpack of words ``[K*b/32, N]`` into codes ``[K, N]``; None
    for a width the packer does not implement."""
    if nbits not in _NATIVE_BITS:
        return None
    lib = get_lib()
    words = np.ascontiguousarray(words, np.uint32)
    N = words.shape[1]
    out = np.empty((K, N), np.uint32)
    rc = lib.amq_unpack(words, out, K, N, group_size, nbits)
    if rc != 0:
        raise ValueError(f"amq_unpack failed rc={rc}")
    return out


class NativeScheduler:
    """Continuous-batching scheduler backed by the C++ core."""

    def __init__(self, n_slots: int):
        self._lib = get_lib()
        self._h = self._lib.amq_sched_create(n_slots)
        self.n_slots = n_slots

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.amq_sched_destroy(self._h)
            self._h = None

    def submit(self, uid: int, max_new_tokens: int, priority: int = 0,
               prompt_len: int = 0) -> None:
        self._lib.amq_sched_submit2(self._h, uid, max_new_tokens, priority,
                                    prompt_len)

    def fill(self, prefill_budget: int = 0) -> List[Tuple[int, int]]:
        """Admit queued requests into free slots, highest priority first,
        keeping this call's admitted prompt tokens within
        ``prefill_budget`` (0 = uncapped; one admission always allowed).
        Returns ``[(slot, uid)]``."""
        slots = np.empty(self.n_slots, np.int32)
        uids = np.empty(self.n_slots, np.int64)
        n = self._lib.amq_sched_fill2(self._h, prefill_budget, slots, uids,
                                      self.n_slots)
        return list(zip(slots[:n].tolist(), uids[:n].tolist()))

    def preempt(self) -> List[Tuple[int, int, int]]:
        """Evict active slots outprioritized by pending requests that no
        free slot can take; returns ``[(slot, uid, generated_so_far)]``.
        Victims re-enter the queue with their token count preserved."""
        slots = np.empty(self.n_slots, np.int32)
        uids = np.empty(self.n_slots, np.int64)
        gen = np.empty(self.n_slots, np.int32)
        n = self._lib.amq_sched_preempt(self._h, slots, uids, gen,
                                        self.n_slots)
        return list(zip(slots[:n].tolist(), uids[:n].tolist(),
                        gen[:n].tolist()))

    def step(self, mask=None) -> List[int]:
        """Record one decoded token per active slot (restricted to ``mask``
        when given: slots mid-chunked-prefill are occupied but not
        decoding); returns the retired slot indices."""
        retired = np.empty(self.n_slots, np.int32)
        m = (np.ones(self.n_slots, np.uint8) if mask is None
             else np.ascontiguousarray(np.asarray(mask, np.uint8)))
        n = self._lib.amq_sched_step2(self._h, m, retired, self.n_slots)
        return retired[:n].tolist()

    def prefill(self, slot: int) -> bool:
        """Record the prefill's first token for ``slot``; True if retired."""
        r = self._lib.amq_sched_prefill(self._h, slot)
        if r < 0:
            raise RuntimeError(f"prefill on empty slot {slot}")
        return bool(r)

    @property
    def active(self) -> int:
        return self._lib.amq_sched_active(self._h)

    @property
    def pending(self) -> int:
        return self._lib.amq_sched_pending(self._h)
