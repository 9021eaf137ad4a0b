"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (``nvcc -gencode arch=compute_90a,code=sm_90a
-std=c++17 -O3 -shared -Xcompiler -fPIC``), at first use, into
``amq_tpu_torch/_build/`` (listed in ``.gitignore``).  The library name
carries a hash of its source, the shared headers (``csrc/*.cuh``) and any
``-D`` defines (a probe's build-time variant), so an edited source or
header is rebuilt.  Pointers and the stream cross as
``c_void_p``; every C entry point returns the launch's
``cudaGetLastError()`` (or -1 for arguments it does not take).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

import torch

SOURCES = ("quant_matmul", "decode_attention", "flash_attention",
           "quant_matmul_pipe", "quant_matmul_mlp", "gemv_attrib",
           "gemv_extract_ahead", "dequant", "quant_matmul_tile",
           "quant_matmul_f32", "moe_experts")
_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD = Path(__file__).resolve().parent.parent / "_build"
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC")
_LIBS: Dict[Tuple[str, Tuple[str, ...]], ctypes.CDLL] = {}
#: the compiler's report of each source built with ``verbose``
LOGS: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _lib_path(name: str, defines: Tuple[str, ...] = ()) -> Path:
    """The library's path, named by a hash of its source, of the shared
    headers it may include and of its defines."""
    h = hashlib.sha256((_CSRC / f"{name}.cu").read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(defines).encode())
    return _BUILD / f"lib{name}_{h.hexdigest()[:12]}.so"


def build(names: Iterable[str] = SOURCES, verbose: bool = False,
          defines: Tuple[str, ...] = ()) -> float:
    """Compile the named sources that are not built yet, one nvcc each,
    all started together.  Returns the wall seconds spent.  ``verbose``
    adds ``-Xptxas -v`` and prints the compiler's report; ``defines``
    (``NAME=value``) are passed as ``-D``."""
    t0 = time.perf_counter()
    _BUILD.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        out = _lib_path(name, defines)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
               *(f"-D{d}" for d in defines),
               "-o", str(tmp), str(_CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        if verbose:
            LOGS[name] = log
            print(f"[nvcc {name}]\n{log}", flush=True)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


_PTXAS_FN = re.compile(r"Compiling entry function '(\S+)'")
_PTXAS_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")


def ptxas_usage(log: str) -> Dict[str, dict]:
    """Per kernel in an ``-Xptxas -v`` report (:data:`LOGS`): its
    registers, stack frame and spill bytes, keyed by the symbol."""
    usage = {}
    for block in re.split(r"(?=ptxas info\s*: Compiling entry function)", log):
        fn = _PTXAS_FN.search(block)
        frame, regs = _PTXAS_FRAME.search(block), _PTXAS_REGS.search(block)
        if fn and frame and regs:
            usage[fn.group(1)] = dict(
                registers=int(regs.group(1)), stack=int(frame.group(1)),
                spill_stores=int(frame.group(2)),
                spill_loads=int(frame.group(3)))
    return usage


def library(name: str, defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built with ``defines``),
    built on first use."""
    lib = _LIBS.get((name, defines))
    if lib is None:
        path = _lib_path(name, defines)
        if not path.exists():
            build([name], defines=defines)
        lib = ctypes.CDLL(str(path))
        _LIBS[(name, defines)] = lib
    return lib


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def check(rc: int, what: str) -> None:
    if rc == -1:
        raise ValueError(f"{what}: arguments the kernel does not take")
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")


def dtype_flag(t: torch.Tensor, what: str) -> int:
    """1 for bfloat16, 0 for float32; anything else raises."""
    if t.dtype == torch.bfloat16:
        return 1
    if t.dtype == torch.float32:
        return 0
    raise TypeError(f"{what}: dtype {t.dtype} (kernels take float32 or bfloat16)")
