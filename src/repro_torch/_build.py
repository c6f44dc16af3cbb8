"""Build the CUDA sources in ``csrc/`` with nvcc and bind them with ctypes.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C
interface, compiled for Hopper::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/repro_torch/<name>-<digest>.so <name>.cu

at first use, all sources at once (one nvcc process each, started
together).  The file name carries a digest of the sources and flags, so
an edited source is rebuilt and a stale library is never loaded.  Every C
entry point takes ``void*`` device pointers and the CUDA stream and
returns a CUDA error code (``cudaGetLastError()`` after a launch);
:func:`call` raises on a non-zero code.

Launch counters live here: each wrapper adds one to :data:`LAUNCHES`
under its kernel's name where it launches the kernel, and the plain
engine and the LM and triad kernels' wrappers on CPU tensors add one to
:data:`PLAIN_CALLS` per call, so a run can show which path it took.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: bytes of shared memory one block may use on sm_90 (227 KB, after
#: cudaFuncSetAttribute above 48 KB)
SMEM_PER_BLOCK = 232448

_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
_L, _F = ctypes.c_int64, ctypes.c_float
#: source name -> {C function: argument types}; every function returns int.
SIGNATURES: Dict[str, Dict[str, tuple]] = {
    "cachesim_engine": {
        "cachesim_engine_launch": (_P,) * 17 + (_I,) * 11 + (_U,) + (_I,) * 8
                                  + (_P,),
    },
    "cachesim_step": {
        "lru_sets_launch": (_P,) * 6 + (_I,) * 4 + (_P,),
    },
    "cache_probe": {
        "prime_probe_launch": (_P,) * 5 + (_I,) * 4 + (_P,),
    },
    "flash_attention": {
        "flash_attention_launch": (_P,) * 4 + (_I,) * 6 + (_L,) * 12
                                  + (_I, _I, _F, _P),
    },
    "ssd_scan": {
        "ssd_scan_launch": (_P,) * 10 + (_I,) * 6 + (_P,),
    },
    "triad": {
        "triad_launch": (_P,) * 4 + (_L,) + (_P,),
        "triad_timed_launch": (_P,) * 4 + (_L, _I, _F) + (_P,) * 3,
    },
}
SOURCES = tuple(SIGNATURES)

#: kernel name -> launches since the last reset
LAUNCHES: collections.Counter = collections.Counter()
#: plain-version name -> calls since the last reset
PLAIN_CALLS: collections.Counter = collections.Counter()
#: kernel name -> launches of a timed reading that was taken again since
#: the last reset (`kernel.triad_device_seconds`); each is in LAUNCHES too
REPEATED_LAUNCHES: collections.Counter = collections.Counter()
#: source name -> nvcc's output of its last build (ptxas register report)
BUILD_LOG: Dict[str, str] = {}

_LIBS: Dict[str, ctypes.CDLL] = {}


def reset_counters() -> None:
    LAUNCHES.clear()
    PLAIN_CALLS.clear()
    REPEATED_LAUNCHES.clear()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("repro_torch: nvcc not found (CUDA toolkit needed "
                       "to build the kernels in csrc/)")


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> float:
    """Compile every named source whose library is missing (default: all),
    one nvcc process per source, in parallel.  Returns the seconds spent."""
    t0 = time.perf_counter()
    todo = [n for n in (names or SOURCES) if not _target(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        out = _target(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("repro_torch: kernel build failed\n"
                           + "\n".join(failed))
    return time.perf_counter() - t0


def lib(name: str) -> ctypes.CDLL:
    """The bound library of ``csrc/<name>.cu`` (builds all sources that
    are missing on first use)."""
    if name not in _LIBS:
        if not _target(name).exists():
            build()
        so = ctypes.CDLL(str(_target(name)))
        for fn, argtypes in SIGNATURES[name].items():
            f = getattr(so, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
            err = getattr(so, _error_fn(fn))
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
        _LIBS[name] = so
    return _LIBS[name]


def _error_fn(fn: str) -> str:
    """``<kernel>[_timed]_launch`` comes with ``<kernel>_error(code)``,
    which returns ``cudaGetErrorString(code)`` from the library's own
    runtime."""
    return fn.replace("_timed_launch", "_launch").replace("_launch",
                                                          "_error")


def call(name: str, fn: str, *args) -> None:
    """Call C entry point ``fn`` of source ``name``; raise on a CUDA error."""
    so = lib(name)
    code = getattr(so, fn)(*args)
    if code != 0:
        msg = getattr(so, _error_fn(fn))(code)
        raise RuntimeError(f"repro_torch: {fn} failed with CUDA error "
                           f"{code}: {msg.decode() if msg else '?'}")


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    """Device pointer of ``t`` for a ``c_void_p`` argument."""
    return None if t is None else t.data_ptr()


def stream(device: torch.device) -> int:
    """The raw handle of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise if autograd would need a gradient through a kernel: the kernels
    have no backward (the JAX package defines none for its Pallas kernels
    either), and a ctypes launch returns a tensor cut from the graph, so
    its gradient would be silently wrong.  Train with ``impl="ref"``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the kernel has no backward, and an input requires "
            f"grad; train with impl='ref' (or call it under torch.no_grad())")


def check_cuda(name: str, *tensors: torch.Tensor, dtypes=None) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on one device
    (and of the matching dtype in ``dtypes``, where given)."""
    dev = tensors[0].device
    for i, t in enumerate(tensors):
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: argument {i} is on {t.device}, "
                             f"expected one CUDA device ({dev})")
        if not t.is_contiguous():
            raise ValueError(f"{name}: argument {i} is not contiguous")
        if dtypes is not None and t.dtype != dtypes[i]:
            raise TypeError(f"{name}: argument {i} has dtype {t.dtype}, "
                            f"expected {dtypes[i]}")
