"""Build the CUDA kernels of ``moose_tpu_torch/csrc`` at first use.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for Hopper (``sm_90a``)
into its own shared library with a plain C interface, loaded with
``ctypes``.  Libraries land in ``moose_tpu_torch/native/build/`` under a
name that carries a digest of the source and flags, so an edited source
rebuilds and an unchanged one loads at once.  ``build_all`` starts one
``nvcc`` per source together.

Nothing here runs at import: the CPU tests import every module, and a
build needs ``nvcc`` and a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
KERNELS = (
    "dot_cross_terms", "trunc_combine", "cross_terms_mul", "ring_mul",
    "bits_adder", "horner", "threefry",
)
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

# C entry point and argument types of each kernel's library, and of a
# second entry point a library carries (LIBRARY_OF names its library)
SIGNATURES = {
    "dot_cross_terms": (
        "moose_dot_cross_terms",
        [ctypes.c_void_p] * 12
        + [ctypes.c_longlong] * 2
        + [ctypes.c_int] * 6
        + [ctypes.c_void_p],
    ),
    "trunc_combine": (
        "moose_trunc_pairs",
        [ctypes.POINTER(ctypes.c_void_p)] * 2
        + [ctypes.c_longlong, ctypes.c_int]
        + [ctypes.POINTER(ctypes.c_longlong)] * 2
        + [ctypes.POINTER(ctypes.c_void_p)] * 2
        + [ctypes.c_void_p] * 2
        + [ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    ),
    "cross_terms_mul": (
        "moose_cross_terms_mul",
        [ctypes.c_void_p] * 10
        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p],
    ),
    "cross_terms_reshare": (
        "moose_cross_terms_reshare",
        [ctypes.c_void_p] * 8
        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
        + [ctypes.POINTER(ctypes.c_longlong)] * 3
        + [ctypes.c_longlong] * 2 + [ctypes.c_void_p],
    ),
    "ring_mul": (
        "moose_ring_mul",
        [ctypes.c_void_p] * 6
        + [ctypes.c_longlong] + [ctypes.c_int] * 3
        + [ctypes.POINTER(ctypes.c_longlong)] * 2 + [ctypes.c_void_p],
    ),
    "bits_adder": (
        "moose_bits_adder",
        [ctypes.c_void_p] * 5
        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    ),
    "horner": (
        "moose_horner",
        [ctypes.c_void_p] * 2 + [ctypes.c_longlong]
        + [ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_int]
        + [ctypes.POINTER(ctypes.c_longlong)] * 3
        + [ctypes.c_void_p] * 4
        + [ctypes.POINTER(ctypes.c_uint64)] * 2
        + [ctypes.c_int, ctypes.c_int, ctypes.c_longlong]
        + [ctypes.c_int] * 2 + [ctypes.c_void_p],
    ),
    "threefry": (
        "moose_threefry_group",
        [ctypes.POINTER(ctypes.c_uint), ctypes.c_void_p, ctypes.c_uint,
         ctypes.c_ulonglong]
        + [ctypes.c_int] * 2
        + [ctypes.POINTER(ctypes.c_longlong),
           ctypes.POINTER(ctypes.c_ulonglong),
           ctypes.POINTER(ctypes.c_int),
           ctypes.POINTER(ctypes.c_ulonglong),
           ctypes.POINTER(ctypes.c_uint), ctypes.c_void_p],
    ),
}

LIBRARY_OF = {"cross_terms_reshare": "cross_terms_mul"}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
# ptxas resource lines (registers, shared memory, spills) of each build
BUILD_LOGS: Dict[str, str] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of moose_tpu_torch build with the "
        "CUDA toolkit (set CUDA_HOME or put nvcc on PATH)"
    )


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes()
        + b"".join((CSRC / h).read_bytes() for h in sorted(
            p.name for p in CSRC.glob("*.cuh")))
        + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str) -> Optional[subprocess.Popen]:
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )


def _finish(name: str, proc: Optional[subprocess.Popen]) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    BUILD_LOGS[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{log}")
    out = _target(name)
    os.replace(out.with_suffix(f".{os.getpid()}.tmp"), out)


def build_all(names: Sequence[str] = KERNELS) -> float:
    """Compile every named kernel, one ``nvcc`` each, all started
    together; returns the seconds it took."""
    t0 = time.perf_counter()
    with _LOCK:
        procs = {}
        try:
            for name in names:
                procs[name] = _start(name)
            for name, proc in procs.items():
                _finish(name, proc)
        finally:
            # a failed build leaves no compiler running behind it
            for proc in procs.values():
                if proc is not None and proc.poll() is None:
                    proc.kill()
                    proc.wait()
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed, with
    its entry points' argument types bound."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_target(name)))
            for entry, of in [(name, name)] + list(LIBRARY_OF.items()):
                if of != name:
                    continue
                symbol, argtypes = SIGNATURES[entry]
                fn = getattr(lib, symbol)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIBS[name] = lib
    return lib
