"""Build the port's host-side C++ libraries (``tcp_transport.cpp``,
``textual_parser.cpp``) at first use with the system ``g++``.

Each library lands in ``moose_tpu_torch/native/build/`` under a name that
carries a digest of its source, so an edited source rebuilds and an
unchanged one loads at once.  Nothing builds at import.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import threading
from pathlib import Path

HERE = Path(__file__).resolve().parent
BUILD_DIR = HERE / "build"
GXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17", "-pthread"]

_lock = threading.Lock()


def build(source: str, stem: str, force: bool = False) -> Path:
    """The shared library of ``native/<source>``, compiled if missing.
    Raises ``RuntimeError`` with the compiler's output when ``g++``
    fails and ``OSError`` when there is none."""
    src = HERE / source
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(GXX_FLAGS).encode()
    ).hexdigest()[:16]
    target = BUILD_DIR / f"lib{stem}-{digest}.so"
    with _lock:
        if target.exists() and not force:
            return target
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = target.with_suffix(f".so.tmp{os.getpid()}")
        proc = subprocess.run(
            ["g++", *GXX_FLAGS, str(src), "-o", str(tmp)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {source}:\n{proc.stderr}")
        os.replace(tmp, target)
        return target
