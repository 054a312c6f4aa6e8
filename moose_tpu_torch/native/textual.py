"""ctypes loader of the C++ parallel textual parser
(``textual_parser.cpp``, the port's copy of the reference's): built with
``g++`` at first use into ``native/build/`` (:mod:`.host_build`); returns
the per-line record list decoded from msgpack."""

from __future__ import annotations

import ctypes
import threading

from . import host_build

_lock = threading.Lock()
_lib = None
_build_failed = False


def load():
    """The loaded library, or None when the toolchain is unavailable
    (callers fall back to the Python parser)."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        try:
            lib = ctypes.CDLL(str(host_build.build("textual_parser.cpp",
                                                   "moose_textual")))
        except (RuntimeError, OSError):
            _build_failed = True
            return None
        lib.mt_parse_textual.restype = ctypes.POINTER(ctypes.c_char)
        lib.mt_parse_textual.argtypes = [
            ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.mt_parse_free.argtypes = [ctypes.POINTER(ctypes.c_char)]
        _lib = lib
        return lib


def parse_lines(text: str, threads: int = 0):
    """Parse the textual format into per-line records (see
    textual_parser.cpp for the record schema); None if unavailable."""
    import msgpack

    lib = load()
    if lib is None:
        return None
    raw = text.encode()
    out_len = ctypes.c_uint64()
    buf = lib.mt_parse_textual(raw, len(raw), threads,
                               ctypes.byref(out_len))
    if not buf:
        return None
    try:
        data = ctypes.string_at(buf, out_len.value)
    finally:
        lib.mt_parse_free(buf)
    return msgpack.unpackb(data, raw=False, strict_map_key=False)
