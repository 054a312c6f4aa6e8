"""ctypes loader and wrapper of the C++ TCP transport
(``tcp_transport.cpp``, the port's copy of the reference's): built with
``g++`` at first use into ``native/build/`` (:mod:`.host_build`)."""

from __future__ import annotations

import ctypes
import threading

from ..errors import NetworkingError, ReceiveTimeoutError
from . import host_build

_lock = threading.Lock()
_lib = None


def build(force: bool = False):
    try:
        return host_build.build("tcp_transport.cpp", "moose_tcp", force)
    except (RuntimeError, OSError) as e:
        raise NetworkingError(
            f"failed to build native TCP transport:\n{e}") from e


def load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        lib.mt_server_new.restype = ctypes.c_void_p
        lib.mt_server_new.argtypes = [ctypes.c_int]
        lib.mt_server_free.argtypes = [ctypes.c_void_p]
        lib.mt_send.restype = ctypes.c_int
        lib.mt_send.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint64,
        ]
        lib.mt_receive.restype = ctypes.c_int
        lib.mt_receive.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int,
        ]
        lib.mt_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
        _lib = lib
        return lib


class ServerHandle:
    def __init__(self, lib, port: int):
        self._lib = lib
        self._handle = lib.mt_server_new(port)
        if not self._handle:
            raise NetworkingError(f"cannot bind TCP server on port {port}")

    def receive(self, key: str, timeout_ms: int) -> bytes:
        out = ctypes.POINTER(ctypes.c_uint8)()
        out_len = ctypes.c_uint64()
        rc = self._lib.mt_receive(
            self._handle, key.encode(), ctypes.byref(out),
            ctypes.byref(out_len), timeout_ms,
        )
        if rc != 0:
            raise ReceiveTimeoutError(
                f"TCP receive timed out ({timeout_ms} ms) for {key!r}"
            )
        try:
            return ctypes.string_at(out, out_len.value)
        finally:
            self._lib.mt_free(out)

    def close(self):
        if self._handle:
            self._lib.mt_server_free(self._handle)
            self._handle = None


def send(lib, host: str, port: int, key: str, payload: bytes):
    buf = (ctypes.c_uint8 * len(payload)).from_buffer_copy(payload)
    rc = lib.mt_send(host.encode(), port, key.encode(), buf, len(payload))
    if rc != 0:
        raise NetworkingError(
            f"TCP send to {host}:{port} failed (rc={rc})"
        )
