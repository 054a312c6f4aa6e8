"""Device choice for the port's entry points, and device handles.

Every entry point takes ``device=`` and defaults to ``"cuda"``.  Without
a card it raises: the CPU is used only where the caller asks for it, as
the tests do.

A :class:`Device` handle is the port's counterpart of a JAX ``Device``:
the unit a fabric domain gives a party and a mesh lays out.  Handles
hash by identity, as JAX devices do, and each is backed by one torch
device.  :func:`local_devices` gives one handle a visible card, or, on
the CPU, :func:`set_cpu_device_count` virtual devices (the counterpart
of XLA's ``--xla_force_host_platform_device_count``, default 1);
:func:`virtual_devices` gives ``n`` distinct handles over one torch
device, the CPU or a card.
"""

from __future__ import annotations

import threading

import torch

from .errors import ConfigurationError

DEFAULT_DEVICE = "cuda"


class Device:
    """One device handle: ``id`` its index among its platform's handles,
    ``platform`` ``"cpu"`` or ``"gpu"``, ``torch_device`` the torch
    device behind it.  Equality and hashing are by identity: two handles
    over one torch device are two devices."""

    __slots__ = ("id", "platform", "torch_device")

    def __init__(self, id: int, torch_device):
        self.id = int(id)
        self.torch_device = canonical(torch_device)
        self.platform = "gpu" if self.torch_device.type == "cuda" else "cpu"

    def __repr__(self) -> str:
        return f"Device(id={self.id}, {self.torch_device})"


def canonical(device) -> torch.device:
    """``device`` as a torch device with its index: a bare ``"cuda"`` is
    the current card, so two spellings of one card compare equal."""
    if isinstance(device, Device):
        return device.torch_device
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


_lock = threading.Lock()
_cpu_count = 1
_cpu_devices: list = []
_card_handles: dict = {}


def set_cpu_device_count(n: int) -> None:
    """How many virtual CPU devices :func:`local_devices` gives (XLA's
    ``--xla_force_host_platform_device_count``).  Each handle is made
    once: the first ``n`` are the same objects at any count."""
    global _cpu_count
    if int(n) < 1:
        raise ValueError(f"a CPU device count must be >= 1, got {n}")
    with _lock:
        _cpu_count = int(n)


def cpu_device_count() -> int:
    return _cpu_count


def local_devices(device=DEFAULT_DEVICE) -> list:
    """The local device handles of ``device``'s platform: one a visible
    card for ``"cuda"``, the virtual CPU devices for ``"cpu"``."""
    dev = resolve(device)
    if dev.type == "cuda":
        return [_card_handle(i) for i in range(torch.cuda.device_count())]
    with _lock:
        while len(_cpu_devices) < _cpu_count:
            _cpu_devices.append(Device(len(_cpu_devices), "cpu"))
        return list(_cpu_devices[:_cpu_count])


def _card_handle(index: int) -> Device:
    with _lock:
        handle = _card_handles.get(index)
        if handle is None:
            handle = _card_handles[index] = Device(
                index, torch.device("cuda", index))
        return handle


def virtual_devices(device, n: int) -> list:
    """``n`` distinct handles over the one torch device ``device``: the
    parties of a fabric domain, or a mesh, on one CPU or one card."""
    dev = canonical(resolve(device))
    return [Device(i, dev) for i in range(int(n))]


def resolve(device=DEFAULT_DEVICE) -> torch.device:
    if isinstance(device, Device):
        return device.torch_device
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise ConfigurationError(
            "moose_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ConfigurationError(f"unsupported device {dev}")
    return dev
