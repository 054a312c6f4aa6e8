"""CUDA graphs over plan segments: the port's counterpart of ``jax.jit``.

The JAX package compiles a plan, or each of its segments, into one XLA
program (``moose_tpu/execution/interpreter.py``: ``jax.jit(plan.core)``,
``build_segmented_runner``).  The port captures the same walk once with
``torch.cuda.CUDAGraph`` and replays it: every kernel of the segment in
one launch from the host, with every parameter, pointer and host-side
decision baked at capture.  What that asks of the walk, and how this
module meets it:

- Inputs live at fixed addresses.  A plan's arguments are lifted on the
  host and copied into its static device buffers (:class:`StaticInputs`,
  ``copy_(..., non_blocking=True)`` from pinned host memory), and so is
  each evaluation's master key: K7 reads the key from that buffer
  (``ring_kernels.threefry_group``), so a replay draws fresh masks.  A
  lowered plan's PRF keys go the same way, all of an evaluation's in one
  ``(n_keys, 4)`` table (:func:`host_key_table`), each draw reading its
  key's row (``ring_kernels.threefry_seeded``).  A
  value that crosses into a segment from outside it is copied into the
  tensor the segment was captured with, unless it is that tensor (a
  segment reads an earlier segment's outputs in place).
- What can happen only once happens before capture: a warm-up run of
  the segment on the capture stream builds the kernels (``nvcc`` at
  first use), cuBLAS workspaces and caches.  A host constant the walk
  lifts (:func:`upload`) is made in the warm-up and kept by the segment;
  the capture gets the same device tensor back, since a capture cannot
  copy from pageable host memory.
- Host bookkeeping runs only at capture.  The launches the capturing
  thread counted (``ring_kernels.captured_launches``) are added to
  ``ring_kernels.LAUNCHES`` on each replay, and the draws it recorded
  (``drawledger.capturing``) are recorded again into the active draw
  ledgers, so both count what the card ran.  Both belong to the
  capturing thread: where several roles run in one process, another
  thread's launches and draws during a capture stay that thread's.
- A replay's outputs live in the plan's private memory pool and the next
  replay overwrites them: the plan holds its lock from binding the
  inputs until the outputs are copied out (``interpreter.Interpreter``).
- Captures run one at a time in the process (``torch.cuda.graph``'s own
  rule), under ``capture_error_mode="thread_local"``, so the threads of a
  server or a worker may run CUDA work beside one.  A failed capture
  raises :class:`GraphCaptureError`, naming the segment and the op being
  captured; nothing falls back to eager dispatch.

On the CPU there are no graphs: :func:`graphed` runs the segment
function itself, so the CPU runs a plan's segments uncaptured through the
same code.  On either device a segment runs as the plan's jitted form
(:func:`jitted`), where what only an eager walk may do is refused, as
under ``jax.jit``: the host-side ``aes-ctr`` PRF.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Callable, Optional

import numpy as np
import torch

# only one capture may be underway at a time in a process
_CAPTURE_LOCK = threading.Lock()
_local = threading.local()


class GraphCaptureError(RuntimeError):
    """A segment's capture or replay failed: the message names the
    segment and, for a capture, the op that was being captured.  The
    validated-jit ladder lets it through: a plan whose graph cannot run
    is a fault, not a divergence to demote."""


# -- tensor leaves of runtime values ----------------------------------------


def map_tensors(value, fn):
    """``value`` with each tensor leaf replaced by ``fn(leaf)``: through
    dicts, lists, tuples and the runtime's value dataclasses, in field
    order."""
    if isinstance(value, torch.Tensor):
        return fn(value)
    if isinstance(value, dict):
        return {k: map_tensors(v, fn) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(map_tensors(v, fn) for v in value)
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return dataclasses.replace(value, **{
            f.name: map_tensors(getattr(value, f.name), fn)
            for f in dataclasses.fields(value) if f.init
        })
    return value


def tensor_leaves(value) -> list:
    """The tensor leaves of ``value``, in :func:`map_tensors` order."""
    out: list = []

    def keep(t):
        out.append(t)
        return t

    map_tensors(value, keep)
    return out


# -- the jitted form ----------------------------------------------------------


def jitted() -> bool:
    """Whether this thread is running a segment as a plan's jitted form
    (captured, replayed, or its uncaptured stand-in on the CPU), where
    the JAX package would be tracing under ``jax.jit``."""
    return getattr(_local, "jitted", False)


@contextlib.contextmanager
def _jitted():
    prev = jitted()
    _local.jitted = True
    try:
        yield
    finally:
        _local.jitted = prev


# -- host constants ----------------------------------------------------------


def current_op(name: Optional[str] = None) -> Optional[str]:
    """The op this thread is running (set by the walk), or set it."""
    if name is not None:
        _local.op = name
    return getattr(_local, "op", None)


@contextlib.contextmanager
def _constants(memo: dict, capturing: bool):
    prev = getattr(_local, "memo", None), getattr(_local, "capturing", False)
    _local.memo, _local.capturing = memo, capturing
    try:
        yield
    finally:
        _local.memo, _local.capturing = prev


def upload(value, device, dtype=None) -> torch.Tensor:
    """``torch.as_tensor(value, dtype, device)`` for a host constant the
    walk lifts onto the device.  While a segment is warmed up on this
    thread the tensor is kept by the segment, keyed by its bytes, and
    its capture gets that tensor back instead of a copy from pageable
    host memory, which a capture cannot take."""
    memo = getattr(_local, "memo", None)
    device = torch.device(device)
    if memo is None or device.type != "cuda":
        return torch.as_tensor(value, dtype=dtype, device=device)
    # (np.ascontiguousarray would make a 0-d constant 1-d)
    arr = np.asarray(value, order="C")
    key = (str(device), str(arr.dtype), str(dtype), arr.shape,
           arr.tobytes())
    got = memo.get(key)
    if got is None:
        if getattr(_local, "capturing", False):
            raise GraphCaptureError(
                f"a host constant of shape {arr.shape} that the warm-up "
                "did not lift was met during capture"
            )
        got = memo[key] = torch.as_tensor(arr, dtype=dtype, device=device)
    return got


# -- static inputs -----------------------------------------------------------


class StaticInputs:
    """A plan's static input buffers on the card: each bound value's
    tensor leaves are copied from pinned host memory into device tensors
    that keep their addresses from one evaluation to the next (the
    capture bakes them).  Call under the plan's lock: the pinned staging
    of the previous evaluation is reused, once the copy out of it has
    run on the card."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._bufs: dict = {}

    def put(self, name, value):
        """``value`` (its leaves on the CPU) with its leaves in this
        name's static device buffers."""
        leaves = iter(range(10 ** 9))

        def stage(t):
            slot = (name, next(leaves))
            t = t.contiguous()
            pinned, dev, copied = self._bufs.get(slot, (None, None, None))
            if dev is None or dev.shape != t.shape or dev.dtype != t.dtype:
                pinned = torch.empty(t.shape, dtype=t.dtype).pin_memory()
                dev = torch.empty(t.shape, dtype=t.dtype,
                                  device=self.device)
                copied = torch.cuda.Event()
                self._bufs[slot] = (pinned, dev, copied)
            else:
                # the last copy out of this staging may still be queued
                # (nothing need have synchronized the host since)
                copied.synchronize()
            pinned.copy_(t)
            dev.copy_(pinned, non_blocking=True)
            copied.record()
            return dev

        return map_tensors(value, stage)


def host_words(words) -> torch.Tensor:
    """A master key's four u32 words as the int64 CPU tensor that
    :meth:`StaticInputs.put` copies onto the card."""
    return torch.tensor([int(w) & 0xFFFFFFFF for w in words],
                        dtype=torch.int64)


def host_key_table(keys) -> torch.Tensor:
    """A lowered plan's PRF keys, each four u32 words, as one
    ``(len(keys), 4)`` int64 CPU tensor: the table that
    :meth:`StaticInputs.put` copies onto the card in one copy."""
    return torch.tensor([[int(w) & 0xFFFFFFFF for w in words]
                         for words in keys],
                        dtype=torch.int64).reshape(len(keys), 4)


# -- captured segments -------------------------------------------------------


def replays() -> int:
    """Graphs this thread has replayed (``last_plan["cuda_graphs"]`` is
    the difference over one evaluation)."""
    return getattr(_local, "replays", 0)


class GraphPool:
    """The private memory pool of one plan, shared by its segments'
    graphs (they replay in capture order, under the plan's lock).
    Dropping the plan drops its graphs and frees the pool.

    With ``free_cache`` each capture is prepared as ``torch.cuda.graph``
    prepares it: the device synchronized and the caching allocator's
    unused blocks returned, so a large plan finds room for its pool.  A
    worker's role plan captures hundreds of small segments while other
    roles run; it frees the cache once, when it is built, and captures
    without either."""

    def __init__(self, device, free_cache: bool = True):
        self.device = torch.device(device)
        self.handle = torch.cuda.graph_pool_handle()
        # one capture stream for the pool's graphs, so that a capture can
        # reuse the blocks an earlier one freed
        self.stream = torch.cuda.Stream(self.device)
        self.free_cache = free_cache
        if not free_cache:
            torch.cuda.empty_cache()


@contextlib.contextmanager
def _capturing(graph, pool: GraphPool):
    """Capture into ``graph`` on ``pool``'s stream, this thread's work
    only (other threads may run CUDA work meanwhile)."""
    if pool.free_cache:
        with torch.cuda.graph(graph, pool=pool.handle, stream=pool.stream,
                              capture_error_mode="thread_local"):
            yield
        return
    with torch.cuda.stream(pool.stream):
        graph.capture_begin(pool=pool.handle,
                            capture_error_mode="thread_local")
        try:
            yield
        finally:
            graph.capture_end()


class Graphed:
    """One segment function ``fn(*args) -> result`` captured as a CUDA
    graph at its first call and replayed at every later one; ``args`` and
    the result are runtime values (pytrees of tensors)."""

    def __init__(self, fn: Callable, name: str, pool: GraphPool):
        self.fn = fn
        self.name = name
        self.pool = pool
        self._graph = None
        self._static_in: list = []
        self._static_out: Any = None
        self._constants: dict = {}
        self._launches: dict = {}
        self._draws: list = []

    @property
    def captured(self) -> bool:
        return self._graph is not None

    def __call__(self, *args):
        with _jitted():
            if self._graph is None:
                self._capture(args)
            else:
                self._bind(args)
            try:
                self._replay()
            except Exception as e:
                raise GraphCaptureError(
                    f"replaying {self.name} failed: {e}") from e
        return self._static_out

    def _bind(self, args) -> None:
        leaves = tensor_leaves(args)
        if len(leaves) != len(self._static_in):
            raise GraphCaptureError(
                f"{self.name}: replayed with {len(leaves)} input tensors, "
                f"captured with {len(self._static_in)}"
            )
        for got, static in zip(leaves, self._static_in):
            if got.data_ptr() == static.data_ptr() and \
                    got.shape == static.shape and \
                    got.stride() == static.stride():
                continue
            if got.shape != static.shape or got.dtype != static.dtype:
                raise GraphCaptureError(
                    f"{self.name}: an input of {tuple(got.shape)} "
                    f"{got.dtype} where the capture had "
                    f"{tuple(static.shape)} {static.dtype}"
                )
            static.copy_(got)

    def _replay(self) -> None:
        from ..native import ring_kernels as rk
        from . import drawledger

        self._graph.replay()
        _local.replays = replays() + 1
        for counter, n in self._launches.items():
            rk.count_launch(counter, n)
        for event in self._draws:
            drawledger.record(event)

    def _capture(self, args) -> None:
        from ..native import ring_kernels as rk
        from . import drawledger

        device = self.pool.device
        with _CAPTURE_LOCK:
            side = self.pool.stream
            side.wait_stream(torch.cuda.current_stream(device))
            # the warm-up: builds, workspaces and the host constants the
            # capture will read, on the capture stream; its draws are not
            # the evaluation's (a ledger of this thread's, discarded)
            with torch.cuda.stream(side), drawledger.capturing(), \
                    _constants(self._constants, False):
                self.fn(*args)
            torch.cuda.current_stream(device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            # the capture launches nothing: what this thread's capture
            # counted and drew comes back on each replay, and what other
            # threads launch and draw meanwhile stays theirs
            try:
                with rk.captured_launches() as launches, \
                        drawledger.capturing() as ledger, \
                        _constants(self._constants, True), \
                        _capturing(graph, self.pool):
                    out = self.fn(*args)
            except Exception as e:
                cause = e.__context__
                raise GraphCaptureError(
                    f"capturing {self.name} failed at op "
                    f"{current_op()!r}: {e}"
                    + (f" (after: {cause})" if cause is not None else "")
                ) from e
        self._graph = graph
        self._launches = dict(launches)
        self._draws = list(ledger.events)
        self._static_in = tensor_leaves(args)
        self._static_out = out


def graphed(fn: Callable, name: str, pool: Optional[GraphPool]):
    """``fn`` captured as a :class:`Graphed` segment on the card (``pool``
    given), or ``fn`` itself run as the jitted form on the CPU (``pool``
    None): the plan's segments then run uncaptured."""
    if pool is not None:
        return Graphed(fn, name, pool)

    def run(*args):
        with _jitted():
            return fn(*args)

    return run
