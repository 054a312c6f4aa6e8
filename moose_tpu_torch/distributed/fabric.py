"""Fabric transport: parties as device slices, a rendezvous as a device
copy.

The port's own copy of ``moose_tpu/distributed/fabric.py``.  When
parties opt into a shared device fabric, an inter-party Send/Receive
moves the value's tensors device to device into the receiver's own
buffers (no host round trip, no serde), and party pairs that cross a
trust boundary keep the wire.

Two pieces:

- :class:`FabricDomain`: the deployment's declaration ``party -> slice
  of device handles`` (:mod:`..devices`), disjoint across parties, and
  an explicit ``trust_model`` attestation.  Parties outside the domain
  keep the wire, so mixed sessions are first-class.
- :class:`FabricNetworking`: the networking trait over a wire transport
  (gRPC or a serializing ``LocalNetworking``).  An intra-domain send is
  one :meth:`FabricDomain.permute`, a copy of every tensor leaf onto the
  torch device behind the receiver's lead handle (``send_many``: one
  permute for the whole envelope); the moved value lands in the
  receiver's rendezvous cell store as a raw value.  Trust-boundary edges
  go to the wire transport unchanged.

The JAX package's permute is a ``lax.ppermute`` program over the
domain's party mesh; here it is a copy (``tensor.to(device,
copy=True)``, never a view): device to device on one card, a peer copy
across cards.  Seed and key words live on the host in the port, as in
its serde, and are copied there.

Delivery discipline: fabric payloads land in the same per-party cell
store the wire uses, as raw runtime values (the wire posts ``bytes``).
The payload type is the transport marker, so receives, duplicate drops,
abort collection, activity wakeups and the chaos layer's drop ->
forced-wire replay compose over one store.

Safety gates: the MSA505 rule (``compilation/analysis/schedule.py``)
re-runs the deadlock fixed point over the fabric-lowered schedule at
plan-build time, and :meth:`FabricNetworking.prepare_fabric` sends every
edge of a rejected computation over the wire (flight event
``fabric_rejected``); the cost model (``analysis/cost.py``,
``transport="fabric"``) prices each permute before anything runs, and
the worker's cost-drift watchdog holds the ``moose_tpu_fabric_*``
counters to it.

Env knobs: ``MOOSE_TPU_FABRIC=0`` disables fabric lowering (a declared
domain falls back to the wire); ``MOOSE_TPU_FABRIC_TRUST`` names the
default trust model of :meth:`FabricDomain.default`.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import threading
import weakref
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..errors import ConfigurationError
from .networking import DEFAULT_TIMEOUT_S, _net_metrics, transfer_key

# trust models a domain may attest to: an explicit, auditable deployment
# statement, never something the runtime infers
TRUST_MODELS = (
    # one controller process drives every party's devices (in-process
    # clusters, one host with several cards, TEE-backed single tenants)
    "single_controller",
    # distinct parties whose accelerators share an interconnect inside
    # one attested enclave boundary
    "colocated_tee",
    # test/bench simulation: explicitly NOT a privacy claim
    "simulation",
)

_FABRIC_METRICS = None
_metrics_lock = threading.Lock()


def _fabric_metrics():
    """Fabric counter families on the global registry (the wire families
    of ``networking._net_metrics`` are shared too, under
    ``transport="fabric"``)."""
    global _FABRIC_METRICS
    with _metrics_lock:
        if _FABRIC_METRICS is None:
            from .. import metrics

            _FABRIC_METRICS = {
                "permutes": metrics.counter(
                    "moose_tpu_fabric_permutes_total",
                    "collective-permute program launches",
                    (),
                ),
                "batched": metrics.counter(
                    "moose_tpu_fabric_batched_permutes_total",
                    "permute launches that coalesced >1 rendezvous "
                    "payloads (send_many lowering)",
                    (),
                ),
                "payloads": metrics.counter(
                    "moose_tpu_fabric_permute_payloads_total",
                    "rendezvous payloads moved by collective permutes",
                    (),
                ),
                "tx_bytes": metrics.counter(
                    "moose_tpu_fabric_tx_bytes_total",
                    "device bytes moved by collective permutes "
                    "(array leaf bytes, no serde framing)",
                    (),
                ),
                "fallbacks": metrics.counter(
                    "moose_tpu_fabric_fallbacks_total",
                    "sends that fell back to the wire transport, by "
                    "reason",
                    ("reason",),
                ),
            }
        return _FABRIC_METRICS


# array fields of each value class, in the JAX package's pytree order
# (``moose_tpu/values.py``'s registrations); a class absent here has none
_ARRAY_FIELDS = {
    "HostTensor": ("value",),
    "HostBitTensor": ("value",),
    "HostRingTensor": ("lo", "hi"),
    "HostFixedTensor": ("tensor",),
    "RepTensor": ("shares",),
    "RepFixedTensor": ("tensor",),
    "RepSetup": ("keys",),
    "RepBitArray": ("tensor",),
    "AdtTensor": ("shares",),
    "Mir3Tensor": ("values",),
    "Mir3FixedTensor": ("tensor",),
    "HostAesKey": ("bits",),
    "RepAesKey": ("bits",),
    "AesTensor": ("nonce_bits", "cipher_bits"),
}
_WORD_CLASSES = ("HostSeed", "HostPrfKey")


def _map_leaves(value, fn):
    """``value`` with each array leaf replaced by ``fn(leaf)``, in the
    JAX package's ``jax.tree_util`` leaf order: each value class's array
    fields in declaration order, None skipped, a seed's or key's four
    words one uint32 leaf (rebuilt as the wire's codec rebuilds them)."""

    def walk(v):
        if v is None:
            return None
        name = type(v).__name__
        if name in _WORD_CLASSES:
            words = fn(np.asarray(v.value, dtype=np.uint32))
            return type(v)(tuple(int(w) for w in np.asarray(words)
                                 .reshape(-1)), v.plc)
        if name in _ARRAY_FIELDS:
            return dataclasses.replace(v, **{
                field: walk(getattr(v, field))
                for field in _ARRAY_FIELDS[name]})
        if isinstance(v, tuple):
            return tuple(walk(item) for item in v)
        if isinstance(v, list):
            return [walk(item) for item in v]
        if hasattr(v, "plc") or isinstance(v, (str, bytes)):
            return v
        return fn(v)

    return walk(value)


def value_leaves(value) -> list:
    """The array leaves a fabric transfer moves, in the JAX package's
    ``jax.tree_util.tree_leaves`` order; the one source of truth shared
    with the cost model (``analysis/cost.py`` applies it to a spec
    placeholder, which makes predicted fabric bytes equal measured bytes
    exactly).  Values with no array leaves (HostUnit, HostShape,
    HostString) have none: nothing for a permute to move."""
    out: list = []

    def keep(leaf):
        out.append(leaf)
        return leaf

    _map_leaves(value, keep)
    return out


def _rebuild(value, moved_leaves):
    """``value`` with its leaves, in :func:`value_leaves` order, replaced
    by ``moved_leaves``."""
    it = iter(moved_leaves)
    return _map_leaves(value, lambda _: next(it))


def leaf_bytes(leaves: Sequence[Any]) -> int:
    """Device bytes of ``leaves``: a tensor's elements times their size,
    an array's ``nbytes``."""
    total = 0
    for leaf in leaves:
        if hasattr(leaf, "element_size"):
            total += int(leaf.numel()) * int(leaf.element_size())
        else:
            total += int(np.asarray(leaf).nbytes)
    return total


def _restamp_plc(value, plc: str):
    """Re-place a received value: the wire's codec stamps ``plc`` while
    it decodes; fabric delivery skips the codec, so the receiver rewrites
    the placement fields of the (host-level) value tree."""
    if not plc or not dataclasses.is_dataclass(value):
        return value
    changes = {}
    for field in dataclasses.fields(value):
        v = getattr(value, field.name)
        if field.name == "plc" and isinstance(v, str):
            changes[field.name] = plc
        elif dataclasses.is_dataclass(v) and not isinstance(v, type):
            changes[field.name] = _restamp_plc(v, plc)
        elif isinstance(v, tuple) and any(
            dataclasses.is_dataclass(e) and not isinstance(e, type)
            for e in v
        ):
            changes[field.name] = tuple(
                _restamp_plc(e, plc) if dataclasses.is_dataclass(e)
                else e
                for e in v
            )
    return dataclasses.replace(value, **changes) if changes else value


def fabric_enabled() -> bool:
    """Global kill switch: ``MOOSE_TPU_FABRIC=0`` forces every declared
    domain back onto the wire (bit-identical by construction: the fabric
    moves the same tensors the wire would)."""
    return os.environ.get("MOOSE_TPU_FABRIC", "1") not in ("0", "off")


class FabricDomain:
    """One shared-fabric trust domain: ``slices`` maps each member party
    to its slice of device handles (disjoint across parties), and
    ``trust_model`` is the attestation under which the members accept
    shared-device residency.

    The domain owns the party order (party index = ring position, so the
    cost model's hop count is the ring distance), the per-party
    rendezvous cell registry the permutes deliver into, and the
    ``force_wire`` latches (stable rendezvous keys whose transfers must
    ride the wire: the chaos layer's drop -> forced-wire replay, and the
    MSA505 rejection path)."""

    # bound mirrors the cell store's session bookkeeping
    _MAX_REJECTED_SESSIONS = 4096

    def __init__(self, slices: Dict[str, Sequence[Any]],
                 trust_model: str):
        if trust_model not in TRUST_MODELS:
            raise ConfigurationError(
                f"unknown fabric trust_model {trust_model!r}; a domain "
                f"must attest one of {TRUST_MODELS} — the fabric never "
                "infers trust"
            )
        if len(slices) < 2:
            raise ConfigurationError(
                "a FabricDomain needs >= 2 parties (one party has no "
                "inter-party edges to lower)"
            )
        seen: dict = {}
        for party, devs in slices.items():
            if not devs:
                raise ConfigurationError(
                    f"fabric party {party!r} declared an empty device "
                    "slice"
                )
            for d in devs:
                if id(d) in seen:
                    raise ConfigurationError(
                        f"device {d} is claimed by both "
                        f"{seen[id(d)]!r} and {party!r}: fabric slices "
                        "must be disjoint (shared devices would leak "
                        "one party's residency into another's)"
                    )
                seen[id(d)] = party
        self.trust_model = trust_model
        self.slices = {p: tuple(devs) for p, devs in slices.items()}
        self.parties = tuple(self.slices)
        self._index = {p: i for i, p in enumerate(self.parties)}
        self._lock = threading.Lock()
        self._mesh = None  # built at first use
        self._cells: dict = {}  # party -> its rendezvous _CellStore
        self._force_wire: set = set()  # stable rendezvous keys
        # computations whose fabric schedule MSA505 rejected (weak-keyed
        # like the plan cache) and the sessions running them: every edge
        # of a rejected session rides the wire
        self._rejected: "weakref.WeakSet" = weakref.WeakSet()
        self._prepared: "weakref.WeakKeyDictionary" = (
            weakref.WeakKeyDictionary()
        )
        self._rejected_sessions: "collections.OrderedDict[str, None]" = (
            collections.OrderedDict()
        )

    @classmethod
    def default(cls, parties: Sequence[str],
                trust_model: Optional[str] = None,
                device="cuda") -> "FabricDomain":
        """One-device-per-party domain over the first ``len(parties)``
        local device handles of ``device``'s platform
        (``devices.local_devices``: the cards, or the CPU's virtual
        devices)."""
        from .. import devices as devices_mod

        if trust_model is None:
            trust_model = os.environ.get(
                "MOOSE_TPU_FABRIC_TRUST", "single_controller"
            )
        devices = devices_mod.local_devices(device)
        if len(devices) < len(parties):
            raise ConfigurationError(
                f"fabric needs one device per party: {len(parties)} "
                f"parties, {len(devices)} devices visible"
            )
        return cls(
            {p: (devices[i],) for i, p in enumerate(parties)},
            trust_model=trust_model,
        )

    # -- membership / routing ------------------------------------------

    def party_index(self, party: str) -> int:
        return self._index[party]

    def is_member(self, party: str) -> bool:
        return party in self._index

    def hops(self, sender: str, receiver: str) -> int:
        """Cost-model distance: ring hops between the parties' positions
        (on 3 parties every edge is one hop)."""
        n = len(self.parties)
        d = (self._index[receiver] - self._index[sender]) % n
        return min(d, n - d) or n  # self-edges never happen; keep >= 1

    def cost_context(self) -> Tuple[Tuple[str, ...], str]:
        """Hashable descriptor the cost model keys its fabric predictions
        on."""
        return (self.parties, self.trust_model)

    def device_of(self, party: str):
        """The torch device behind ``party``'s lead handle: where the
        values it receives land."""
        from .. import devices

        return devices.canonical(self.slices[party][0])

    @property
    def mesh(self):
        """The domain's 1-D ``("parties",)`` mesh of lead handles."""
        with self._lock:
            if self._mesh is None:
                from ..parallel.spmd import fabric_party_mesh

                self._mesh = fabric_party_mesh(
                    [devs[0] for devs in self.slices.values()]
                )
            return self._mesh

    # -- force-wire latches --------------------------------------------

    def force_wire(self, stable_key: str) -> None:
        """Latch one logical rendezvous key onto the wire.  The chaos
        layer calls this when it drops a fabric send: the replay of that
        key (same stable key, next attempt) must not re-enter a permute
        whose payload was already lost; it rides the wire instead,
        bit-identically.  Keys carry no session prefix, so the latch
        survives the supervisor's fresh session id."""
        with self._lock:
            self._force_wire.add(stable_key)

    def is_forced_wire(self, stable_key: str) -> bool:
        with self._lock:
            return stable_key in self._force_wire

    def reject_computation(self, comp) -> None:
        self._rejected.add(comp)

    def is_rejected(self, comp) -> bool:
        return comp in self._rejected

    def reject_session(self, session_id: str) -> None:
        with self._lock:
            self._rejected_sessions[session_id] = None
            while len(self._rejected_sessions) > \
                    self._MAX_REJECTED_SESSIONS:
                self._rejected_sessions.popitem(last=False)

    def is_rejected_session(self, session_id: str) -> bool:
        with self._lock:
            return session_id in self._rejected_sessions

    # -- cell registry --------------------------------------------------

    def register_cells(self, party: str, cells) -> None:
        with self._lock:
            self._cells[party] = cells

    def cells_of(self, party: str):
        with self._lock:
            return self._cells.get(party)

    # -- the permute ----------------------------------------------------

    def permute(self, sender: str, receiver: str,
                leaves: Sequence[Any]) -> Tuple[list, int]:
        """Move ``leaves`` from ``sender``'s slice to ``receiver``'s:
        each tensor copied into a fresh buffer on the torch device behind
        the receiver's lead handle, host words copied on the host.
        Returns (moved leaves, bytes moved).  One call is one fenced
        copy group and one tick of ``moose_tpu_fabric_permutes_total``."""
        import torch

        from .. import profiling

        dst = self.device_of(receiver)
        bytes_moved = leaf_bytes(leaves)
        fm = _fabric_metrics()
        with profiling.phase(
            "fabric_permute", src=sender, dst=receiver,
            payload_leaves=len(leaves), bytes=bytes_moved,
        ):
            moved = [
                leaf.to(dst, copy=True) if isinstance(leaf, torch.Tensor)
                else np.array(leaf, copy=True)
                for leaf in leaves
            ]
            profiling.fence(moved)
        fm["permutes"].inc()
        fm["tx_bytes"].inc(bytes_moved)
        return moved, bytes_moved


class FabricNetworking:
    """Networking trait that lowers intra-fabric edges to permutes, with
    wire fallback on every edge that crosses the trust boundary
    (receiver outside ``domain``), every force-wired key, every
    MSA505-rejected computation, and ``MOOSE_TPU_FABRIC=0``.

    ``inner`` is the wire transport (GrpcNetworking or a serializing
    LocalNetworking); everything not intercepted (ping, abort fanout,
    server plumbing) goes to it unchanged, so the fabric composes under
    the chaos proxy like the plain transports."""

    def __init__(self, domain: FabricDomain, identity: str, inner):
        if not domain.is_member(identity):
            raise ConfigurationError(
                f"{identity!r} is not a member of the fabric domain "
                f"{domain.parties}"
            )
        cells = getattr(inner, "cells", None)
        if cells is None:
            cells = getattr(inner, "_store", None)
        if cells is None or not getattr(inner, "_serialize", True):
            raise ConfigurationError(
                "FabricNetworking needs a wire transport with a "
                "rendezvous cell store and a serializing wire path "
                "(GrpcNetworking or LocalNetworking(serialize=True)): "
                "fabric payloads are raw values, wire payloads are "
                "bytes, and the payload type is the transport marker"
            )
        from .. import devices

        wire_device = getattr(inner, "device", None)
        if wire_device is not None and devices.canonical(wire_device) != \
                domain.device_of(identity):
            raise ConfigurationError(
                f"{identity!r}'s wire transport delivers to "
                f"{wire_device}, its fabric slice to "
                f"{domain.device_of(identity)}: a party's values must "
                "land on one device"
            )
        self.domain = domain
        self.identity = identity
        self.inner = inner
        self.cells = cells
        domain.register_cells(identity, cells)

    def __getattr__(self, name):
        return getattr(self.inner, name)

    # -- routing --------------------------------------------------------

    def _wire_label(self) -> str:
        name = type(self.inner).__name__
        return {"GrpcNetworking": "grpc", "LocalNetworking": "local",
                "TcpNetworking": "tcp"}.get(name, "wire")

    def _wire_reason(self, receiver: str, rendezvous_key: str,
                     session_id: str) -> Optional[str]:
        """Why this edge rides the wire, or None when it is a permute.
        Checked per logical rendezvous key, before any lowering: the
        resolution order the cost model prices."""
        if not fabric_enabled():
            return "disabled"
        if not self.domain.is_member(receiver):
            return "trust_boundary"
        if self.domain.is_rejected_session(session_id):
            return "schedule_rejected"
        if self.domain.is_forced_wire(rendezvous_key):
            return "forced_wire"
        return None

    def _fallback(self, reason: str, count: int = 1) -> None:
        _fabric_metrics()["fallbacks"].inc(count, reason=reason)

    def force_wire(self, rendezvous_key: str) -> None:
        """Latch one stable rendezvous key onto the wire (the chaos
        layer's drop -> forced-wire replay hook)."""
        self.domain.force_wire(rendezvous_key)

    # -- plan-build-time gate (MSA505) ---------------------------------

    def prepare_fabric(self, comp, session_id: str) -> None:
        """Resolve this computation's rendezvous keys against the fabric
        at plan-build time and run the MSA505 deadlock rule over the
        fabric-lowered schedule.  A rejected computation is latched
        wire-only (every edge falls back to the wire) and
        flight-recorded: the fabric never enters a schedule the analyzer
        could not prove deadlock-free.  Memoized per computation."""
        domain = self.domain
        if domain._prepared.get(comp) is not None:
            if domain.is_rejected(comp):
                domain.reject_session(session_id)
            return
        from ..compilation.analysis.schedule import (
            analyze_fabric_schedules,
            reconstruct_schedules,
        )

        try:
            schedules = reconstruct_schedules(comp)
            errors = [
                d for d in analyze_fabric_schedules(
                    comp, schedules, frozenset(domain.parties)
                )
                if d.rule == "MSA505"
            ]
        except ValueError as e:
            # no linearization exists at all (MSA501): the plan layer
            # rejects it, the fabric declines too
            errors = [e]
        if errors:
            domain.reject_computation(comp)
            from .. import flight

            flight.record(
                "fabric_rejected", party=self.identity,
                session=session_id, findings=len(errors),
                detail=str(errors[0])[:240],
            )
        domain._prepared[comp] = True
        if domain.is_rejected(comp):
            domain.reject_session(session_id)

    # -- trait: send ----------------------------------------------------

    def send(self, value, receiver: str, rendezvous_key: str,
             session_id: str, **kwargs):
        reason = self._wire_reason(receiver, rendezvous_key, session_id)
        if reason is not None:
            self._fallback(reason)
            return self.inner.send(
                value, receiver, rendezvous_key, session_id, **kwargs
            )
        return self._fabric_send_one(
            value, receiver, rendezvous_key, session_id
        )

    def _fabric_send_one(self, value, receiver: str,
                         rendezvous_key: str, session_id: str):
        m = _net_metrics()
        leaves = value_leaves(value)
        key = transfer_key(session_id, rendezvous_key)
        target = self.domain.cells_of(receiver)
        if target is None:
            # the receiver's worker has not attached to the domain yet
            # (an ordering race at cluster start): the wire always works
            self._fallback("unregistered")
            return self.inner.send(
                value, receiver, rendezvous_key, session_id
            )
        if not leaves:
            # nothing for a permute to move (HostUnit/Shape/String):
            # direct cell delivery, zero bytes, as the cost model prices
            # it (a spec placeholder with no leaves)
            m["sends"].inc(transport="fabric")
            target.put(key, value)
            self._flight_send(session_id, receiver, 1, False, 0)
            return 0
        moved, bytes_moved = self.domain.permute(
            self.identity, receiver, leaves
        )
        out = _rebuild(value, moved)
        m["sends"].inc(transport="fabric")
        m["tx_bytes"].inc(bytes_moved, transport="fabric")
        _fabric_metrics()["payloads"].inc()
        target.put(key, out)
        self._flight_send(session_id, receiver, 1, False, bytes_moved)
        return bytes_moved

    def send_many(self, items, receiver: str, session_id: str):
        """Coalesced delivery: one permute moves every array leaf of
        every payload in the group, then each payload lands in its own
        rendezvous cell."""
        reasons = {
            k: self._wire_reason(receiver, k, session_id)
            for k, _ in items
        }
        wired = [(k, v) for k, v in items if reasons[k] is not None]
        for k, _ in wired:
            self._fallback(reasons[k])
        if len(wired) == len(items):
            return self.inner.send_many(items, receiver, session_id)
        if wired:
            # a chaos force-wire latch split the group: the wired keys
            # keep wire framing, the rest stay on the fabric
            self.inner.send_many(wired, receiver, session_id)
            items = [(k, v) for k, v in items if reasons[k] is None]
        target = self.domain.cells_of(receiver)
        if target is None:
            self._fallback("unregistered")
            return self.inner.send_many(items, receiver, session_id)
        m = _net_metrics()
        m["send_many"].inc(transport="fabric")
        m["send_many_payloads"].inc(len(items), transport="fabric")
        leafy: List[Tuple[str, Any, list]] = []
        passthrough: List[Tuple[str, Any]] = []
        for k, v in items:
            leaves = value_leaves(v)
            if leaves:
                leafy.append((k, v, leaves))
            else:
                passthrough.append((k, v))
        total = 0
        if leafy:
            flat: List[Any] = []
            for _, _, leaves in leafy:
                flat.extend(leaves)
            moved, total = self.domain.permute(
                self.identity, receiver, flat
            )
            fm = _fabric_metrics()
            fm["payloads"].inc(len(leafy))
            if len(leafy) > 1:
                fm["batched"].inc()
            m["tx_bytes"].inc(total, transport="fabric")
            pos = 0
            for k, v, leaves in leafy:
                out = _rebuild(v, moved[pos:pos + len(leaves)])
                pos += len(leaves)
                target.put(transfer_key(session_id, k), out)
        for k, v in passthrough:
            target.put(transfer_key(session_id, k), v)
        self._flight_send(
            session_id, receiver, len(items) + len(wired), True, total
        )
        return total

    def _flight_send(self, session_id: str, receiver: str,
                     payloads: int, coalesced: bool,
                     bytes_moved: int) -> None:
        from .. import flight

        flight.record(
            "send", party=self.identity, session=session_id,
            receiver=receiver, payloads=payloads, coalesced=coalesced,
            transport="fabric", bytes=bytes_moved,
        )

    # -- trait: receive -------------------------------------------------

    def _consume(self, payload, sender: str, plc: str, session_id: str):
        """Account one arrived payload: a raw value is a fabric delivery,
        bytes a wire delivery (the payload type is the transport
        marker)."""
        m = _net_metrics()
        if isinstance(payload, (bytes, bytearray)):
            from .. import profiling
            from ..serde import deserialize_value

            m["receives"].inc(transport=self._wire_label())
            m["rx_bytes"].inc(len(payload), transport=self._wire_label())
            with profiling.phase("serde", direction="rx"):
                return deserialize_value(bytes(payload), plc,
                                         self.domain.device_of(
                                             self.identity))
        m["receives"].inc(transport="fabric")
        m["rx_bytes"].inc(
            leaf_bytes(value_leaves(payload)), transport="fabric"
        )
        from .. import flight

        flight.record(
            "receive", party=self.identity, session=session_id,
            sender=sender, transport="fabric",
        )
        return _restamp_plc(payload, plc)

    def receive(self, sender: str, rendezvous_key: str, session_id: str,
                plc: str = "", timeout: float = DEFAULT_TIMEOUT_S,
                cancel=None, progress=None):
        payload = self.cells.get(
            transfer_key(session_id, rendezvous_key), timeout, cancel,
            progress,
        )
        return self._consume(payload, sender, plc, session_id)

    def try_receive(self, sender: str, rendezvous_key: str,
                    session_id: str, plc: str = ""):
        ok, payload = self.cells.try_take(
            transfer_key(session_id, rendezvous_key)
        )
        if not ok:
            return False, None
        return True, self._consume(payload, sender, plc, session_id)

    def activity_for(self, session_id: str):
        return self.cells.activity_for(session_id)

    # -- descriptors ----------------------------------------------------

    def fabric_cost_context(self):
        """The cost model's fabric prediction key, or None when no exact
        prediction exists (fabric disabled, or force-wire latches make
        the edge set key-dependent)."""
        if not fabric_enabled():
            return None
        with self.domain._lock:
            if self.domain._force_wire:
                return None
        return self.domain.cost_context()

    def transport_descriptor(self) -> Dict[str, str]:
        """What this party's session transport is, for session reports
        and bench rows."""
        return {
            "transport": "fabric" if fabric_enabled() else "grpc",
            "trust_model": self.domain.trust_model,
        }
