"""Key-lineage & PRF-stream analysis (rule family ``MSA8xx``).

An abstract interpreter over the lowered op vocabulary that tracks every
``PrfKeyGen`` / ``DeriveSeed`` / ``SampleSeeded`` / ``Sample`` as a
symbolic key / seed / stream fact and derives the per-(party, key) draw
sequence each party's PRF will produce.  The replicated protocols'
entire security and correctness rest on a discipline the runtime never
checks: party ``i`` holds exactly the key pair ``(k_i, k_{i+1})``, every
(key, nonce) pair names a *distinct* PRF stream, bit-domain draws are
separated from ring-domain draws by the ``_bit_domain_seed`` tag, and a
one-time mask protects exactly one opened value.  This module turns each
of those conventions into a compile-time diagnostic.

The fact lattice
----------------

- **Key facts** — each ``PrfKeyGen`` is a fresh key root; ``Identity``
  and paired ``Send``/``Receive`` ops move a key *copy* to another
  party, and a ``DeriveSeed`` placed on some host implies that host
  holds the key.  A key fact is the root op, the generating party, and
  the set of holding parties with the lineage of how each copy arrived.
- **Seed facts** — each ``DeriveSeed`` binds (key root, ``sync_key``
  nonce); seeds move like keys.  An unseeded ``Sample`` is modelled as
  a draw from a fresh single-use key (``fresh:<op>``), which by
  construction can never collide.
- **Draw facts** — each ``SampleSeeded`` consumes (party, key root,
  nonce, domain) where domain is ``bit`` when the op carries the
  ``max_value: 1`` attribute (the graph-level image of the runtime's
  ``_bit_domain_seed`` tag) and ``ring`` otherwise.  Draw *size* (the
  stream offset advance) comes from the lowered graph's baked
  ``HostShape`` constants.

Same (key, nonce) consumed on two *different* parties is the point of
the construction (PRF compression: both ends derive the same tensor
without communication) and is never flagged; the rules below judge only
provable violations.

Rules
-----

- ``MSA801`` (error): replicated setup mis-wired — a setup key is held
  by more than two parties, or crossed to a party other than the
  generator's predecessor in the replicated cycle, i.e. some party
  would hold a key pair other than ``(k_i, k_{i+1})``.  When the graph
  declares no :class:`ReplicatedPlacement` (lowered graphs keep host
  placements only), the cycle is *inferred*: a party holding setup keys
  generated by two different parties cannot hold ``(k_i, k_{i+1})`` of
  any consistent 3-cycle.
- ``MSA802`` (error): missing domain separation — a bit-domain draw
  (``HostBitTensor`` result) shares a seed with ring-domain draws but
  lacks the ``max_value: 1`` tag, so the bit stream and the ring stream
  coincide (the runtime dispatches the bit path by *result type*, so
  this executes without error and silently correlates shares).
- ``MSA803`` (error): stream-position reuse — two ``SampleSeeded`` ops
  on the *same* party provably consume the same (key, nonce, domain)
  stream from offset 0, producing identical PRF output where the
  protocol expects independent masks.
- ``MSA804`` (warning): two *different* values carrying the exact same
  linear mask set (closure under Add/Sub/Xor/Neg and value moves) are
  opened to a common party — subtracting them cancels every mask, so
  the receiver learns a fully unmasked combination.  The reshare /
  ``trunc_pr`` discipline keeps this clean by giving every opened
  value a mask unique to it (broadcasting one masked value to several
  parties is fine; so are mask-equal values sent to *different*
  parties, which no single receiver can combine; and mask-equal values
  the destination provably combines linearly into ONE result are a
  single reconstruction — one opening, not two — and are exempt).
- ``MSA805`` (info): per-(party, key) draw-count and stream-offset
  report; the machine-readable form is :func:`keystream_report` and is
  what the dynamic draw oracle (``tests/test_keystream_oracle.py``)
  asserts against the runtime's actual draw ledger.

Soundness caveats (also in DEVELOP.md):

- Logical (un-lowered) graphs are analyzed by lowering them internally
  (``typing``/``lowering``/``prune``/``toposort``); lowering needs
  static shapes for every Input/Load, so without usable ``arg_specs``
  the analysis returns no findings rather than guessing.
- Without declared replicated placements MSA801's inferred-cycle check
  assumes each party participates in one key cycle per analysis scope;
  two differently-ordered undeclared cycles over the *same* three
  parties would false-positive (compiled graphs cache one setup per
  (placement, owners) and cannot produce that shape).
- MSA804 is a structural heuristic (hence warning severity): it
  reasons over linear reachability only and treats any two distinct
  crossing values as independent openings.
- The party-stacked layout has no per-op graph; its static model
  (:func:`stacked_draw_trace`) is an abstract interpretation in the
  *shape domain* — the stacked interpreter walks ``meta`` tensors with
  the draw ledger recording, which is exact because stacked control
  flow depends only on shapes/widths, never on data.

The port's own copy of ``moose_tpu/compilation/analysis/keystream.py``:
the same facts over the port's lowering (``compilation
.compile_computation``); the JAX package's ``jax.eval_shape`` trace of
the stacked plan is the port's shape-only ``meta`` replay
(``execution.interpreter.Interpreter.replay``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

from ...computation import Computation, Operation, ReplicatedPlacement
from .diagnostics import Diagnostic, Severity

__all__ = [
    "DrawFact",
    "KeyFact",
    "RULES",
    "analyze_keystream",
    "host_draw_counts",
    "keystream_report",
    "stacked_draw_trace",
]

RULES = {
    "MSA801": (
        "replicated setup mis-wired: a party holds a key pair other "
        "than (k_i, k_{i+1}), or a setup key crossed to a forbidden "
        "party"
    ),
    "MSA802": (
        "missing domain separation: bit-domain and ring-domain draws "
        "share a seed without the bit-domain tag"
    ),
    "MSA803": (
        "stream-position reuse: two seeded samples provably consume "
        "the same (key, nonce, offset) PRF stream"
    ),
    "MSA804": (
        "one-time mask feeds two independent cross-party openings "
        "(reshare/trunc_pr masking discipline)"
    ),
    "MSA805": (
        "per-(party, key) PRF draw-count and stream-offset report"
    ),
}

# value moves and unit-coefficient combiners a mask survives (MSA804
# closure).  Multiplications/contractions absorb the mask non-linearly
# and Shl/Shr scale it — in both cases the result no longer cancels
# against the original mask, so those kinds break the closure.
_LINEAR_KINDS = frozenset(
    {"Add", "Sub", "Xor", "Neg", "Identity", "Send", "Receive"}
)

# op kinds / type names that only exist before lowering; their presence
# means the graph must be lowered before stream facts exist.
_LOGICAL_TY_PREFIXES = (
    "Tensor", "Replicated", "Additive", "Mirrored3", "Aes",
)


@dataclasses.dataclass
class KeyFact:
    """One PRF key root and everywhere a copy of it ended up."""

    root: str  # producing op name
    index: int  # creation-order index (session key_gen correspondence)
    gen_placement: str
    # placement -> op name of the first value that put the key there
    holders: Dict[str, str] = dataclasses.field(default_factory=dict)

    @property
    def label(self) -> str:
        return f"key:{self.index}"


@dataclasses.dataclass(frozen=True)
class _SeedFact:
    key_root: Optional[str]
    sync: Optional[str]  # hex nonce (or repr for non-bytes)


@dataclasses.dataclass
class DrawFact:
    """One ``SampleSeeded`` (or fresh ``Sample``) stream consumption."""

    op: str
    placement: str
    key_root: Optional[str]
    sync: Optional[str]
    domain: str  # "ring" | "bit"
    bit_result: bool  # result is HostBitTensor
    tagged: bool  # carries max_value: 1
    width: Optional[int]
    elems: Optional[int]
    fresh: bool = False


def _emission_sorted(names: List[str]) -> List[str]:
    """Creation order of symbolic op names: the ``op_N`` counter suffix
    when every name carries one (toposort may have reordered the dict),
    else the given order (hand-built graphs)."""
    suffixes = []
    for name in names:
        _, _, tail = name.rpartition("_")
        if not tail.isdigit():
            return names
        suffixes.append(int(tail))
    return [n for _, n in sorted(zip(suffixes, names))]


def _sync_label(sync: Any) -> Optional[str]:
    if sync is None:
        return None
    if isinstance(sync, bytes):
        return sync.hex()
    return repr(sync)


def _needs_lowering(comp: Computation) -> bool:
    for op in comp.operations.values():
        ret = op.signature.return_type.name
        if ret.startswith(_LOGICAL_TY_PREFIXES):
            return True
        for ty in op.signature.input_types:
            if ty.name.startswith(_LOGICAL_TY_PREFIXES):
                return True
    return False


def _lowering_specs(
    comp: Computation, arg_specs: Optional[Dict[str, Any]]
) -> Dict[str, Any]:
    """Adapt the analysis ``arg_specs`` convention ({name: shape} or
    {name: (shape, np_dtype)} or scalars/strings) to the lowering pass's
    expectation, filling dtypes from the Input signatures."""
    import numpy as np

    specs: Dict[str, Any] = {}
    for name, raw in (arg_specs or {}).items():
        if isinstance(raw, (str, int, float)):
            specs[name] = raw
            continue
        shape: Any = raw
        np_dtype = None
        if (
            isinstance(raw, tuple) and len(raw) == 2
            and isinstance(raw[0], (tuple, list))
        ):
            shape, np_dtype = raw
        try:
            shape = tuple(int(d) for d in shape)
        except (TypeError, ValueError):
            continue
        if np_dtype is None:
            op = comp.operations.get(name)
            dtype = op.signature.return_type.dtype if op else None
            np_name = getattr(dtype, "numpy_name", None)
            np_dtype = np.dtype(np_name) if np_name else np.dtype("float64")
        specs[name] = (shape, np_dtype)
    return specs


def _lowered(
    comp: Computation,
    arg_specs: Optional[Dict[str, Any]],
    prune: bool = True,
) -> Optional[Computation]:
    """Lower a logical graph so stream facts exist; ``None`` when the
    graph cannot be lowered (no static shapes) — the documented
    "no findings rather than guesses" escape hatch."""
    if not _needs_lowering(comp):
        return comp
    from .. import compile_computation

    passes = ["typing", "lowering"] + (["prune", "toposort"] if prune
                                       else [])
    try:
        return compile_computation(
            comp, passes=passes,
            arg_specs=_lowering_specs(comp, arg_specs),
        )
    except Exception:
        # missing arg specs / dynamic shapes / partially-typed graphs:
        # nothing sound can be said about the streams
        return None


# ---------------------------------------------------------------------------
# The analyzer
# ---------------------------------------------------------------------------


class _Analyzer:
    """Single forward walk deriving key/seed/draw facts, then the rule
    judgments over them."""

    def __init__(self, comp: Computation):
        self.comp = comp
        self.keys: Dict[str, KeyFact] = {}  # root op -> fact
        self.value_key: Dict[str, str] = {}  # op name -> key root
        self.value_seed: Dict[str, _SeedFact] = {}
        self.draws: List[DrawFact] = []
        self.diagnostics: List[Diagnostic] = []
        # rendezvous_key -> payload op name (for Receive pairing and
        # lineage chains through the network edge)
        self._send_payload: Dict[str, str] = {}
        for op in comp.operations.values():
            if op.kind == "Send" and op.inputs:
                rdv = op.attributes.get("rendezvous_key")
                if rdv is not None:
                    self._send_payload[rdv] = op.inputs[0]

    # -- fact derivation ---------------------------------------------------

    def run(self) -> "_Analyzer":
        try:
            order = self.comp.toposort_names()
        except ValueError:
            order = list(self.comp.operations)
        key_roots = _emission_sorted(
            [n for n in order
             if self.comp.operations[n].kind == "PrfKeyGen"]
        )
        for idx, root in enumerate(key_roots):
            op = self.comp.operations[root]
            self.keys[root] = KeyFact(
                root=root, index=idx, gen_placement=op.placement_name,
                holders={op.placement_name: root},
            )
        for name in order:
            self._visit(self.comp.operations[name])
        self._check_topology()
        self._check_streams()
        self._check_masks()
        self._report()
        return self

    def _visit(self, op: Operation) -> None:
        kind = op.kind
        if kind == "PrfKeyGen":
            self.value_key[op.name] = op.name
        elif kind == "DeriveSeed":
            root = self.value_key.get(op.inputs[0]) if op.inputs else None
            if root is not None:
                # deriving on a host implies the key is held there, even
                # without an explicit move op (hand-built graphs)
                self.keys[root].holders.setdefault(
                    op.placement_name, op.name
                )
            self.value_seed[op.name] = _SeedFact(
                root, _sync_label(op.attributes.get("sync_key"))
            )
        elif kind in ("Identity", "Send", "Receive"):
            src = None
            if kind == "Receive":
                src = self._send_payload.get(
                    op.attributes.get("rendezvous_key")
                )
            elif op.inputs:
                src = op.inputs[0]
            if src in self.value_key:
                root = self.value_key[src]
                self.value_key[op.name] = root
                if kind != "Send":  # a Send executes on the sender
                    self.keys[root].holders.setdefault(
                        op.placement_name, op.name
                    )
            elif src in self.value_seed:
                self.value_seed[op.name] = self.value_seed[src]
        elif kind == "SampleSeeded":
            seed = (self.value_seed.get(op.inputs[1])
                    if len(op.inputs) > 1 else None)
            tagged = op.attributes.get("max_value") == 1
            bit_result = (
                op.signature.return_type.name == "HostBitTensor"
            )
            self.draws.append(DrawFact(
                op=op.name, placement=op.placement_name,
                key_root=seed.key_root if seed else None,
                sync=seed.sync if seed else None,
                domain="bit" if tagged else "ring",
                bit_result=bit_result, tagged=tagged,
                width=self._width(op), elems=self._elems(op),
            ))
        elif kind == "Sample":
            self.draws.append(DrawFact(
                op=op.name, placement=op.placement_name,
                key_root=f"fresh:{op.name}", sync=None,
                domain=("bit" if op.attributes.get("max_value") == 1
                        else "ring"),
                bit_result=(
                    op.signature.return_type.name == "HostBitTensor"
                ),
                tagged=op.attributes.get("max_value") == 1,
                width=self._width(op), elems=self._elems(op),
                fresh=True,
            ))

    def _width(self, op: Operation) -> Optional[int]:
        name = op.signature.return_type.name
        if "128" in name:
            return 128
        if "64" in name:
            return 64
        return None

    def _elems(self, op: Operation) -> Optional[int]:
        """Drawn element count from the baked HostShape constant; None
        when the shape op is not a literal (un-lowered graphs)."""
        if not op.inputs:
            return None
        shp = self.comp.operations.get(op.inputs[0])
        if shp is None or shp.kind != "Constant":
            return None
        value = shp.attributes.get("value")
        try:
            return int(math.prod(int(d) for d in tuple(value)))
        except (TypeError, ValueError):
            return None

    # -- lineage chains ----------------------------------------------------

    def _chain(self, name: str, limit: int = 8) -> str:
        parts: List[str] = []
        cur: Optional[str] = name
        while cur is not None and limit > 0:
            op = self.comp.operations.get(cur)
            if op is None:
                break
            extra = ""
            if op.kind == "DeriveSeed":
                extra = f" sync={_sync_label(op.attributes.get('sync_key'))}"
            parts.append(f"{cur}({op.kind}@{op.placement_name}{extra})")
            nxt: Optional[str] = None
            if op.kind == "SampleSeeded" and len(op.inputs) > 1:
                nxt = op.inputs[1]
            elif op.kind == "Receive":
                nxt = self._send_payload.get(
                    op.attributes.get("rendezvous_key")
                )
            elif op.kind in ("DeriveSeed", "Identity", "Send") and op.inputs:
                nxt = op.inputs[0]
            cur = nxt
            limit -= 1
        return " <- ".join(parts)

    # -- MSA801: key topology ----------------------------------------------

    def _check_topology(self) -> None:
        cycles = [
            plc for plc in self.comp.placements.values()
            if isinstance(plc, ReplicatedPlacement)
        ]
        # inferred-cycle bookkeeping: holder -> {generator: key roots}
        incoming: Dict[str, Dict[str, List[str]]] = {}
        for fact in self.keys.values():
            holders = set(fact.holders)
            others = holders - {fact.gen_placement}
            if len(holders) > 2:
                self.diagnostics.append(Diagnostic(
                    "MSA801", Severity.ERROR,
                    f"setup key {fact.root} (generated @"
                    f"{fact.gen_placement}) is held by "
                    f"{sorted(holders)} — a pairwise PRF key may live "
                    f"on at most two parties; copies: "
                    + "; ".join(
                        self._chain(via)
                        for plc, via in sorted(fact.holders.items())
                        if plc != fact.gen_placement
                    ),
                    op=fact.root, placement=fact.gen_placement,
                ))
                continue
            if len(others) != 1:
                continue  # single-holder key (external-owner share)
            user = next(iter(others))
            shared = [
                c for c in cycles
                if fact.gen_placement in c.owners and user in c.owners
            ]
            if shared:
                ok = any(
                    user == c.owners[
                        (c.owners.index(fact.gen_placement) + 2) % 3
                    ]
                    for c in shared
                )
                if not ok:
                    c = shared[0]
                    want = c.owners[
                        (c.owners.index(fact.gen_placement) + 2) % 3
                    ]
                    self.diagnostics.append(Diagnostic(
                        "MSA801", Severity.ERROR,
                        f"replicated setup mis-wired: key {fact.root} "
                        f"generated @{fact.gen_placement} crossed to "
                        f"{user}; in cycle {c.owners} it may only be "
                        f"co-held by {want}, so {user} holds a key "
                        f"pair other than (k_i, k_{{i+1}}); copy: "
                        + self._chain(fact.holders[user]),
                        op=fact.root, placement=fact.gen_placement,
                    ))
            else:
                incoming.setdefault(user, {}).setdefault(
                    fact.gen_placement, []
                ).append(fact.root)
        for user, by_gen in sorted(incoming.items()):
            if len(by_gen) < 2:
                continue
            roots = sorted(r for rs in by_gen.values() for r in rs)
            self.diagnostics.append(Diagnostic(
                "MSA801", Severity.ERROR,
                f"party {user} holds setup keys generated by "
                f"{sorted(by_gen)} ({', '.join(roots)}) — its key "
                f"pair cannot be (k_i, k_{{i+1}}) of any consistent "
                f"replicated 3-cycle",
                op=roots[0], placement=user,
            ))

    # -- MSA802 / MSA803: stream discipline --------------------------------

    def _check_streams(self) -> None:
        # seed-lineage groups: (key root, sync) -> draws
        lineage: Dict[Tuple[Any, Any], List[DrawFact]] = {}
        for d in self.draws:
            if d.fresh or d.key_root is None:
                continue
            lineage.setdefault((d.key_root, d.sync), []).append(d)

        for (root, sync), group in sorted(lineage.items()):
            ring = [d for d in group if not d.tagged and not d.bit_result]
            untagged_bits = [d for d in group
                             if d.bit_result and not d.tagged]
            if ring and untagged_bits:
                for d in untagged_bits:
                    self.diagnostics.append(Diagnostic(
                        "MSA802", Severity.ERROR,
                        f"missing domain separation: {d.op} draws "
                        f"bit-domain values from seed (key {root}, "
                        f"sync {sync}) without the bit-domain tag "
                        f"(max_value: 1) while ring draws "
                        f"({', '.join(r.op for r in ring)}) consume "
                        f"the same stream — the two streams coincide; "
                        f"chain: " + self._chain(d.op),
                        op=d.op, placement=d.placement,
                    ))

        # stream positions: same party + key + nonce + domain = same
        # stream from offset 0 (cross-party repetition is the PRF
        # compression the protocols rely on, never flagged)
        streams: Dict[Tuple[str, Any, Any, str], List[DrawFact]] = {}
        for d in self.draws:
            if d.fresh or d.key_root is None:
                continue
            streams.setdefault(
                (d.placement, d.key_root, d.sync, d.domain), []
            ).append(d)
        for (plc, root, sync, domain), group in sorted(streams.items()):
            if len(group) < 2:
                continue
            chains = "; ".join(self._chain(d.op) for d in group)
            self.diagnostics.append(Diagnostic(
                "MSA803", Severity.ERROR,
                f"stream-position reuse: "
                f"{', '.join(d.op for d in group)} all consume stream "
                f"(key {root}, sync {sync}, {domain} domain) "
                f"@{plc} from offset 0 — identical PRF output where "
                f"the protocol expects independent draws; chains: "
                + chains,
                op=group[0].op, placement=plc,
            ))

    # -- MSA804: mask / opening discipline ---------------------------------

    def _check_masks(self) -> None:
        """Two *different* values opened cross-party with the *same*
        linear mask set cancel under subtraction — the receiver learns
        their plaintext difference with every mask gone.  Each opening
        must therefore contain at least one mask unique to it; grouping
        openings by exact mask set flags the violations and stays quiet
        on the share/reshare/trunc_pr protocols, where every opened
        value carries a distinct fresh mask.  Deliberate reconstruction
        (receiver linearly combines everything it received back into
        one plaintext — the reveal at the end of an inference graph) is
        exempt: it is one opening of one logical value."""
        try:
            order = self.comp.toposort_names()
        except ValueError:
            order = list(self.comp.operations)
        sample_ops = {d.op for d in self.draws}
        mask_set: Dict[str, frozenset] = {}
        for name in order:
            op = self.comp.operations[name]
            if name in sample_ops:
                mask_set[name] = frozenset((name,))
            elif op.kind in _LINEAR_KINDS:
                if op.kind == "Receive":
                    srcs = [self._send_payload.get(
                        op.attributes.get("rendezvous_key"))]
                else:
                    srcs = op.inputs
                acc: frozenset = frozenset()
                for src in srcs:
                    acc |= mask_set.get(src, frozenset())
                mask_set[name] = acc
            # any other kind (mul, dot, trunc combine, ...) absorbs the
            # mask non-linearly: no longer cancellable, set resets

        def canonical(name: str) -> str:
            # a chain of moves (Identity / Send+Receive) is the SAME
            # value visiting several hosts, not a new opened value
            seen = set()
            while name not in seen:
                seen.add(name)
                op = self.comp.operations.get(name)
                if op is None:
                    break
                if op.kind == "Identity" and op.inputs:
                    name = op.inputs[0]
                elif op.kind == "Receive":
                    nxt = self._send_payload.get(
                        op.attributes.get("rendezvous_key")
                    )
                    if nxt is None:
                        break
                    name = nxt
                elif op.kind == "Send" and op.inputs:
                    name = op.inputs[0]
                else:
                    break
            return name

        # openings: mask-carrying values moved to another party.  One
        # value broadcast to several parties — even via chained moves —
        # is a single opening with several destinations.  For each
        # (value, destination) remember the receiving-side entry op so
        # the reconstruction check below can walk the destination's
        # consumers.
        recv_of = {
            op.attributes.get("rendezvous_key"): op.name
            for op in self.comp.operations.values()
            if op.kind == "Receive"
        }
        openings: Dict[str, set] = {}
        entries: Dict[Tuple[str, str], set] = {}
        for name in order:
            op = self.comp.operations[name]
            src: Optional[str] = None
            dest: Optional[str] = None
            entry: Optional[str] = None
            if op.kind == "Identity" and op.inputs:
                src = op.inputs[0]
                src_op = self.comp.operations.get(src)
                if (src_op is not None
                        and src_op.placement_name != op.placement_name):
                    dest = op.placement_name
                    entry = name
            elif op.kind == "Send" and op.inputs:
                src = op.inputs[0]
                dest = op.attributes.get("receiver", "<remote>")
                entry = recv_of.get(op.attributes.get("rendezvous_key"))
            if src is None or dest is None:
                continue
            src = canonical(src)
            if mask_set.get(src):
                openings.setdefault(src, set()).add(dest)
                if entry is not None:
                    entries.setdefault((src, dest), set()).add(entry)

        # destination-side consumer edges (Send -> Receive stitched)
        consumers: Dict[str, List[str]] = {}
        for op in self.comp.operations.values():
            for inp in op.inputs:
                consumers.setdefault(inp, []).append(op.name)

        def dest_reach(src: str, dest: str) -> frozenset:
            # ops at the destination reachable from the received value
            # through linear kinds, plus the first non-linear consumer
            # of each chain (the boundary where the mask stops
            # cancelling)
            frontier = list(entries.get((src, dest), ()))
            seen: set = set(frontier)
            while frontier:
                cur = frontier.pop()
                for nxt in consumers.get(cur, ()):
                    if nxt in seen:
                        continue
                    seen.add(nxt)
                    if self.comp.operations[nxt].kind in _LINEAR_KINDS:
                        frontier.append(nxt)
            return frozenset(seen)

        # the leak needs a single party holding two mask-equal values:
        # group by (mask set, receiving party)
        by_key: Dict[Tuple[frozenset, str], List[str]] = {}
        for src, dests in openings.items():
            for dest in dests:
                by_key.setdefault((mask_set[src], dest), []).append(src)
        flagged: set = set()
        for (masks, dest), srcs in sorted(
            by_key.items(), key=lambda kv: sorted(kv[1])
        ):
            if len(srcs) < 2:
                continue
            srcs = tuple(sorted(srcs))
            if (masks, srcs) in flagged:
                continue  # same pair already reported for another dest
            # reconstruction exemption: when every member flows into a
            # common linear combine at the destination, the receiver is
            # deliberately summing shares back into one plaintext — a
            # single opening of a single logical value (the
            # declassification MSA103 already points at), not
            # independent openings leaking through a shared mask.
            reaches = [dest_reach(s, dest) for s in srcs]
            if reaches and frozenset.intersection(*reaches):
                continue
            flagged.add((masks, srcs))
            shown = sorted(masks)[:4]
            self.diagnostics.append(Diagnostic(
                "MSA804", Severity.WARNING,
                f"one-time mask reuse across openings: "
                f"{', '.join(srcs)} are distinct values opened to "
                f"{dest}, all protected by the exact same mask set "
                f"{{{', '.join(shown)}"
                f"{', ...' if len(masks) > 4 else ''}}} — subtracting "
                f"them cancels every mask; mask chain: "
                + self._chain(shown[0]),
                op=srcs[0],
                placement=self.comp.operations[srcs[0]].placement_name,
            ))

    # -- MSA805: draw report -----------------------------------------------

    def per_party_key(self) -> Dict[Tuple[str, str], Dict[str, int]]:
        """Seeded-draw counts per (party, key label), ledger-shaped
        (:meth:`moose_tpu_torch.execution.drawledger.DrawLedger.host_report`)."""
        out: Dict[Tuple[str, str], Dict[str, int]] = {}
        for d in self.draws:
            if d.fresh:
                continue
            label = (self.keys[d.key_root].label
                     if d.key_root in self.keys else "<untracked>")
            slot = out.setdefault(
                (d.placement, label),
                {"draws": 0, "elems": 0, "ring_draws": 0, "bit_draws": 0},
            )
            slot["draws"] += 1
            slot["elems"] += d.elems or 0
            is_bit = d.tagged or d.bit_result
            slot["bit_draws" if is_bit else "ring_draws"] += 1
        return out

    def _report(self) -> None:
        seeded = [d for d in self.draws if not d.fresh]
        if not seeded and not self.keys:
            return
        bits = sum(1 for d in seeded if d.tagged or d.bit_result)
        parties = sorted({d.placement for d in seeded})
        offsets = self.stream_offsets()
        deepest = max(
            offsets.items(), key=lambda kv: kv[1], default=(None, 0)
        )
        at = ""
        if deepest[0] is not None:
            plc, label, _sync, domain = deepest[0]
            at = (f"; deepest stream offset {deepest[1]} elems "
                  f"({label} @{plc}, {domain})")
        self.diagnostics.append(Diagnostic(
            "MSA805", Severity.INFO,
            f"keystream: {len(self.keys)} keys, {len(seeded)} seeded "
            f"draws ({len(seeded) - bits} ring / {bits} bit) across "
            f"{len(parties)} parties"
            + (f" ({', '.join(parties)})" if parties else "") + at,
        ))

    def stream_offsets(self) -> Dict[Tuple[str, str, Any, str], int]:
        """Final stream offset (total elements consumed) per
        (party, key label, sync, domain)."""
        out: Dict[Tuple[str, str, Any, str], int] = {}
        for d in self.draws:
            if d.fresh or d.key_root is None:
                continue
            label = (self.keys[d.key_root].label
                     if d.key_root in self.keys else "<untracked>")
            k = (d.placement, label, d.sync, d.domain)
            out[k] = out.get(k, 0) + (d.elems or 0)
        return out


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def analyze_keystream(
    comp: Computation,
    arg_specs: Optional[Dict[str, Any]] = None,
) -> List[Diagnostic]:
    """Run the MSA8xx rules over ``comp`` (lowering logical graphs
    internally; see the module docstring's caveats)."""
    lowered = _lowered(comp, arg_specs)
    if lowered is None:
        return []
    return _Analyzer(lowered).run().diagnostics


def keystream_report(
    comp: Computation,
    arg_specs: Optional[Dict[str, Any]] = None,
    prune: bool = True,
) -> dict:
    """Machine-readable MSA805 report (JSON-safe).  ``prune=False``
    keeps dead draws — matching eager evaluation, which executes every
    traced op; the draw oracle uses that mode."""
    lowered = _lowered(comp, arg_specs, prune=prune)
    if lowered is None:
        return {"analyzed": False, "reason": "graph could not be lowered "
                "(missing static shapes)", "keys": [], "draws": [],
                "per_party_key": {}, "stream_offsets": {}}
    an = _Analyzer(lowered).run()
    return {
        "analyzed": True,
        "keys": [
            {"root": f.root, "label": f.label, "index": f.index,
             "gen": f.gen_placement, "holders": sorted(f.holders)}
            for f in sorted(an.keys.values(), key=lambda f: f.index)
        ],
        "draws": [
            {"op": d.op, "party": d.placement, "key": d.key_root,
             "sync": d.sync, "domain": d.domain, "width": d.width,
             "elems": d.elems, "fresh": d.fresh}
            for d in an.draws
        ],
        "per_party_key": {
            f"{plc}|{label}": dict(counts)
            for (plc, label), counts in sorted(
                an.per_party_key().items()
            )
        },
        "stream_offsets": {
            f"{plc}|{label}|{sync}|{domain}": total
            for (plc, label, sync, domain), total in sorted(
                an.stream_offsets().items()
            )
        },
        "diagnostics": [d.to_dict() for d in an.diagnostics],
    }


def host_draw_counts(
    comp: Computation,
    arg_specs: Optional[Dict[str, Any]] = None,
) -> Dict[Tuple[str, str], Dict[str, int]]:
    """The static side of the per-host draw oracle: per-(party, key
    label) seeded-draw counts of the *unpruned* lowered graph, in
    exactly the shape of ``DrawLedger.host_report()`` (eager evaluation
    draws everything it traces, so the pruned graph would undercount)."""
    lowered = _lowered(comp, arg_specs, prune=False)
    if lowered is None:
        raise ValueError(
            "host_draw_counts requires a lowerable computation; pass "
            "arg_specs with static shapes"
        )
    return _Analyzer(lowered).run().per_party_key()


def stacked_draw_trace(
    comp: Computation,
    arg_specs: Dict[str, Any],
) -> List[tuple]:
    """The static side of the stacked-layout draw oracle: the ordered
    (kind, width, elems) PRF-draw sequence of the party-stacked
    interpreter, derived *abstractly* — the stacked dialect walks
    ``meta`` tensors of the arguments' shapes with the draw ledger
    recording, so no array math runs, no kernel launches and no real
    entropy is consumed (``native.ring_kernels`` is shape only on
    ``meta``).  The walk stops at the plan's outputs, revealed and not
    decoded.  Sound because stacked control flow (including the
    polynomial-evaluation draw schedule) depends only on shapes, dtypes
    and ring widths, never on data.
    """
    import numpy as np

    from ...dialects import stacked
    from ...execution import drawledger, interpreter

    arguments: Dict[str, Any] = {}
    for name, raw in _lowering_specs(comp, arg_specs).items():
        if isinstance(raw, (str, int, float)):
            arguments[name] = raw
        else:
            shape, np_dtype = raw
            arguments[name] = np.zeros(shape, np_dtype)
    walk = interpreter.Interpreter("meta", stacked.StackedDialect())
    with drawledger.recording() as ledger:
        walk.replay(comp, arguments)
    return ledger.stacked_trace()
