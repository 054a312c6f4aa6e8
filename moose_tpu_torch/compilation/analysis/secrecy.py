"""Secrecy / information-flow lint (rule family ``MSA1xx``).

Forward taint propagation over the logical graph: every value produced on
a secret-sharing placement (Replicated, Additive) is *secret*; taint
follows dataflow edges until a declassifying consumption (Reveal, or the
eDSL's host-side Cast/Output/Save/decode idiom) deliberately exits the
value to a host.  Any other path that lands secret data on a host
placement is a share leak — the core invariant of the whole framework
("secret shares are never collected on one machine") made
machine-checkable before anything runs.

Rules:

- ``MSA101`` (error): a host-placed op computes on or forwards a secret
  value without declassifying it (share leak).
- ``MSA102`` (warning): a secret value is moved to a host via an
  ``Identity`` placement move — an implicit reveal; prefer an explicit
  cast/reveal at the output party.
- ``MSA103`` (info): declassification point — a secret value exits to a
  host via Reveal/Cast/Output/Save/decode.  Informational: the audit
  trail of every place plaintext comes into existence.
- ``MSA104`` (warning): a secret value is consumed on a Mirrored3
  placement; mirrored values are public to all owners, so this
  broadcast-reveals the secret.
- ``MSA105`` (error): a plaintext ``Save`` persists a secret-derived
  value — unlike the transient reveal idiom, this writes the secret to
  durable party-local storage.  The per-party ring-share limb-plane
  Saves that ``save_shares`` lowers to (ring-typed value, party-local
  ``<key>#s0``/``<key>#s1`` keys — see ``lowering.share_key``) are
  share-typed and pass: each party persists only the two additive
  shares it already holds, which reveal nothing without the other two
  storages.

The port's own copy of
``moose_tpu/compilation/analysis/secrecy.py``: pure graph and numpy
code, it imports nothing of the JAX package.
"""

from __future__ import annotations

from ...computation import Computation
from .diagnostics import Diagnostic, Severity

# Placement kinds whose produced values are secret-shared.
SECRET_PLACEMENT_KINDS = frozenset({"Replicated", "Additive"})

# Op kinds that, when placed on a host and consuming a secret value,
# constitute a *deliberate* declassification (the eDSL's reveal idiom:
# an explicit Reveal, or a host-side cast/decode/output of a secret).
DECLASSIFYING_KINDS = frozenset({
    "Reveal", "Cast", "Output", "Save",
    "FixedpointDecode", "RingFixedpointDecode",
})

# storage-key suffixes of the per-party share planes save_shares lowers
# to (lowering.share_key): every party holds the same two keys, each
# plane is one additive share — useless without the other storages.
_SHARE_KEY_SUFFIXES = ("#s0", "#s1")


def _is_share_plane_save(comp: Computation, op) -> bool:
    """True for the ring-share limb-plane Saves emitted by the training
    storage lowering: the persisted value is ring-typed (a raw share,
    not a decoded plaintext) AND the key is a party-local share plane
    (``<key>#s0``/``#s1``)."""
    if len(op.inputs) < 2:
        return False
    value_ty = None
    if len(op.signature.input_types) >= 2:
        value_ty = op.signature.input_types[1]
    if value_ty is None or "Ring" not in value_ty.name:
        return False
    key_op = comp.operations.get(op.inputs[0])
    if key_op is None or key_op.kind != "Constant":
        return False
    key = key_op.attributes.get("value")
    return isinstance(key, str) and key.endswith(_SHARE_KEY_SUFFIXES)


def analyze_secrecy(comp: Computation) -> list[Diagnostic]:
    diagnostics: list[Diagnostic] = []

    def plc_kind(op) -> str:
        plc = comp.placements.get(op.placement_name)
        return plc.kind if plc is not None else "Unknown"

    # Fixpoint taint propagation (a worklist, not a toposort, so the
    # analysis terminates on cyclic graphs instead of crashing — cycles
    # are MSA204/well-formedness territory).
    secret: set[str] = set()
    consumers = {name: [] for name in comp.operations}
    for op in comp.operations.values():
        for inp in op.inputs:
            if inp in consumers:
                consumers[inp].append(op.name)

    def produces_secret(op) -> bool:
        if plc_kind(op) in SECRET_PLACEMENT_KINDS:
            return True
        # Host/mirrored op: taints its output iff it consumes a secret
        # without declassifying it.  An Identity move also clears taint:
        # the value IS plaintext on the host afterwards — the move
        # itself is the finding (MSA102), not every downstream use.
        if op.kind in DECLASSIFYING_KINDS or op.kind == "Identity":
            return False
        return any(inp in secret for inp in op.inputs)

    worklist = list(comp.operations)
    while worklist:
        name = worklist.pop()
        op = comp.operations[name]
        if name not in secret and produces_secret(op):
            secret.add(name)
            worklist.extend(consumers.get(name, ()))

    for name, op in comp.operations.items():
        kind = plc_kind(op)
        if kind in SECRET_PLACEMENT_KINDS:
            continue
        if not any(inp in secret for inp in op.inputs):
            continue
        secret_inputs = [inp for inp in op.inputs if inp in secret]
        if kind == "Mirrored3":
            diagnostics.append(Diagnostic(
                "MSA104", Severity.WARNING,
                f"secret value(s) {secret_inputs} consumed on mirrored "
                f"placement; mirrored values are public to all owners",
                op=name, placement=op.placement_name,
            ))
            continue
        if op.kind == "Save":
            # persisting beats revealing: a transient host reveal is the
            # deliberate exit idiom (MSA103), but writing a
            # secret-derived value to durable party storage is a leak —
            # unless it is a share-typed limb-plane Save, which persists
            # only what the party already holds
            if _is_share_plane_save(comp, op):
                continue
            diagnostics.append(Diagnostic(
                "MSA105", Severity.ERROR,
                f"secret persisted in the clear: Save writes "
                f"secret-derived value(s) {secret_inputs} to this "
                f"party's durable storage; reveal explicitly first "
                f"(Cast/Reveal) or use save_shares to keep the "
                f"checkpoint secret-shared",
                op=name, placement=op.placement_name,
            ))
        elif op.kind in DECLASSIFYING_KINDS:
            diagnostics.append(Diagnostic(
                "MSA103", Severity.INFO,
                f"declassification point: {op.kind} reveals "
                f"{secret_inputs} to this host",
                op=name, placement=op.placement_name,
            ))
        elif op.kind == "Identity":
            diagnostics.append(Diagnostic(
                "MSA102", Severity.WARNING,
                f"secret value(s) {secret_inputs} moved to host via "
                f"Identity (implicit reveal); prefer an explicit "
                f"cast/reveal at the output party",
                op=name, placement=op.placement_name,
            ))
        else:
            diagnostics.append(Diagnostic(
                "MSA101", Severity.ERROR,
                f"share leak: {op.kind} on a host placement consumes "
                f"secret value(s) {secret_inputs} without an intervening "
                f"Reveal/Output",
                op=name, placement=op.placement_name,
            ))
    return diagnostics


RULES = {
    "MSA101": "share leak: host op consumes a secret value without "
              "declassification",
    "MSA102": "implicit reveal: secret moved to host via Identity",
    "MSA103": "declassification point (informational audit trail)",
    "MSA104": "secret consumed on a Mirrored3 placement (public to all "
              "owners)",
    "MSA105": "secret persisted in the clear: plaintext Save of a "
              "secret-derived value (share-typed #s0/#s1 limb-plane "
              "saves pass)",
}
