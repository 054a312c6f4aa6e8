"""Textual computation format: printer + parser.

Line-per-op format of the reference (``moose/src/textual/``):

    x = Input{arg_name = "x"}: () -> Tensor<Float64> () @Host(alice)
    dot_0 = Dot: (Tensor<Float64>, Tensor<Float64>) -> Tensor<Float64> (x, y) @Replicated(alice, bob, carole)
    z = Constant{value = HostFloat64Tensor([[1.0, 2.0]])}: () -> HostFloat64Tensor () @Host(alice)

Composite placements print with their IR name prefixed —
``@Replicated[rep](alice, bob, carole)`` — so moose_tpu graphs round-trip
exactly; the reference's nameless spelling ``@Replicated(alice, bob,
carole)`` is also accepted on parse (a canonical name is synthesized from
the owner list, as the reference's placements are identified by owners,
computation.rs:1626).

The port's own copy of ``moose_tpu/textual.py``: the printer and the
Python parser.  The JAX package hands texts of 64 KiB or more to its
C++ parser; the port parses every size with the Python grammar, which
gives the same computation.
"""

from __future__ import annotations

import ast
import re
from typing import Any, Optional

import numpy as np

from . import dtypes as dt
from .computation import (
    AdditivePlacement,
    Computation,
    HostPlacement,
    Mirrored3Placement,
    Operation,
    ReplicatedPlacement,
    Signature,
    Ty,
)
from .errors import MalformedComputationError

# ---------------------------------------------------------------------------
# Printing
# ---------------------------------------------------------------------------

_DTYPE_TOKENS = {
    "Float32": dt.float32,
    "Float64": dt.float64,
    "Int32": dt.int32,
    "Int64": dt.int64,
    "Uint32": dt.uint32,
    "Uint64": dt.uint64,
    "Bool": dt.bool_,
}


def _dtype_to_token(dtype: dt.DType) -> str:
    return dtype.short_textual()


def _parse_dtype_token(tok: str) -> dt.DType:
    if tok in _DTYPE_TOKENS:
        return _DTYPE_TOKENS[tok]
    m = re.match(r"Fixed(64|128)\((\d+),\s*(\d+)\)$", tok)
    if m:
        total, i, f = int(m.group(1)), int(m.group(2)), int(m.group(3))
        return dt.fixed64(i, f) if total == 64 else dt.fixed128(i, f)
    raise MalformedComputationError(f"unknown dtype token {tok!r}")


def _ty_to_textual(ty: Ty) -> str:
    return ty.to_textual()


def _tensor_literal_name(ret: Ty) -> str:
    if ret.name == "Tensor":
        dtype = ret.dtype
        base = {
            "float32": "HostFloat32Tensor",
            "float64": "HostFloat64Tensor",
            "int32": "HostInt32Tensor",
            "int64": "HostInt64Tensor",
            "uint32": "HostUint32Tensor",
            "uint64": "HostUint64Tensor",
            "bool": "HostBitTensor",
        }
        if dtype is not None and dtype.name in base:
            return base[dtype.name]
        return "HostFloat64Tensor"
    return ret.name


def _fmt_array(arr: np.ndarray) -> str:
    # Python-list rendering: always single-line (the parser is
    # line-per-op), exact for float64 (repr round-trips), and handles
    # object-dtype arrays of arbitrary-precision ring ints.
    return repr(arr.tolist())


def _escape_str(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"')


def _unescape_str(v: str) -> str:
    return v.replace('\\"', '"').replace("\\\\", "\\")


def _fmt_attr_value(v: Any, op: Operation, key: str) -> str:
    if key == "value":  # Constant payloads print with their carrier type
        ret = op.signature.return_type
        if isinstance(v, str):
            return f'HostString("{_escape_str(v)}")'
        if ret.name == "HostShape" or (
            isinstance(v, (tuple, list))
            and all(isinstance(x, (int, np.integer)) for x in v)
        ):
            return f"HostShape([{', '.join(str(int(x)) for x in v)}])"
        arr = np.asarray(v)
        return f"{_tensor_literal_name(ret)}({_fmt_array(arr)})"
    if isinstance(v, dt.DType):
        return _dtype_to_token(v)
    if isinstance(v, str):
        return f'"{_escape_str(v)}"'
    if isinstance(v, bytes):
        return "0x" + v.hex()
    if isinstance(v, bool):
        return "true" if v else "false"
    if v is None:
        return "null"
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    if isinstance(v, (float, np.floating)):
        return repr(float(v))
    if isinstance(v, (tuple, list)):
        return "[" + ", ".join(_fmt_attr_value(x, op, "") for x in v) + "]"
    if isinstance(v, np.ndarray):
        return f"Array({_fmt_array(v)}, {v.dtype})"
    raise MalformedComputationError(
        f"cannot print attribute {key}={v!r} of op {op.name}"
    )


def _fmt_placement(comp: Computation, name: str, reference_style: bool) -> str:
    plc = comp.placements[name]
    if isinstance(plc, HostPlacement):
        return f"@Host({plc.name})"
    kind = plc.kind
    owners = ", ".join(plc.owners)
    if reference_style:
        return f"@{kind}({owners})"
    return f"@{kind}[{plc.name}]({owners})"


def to_textual(comp: Computation, reference_style: bool = False) -> str:
    lines = []
    for name, op in comp.operations.items():
        attrs = ""
        if op.attributes:
            parts = [
                f"{k} = {_fmt_attr_value(v, op, k)}"
                for k, v in op.attributes.items()
            ]
            attrs = "{" + ", ".join(parts) + "}"
        sig = op.signature.to_textual()
        ins = ", ".join(op.inputs)
        plc = _fmt_placement(comp, op.placement_name, reference_style)
        lines.append(f"{name} = {op.kind}{attrs}: {sig} ({ins}) {plc}")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# Parsing (recursive descent over one line per op)
# ---------------------------------------------------------------------------


class _Cursor:
    def __init__(self, s: str):
        self.s = s
        self.i = 0

    def ws(self):
        while self.i < len(self.s) and self.s[self.i] in " \t":
            self.i += 1

    def peek(self) -> str:
        self.ws()
        return self.s[self.i] if self.i < len(self.s) else ""

    def expect(self, tok: str):
        self.ws()
        if not self.s.startswith(tok, self.i):
            raise MalformedComputationError(
                f"expected {tok!r} at col {self.i}: ...{self.s[self.i:self.i+40]!r}"
            )
        self.i += len(tok)

    def ident(self) -> str:
        self.ws()
        m = re.match(r"[A-Za-z_][A-Za-z0-9_\-.]*", self.s[self.i:])
        if not m:
            raise MalformedComputationError(
                f"expected identifier at col {self.i}: "
                f"{self.s[self.i:self.i+40]!r}"
            )
        self.i += m.end()
        return m.group(0)

    def number(self):
        self.ws()
        m = re.match(
            r"-?(?:\d+\.\d*(?:[eE][+-]?\d+)?|\d+[eE][+-]?\d+|\.\d+|\d+)",
            self.s[self.i:],
        )
        if not m:
            raise MalformedComputationError(
                f"expected number at col {self.i}"
            )
        tok = m.group(0)
        self.i += m.end()
        if any(c in tok for c in ".eE") and not tok.lstrip("-").isdigit():
            return float(tok)
        return int(tok)

    def string(self) -> str:
        self.ws()
        if self.s[self.i] != '"':
            raise MalformedComputationError(
                f"expected string at col {self.i}"
            )
        j = self.i + 1
        while j < len(self.s):
            if self.s[j] == "\\":
                j += 2
                continue
            if self.s[j] == '"':
                break
            j += 1
        if j >= len(self.s):
            raise MalformedComputationError("unterminated string")
        out = _unescape_str(self.s[self.i + 1:j])
        self.i = j + 1
        return out

    def balanced(self, open_ch: str, close_ch: str) -> str:
        """Consume a balanced bracket group and return its inner text."""
        self.ws()
        self.expect(open_ch)
        depth = 1
        start = self.i
        while self.i < len(self.s):
            c = self.s[self.i]
            if c == '"':
                # skip string literals so quoted brackets don't count
                self.i += 1
                while self.i < len(self.s):
                    if self.s[self.i] == "\\":
                        self.i += 2
                        continue
                    if self.s[self.i] == '"':
                        break
                    self.i += 1
            elif c == open_ch:
                depth += 1
            elif c == close_ch:
                depth -= 1
                if depth == 0:
                    inner = self.s[start:self.i]
                    self.i += 1
                    return inner
            self.i += 1
        raise MalformedComputationError(f"unbalanced {open_ch}")


# Short type names used by older reference artifacts (e.g.
# moose/benches/rep_computation.moose) for the host-prim types
# (host/prim.rs); canonicalized to the Host-qualified names
_TY_ALIASES = {
    "PrfKey": "HostPrfKey",
    "Seed": "HostSeed",
    "Unit": "HostUnit",
    "Shape": "HostShape",
    "String": "HostString",
}


def _parse_ty(cur: _Cursor) -> Ty:
    name = cur.ident()
    name = _TY_ALIASES.get(name, name)
    if cur.peek() == "<":
        cur.expect("<")
        tok = cur.ident()
        if cur.peek() == "(":
            inner = cur.balanced("(", ")")
            tok = f"{tok}({inner})"
        cur.expect(">")
        dtype = _parse_dtype_token(tok)
        return Ty(name, dtype)
    if name == "HostBitTensor":
        return Ty(name, dt.bool_)
    m = re.match(r"HostFloat(32|64)Tensor$", name)
    if m:
        return Ty(name, dt.float32 if m.group(1) == "32" else dt.float64)
    m = re.match(r"Host(U?)int(32|64)Tensor$", name)
    if m:
        u, b = m.group(1), m.group(2)
        return Ty(name, getattr(dt, ("u" if u else "") + "int" + b))
    return Ty(name)


def _parse_tensor_literal(cur: _Cursor, type_name: str):
    inner = cur.balanced("(", ")")
    if type_name == "HostString":
        sub = _Cursor(inner.strip())
        return sub.string()
    data = ast.literal_eval(
        inner.replace("null", "None")
        .replace("true", "True")
        .replace("false", "False")
    )
    if type_name == "HostShape":
        return tuple(int(x) for x in data)
    np_dtype = {
        "HostFloat32Tensor": np.float32,
        "HostFloat64Tensor": np.float64,
        "HostInt32Tensor": np.int32,
        "HostInt64Tensor": np.int64,
        "HostUint32Tensor": np.uint32,
        "HostUint64Tensor": np.uint64,
        "HostBitTensor": np.uint8,
    }.get(type_name)
    if np_dtype is not None:
        return np.asarray(data, dtype=np_dtype)
    if type_name.startswith("HostRing"):
        return data  # list of python ints (arbitrary precision)
    return np.asarray(data)


def _parse_attr_value(cur: _Cursor):
    c = cur.peek()
    if c == '"':
        return cur.string()
    if c == "[":
        inner = cur.balanced("[", "]")
        data = ast.literal_eval(
            ("[" + inner + "]")
            .replace("null", "None")
            .replace("true", "True")
            .replace("false", "False")
        )

        def tuplify(v):
            return tuple(tuplify(x) for x in v) if isinstance(v, list) else v

        return tuplify(data)
    if c.isdigit() or c == "-" or c == ".":
        return cur.number()
    ident = cur.ident()
    if ident == "true":
        return True
    if ident == "false":
        return False
    if ident == "null":
        return None
    if ident == "Array":
        inner = cur.balanced("(", ")")
        body, _, dtype_tok = inner.rpartition(",")
        return np.asarray(
            ast.literal_eval(body.strip()), dtype=dtype_tok.strip()
        )
    if ident in _DTYPE_TOKENS:
        return _DTYPE_TOKENS[ident]
    if ident.startswith("Fixed") and cur.peek() == "(":
        inner = cur.balanced("(", ")")
        return _parse_dtype_token(f"{ident}({inner})")
    if ident in ("Ring64", "Ring128", "Bit") and cur.peek() == "(":
        # scalar ring/bit constants (Fill payloads, computation.rs
        # Constant enum): plain python ints keep arbitrary precision
        inner = cur.balanced("(", ")")
        return int(inner.strip())
    if cur.peek() == "(":
        return _parse_tensor_literal(cur, ident)
    raise MalformedComputationError(f"cannot parse attr value {ident!r}")


# sync_key / rendezvous_key print as bare 128-bit hex in the reference's
# textual format (computation.rs:30-93 RendezvousKey / SyncKey Display)
_BARE_HEX_RE = re.compile(r"([0-9a-fA-F]{32})(?![0-9a-zA-Z_])")


def _normalize_key_bytes(key: str, value):
    """Canonicalize 128-bit key attributes to bytes: older artifacts
    print sync_key as a byte list ``[148, 8, ...]``, newer ones as bare
    hex; both mean the same 16 bytes."""
    if key not in ("sync_key", "rendezvous_key"):
        return value
    if isinstance(value, (tuple, list)) and all(
        isinstance(x, int) and 0 <= x < 256 for x in value
    ):
        return bytes(value)
    return value


def _parse_attrs(cur: _Cursor) -> dict:
    attrs: dict = {}
    cur.expect("{")
    while True:
        if cur.peek() == "}":
            cur.expect("}")
            return attrs
        key = cur.ident()
        cur.expect("=")
        cur.ws()
        m_hex = (
            _BARE_HEX_RE.match(cur.s, cur.i)
            if key in ("sync_key", "rendezvous_key")
            else None
        )
        if cur.s.startswith("0x", cur.i):
            m = re.match(r"0x([0-9a-fA-F]+)", cur.s[cur.i:])
            attrs[key] = bytes.fromhex(m.group(1))
            cur.i += m.end()
        elif m_hex:
            attrs[key] = bytes.fromhex(m_hex.group(1))
            cur.i = m_hex.end()
        else:
            attrs[key] = _normalize_key_bytes(key, _parse_attr_value(cur))
        if cur.peek() == ",":
            cur.expect(",")


def _canonical_composite_name(kind: str, owners: tuple) -> str:
    return f"{kind.lower()}({','.join(owners)})"


def _parse_placement(cur: _Cursor, comp: Computation) -> str:
    cur.expect("@")
    kind = cur.ident()
    name: Optional[str] = None
    if cur.peek() == "[":
        name = cur.balanced("[", "]").strip()
    owners = tuple(
        o.strip() for o in cur.balanced("(", ")").split(",") if o.strip()
    )
    if kind == "Host":
        plc = HostPlacement(owners[0])
    else:
        name = name or _canonical_composite_name(kind, owners)
        cls = {
            "Replicated": ReplicatedPlacement,
            "Mirrored3": Mirrored3Placement,
            "Additive": AdditivePlacement,
        }.get(kind)
        if cls is None:
            raise MalformedComputationError(f"unknown placement kind {kind}")
        plc = cls(name, owners)
    comp.add_placement(plc)
    return plc.name


def _parse_line(line: str, comp: Computation):
    cur = _Cursor(line)
    name = cur.ident()
    cur.expect("=")
    kind = cur.ident()
    attrs = _parse_attrs(cur) if cur.peek() == "{" else {}
    cur.expect(":")
    input_types = []
    variadic = False
    if cur.peek() == "[":
        # reference variadic form (computation.rs:620-767):
        # ``[T] -> R`` — one shared element type, any input count
        variadic = True
        sig_in_inner = cur.balanced("[", "]")
        input_types.append(_parse_ty(_Cursor(sig_in_inner)))
    else:
        sig_in_inner = cur.balanced("(", ")")
        if sig_in_inner.strip():
            sub = _Cursor(sig_in_inner)
            while True:
                input_types.append(_parse_ty(sub))
                if sub.peek() == ",":
                    sub.expect(",")
                else:
                    break
    cur.expect("->")
    ret_ty = _parse_ty(cur)
    ins_inner = cur.balanced("(", ")")
    inputs = [x.strip() for x in ins_inner.split(",") if x.strip()]
    plc_name = _parse_placement(cur, comp)
    comp.add_operation(
        Operation(
            name=name,
            kind=kind,
            inputs=inputs,
            placement_name=plc_name,
            signature=Signature(tuple(input_types), ret_ty,
                                variadic=variadic),
            attributes=attrs,
        )
    )


def parse_computation(text: str, force_native: Optional[bool] = None
                      ) -> Computation:
    """Parse the textual form into a :class:`Computation`, one op a line
    (blank lines and ``#``/``//`` comments skipped).  ``force_native=True``
    asks for the JAX package's C++ parser, which the port does not have
    (ROADMAP queue 1, item 12); ``None`` and ``False`` parse in Python."""
    if force_native:
        raise NotImplementedError(
            "the native textual parser is not ported; the Python parser "
            "reads every size (ROADMAP queue 1, item 12)"
        )
    comp = Computation()
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line or line.startswith("#") or line.startswith("//"):
            continue
        try:
            _parse_line(line, comp)
        except MalformedComputationError as e:
            raise MalformedComputationError(f"line {lineno}: {e}") from e
    return comp
