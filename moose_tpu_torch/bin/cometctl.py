"""cometctl: cluster control — launch/retrieve/abort/run sessions against
comet workers (reference ``moose/src/bin/comet/cometctl.rs:30-145``).
The port's own copy of ``moose_tpu/bin/cometctl.py``, with the
reference's ``launch`` and ``retrieve`` beside ``run`` and ``abort``.

Session files are TOML (reference .session format):

    session_id = "my-session"
    [computation]
    path = "comp.moose"        # textual or msgpack
    [roles]
    alice = "localhost:50001"
    bob = "localhost:50002"
    carole = "localhost:50003"

  python -m moose_tpu_torch.bin.cometctl run session.toml --args args.json
"""

from __future__ import annotations

import argparse
import json
import secrets
import sys

import tomllib
from pathlib import Path

import numpy as np


def _load_session(path: str):
    cfg = tomllib.loads(Path(path).read_text())
    comp_path = cfg["computation"]["path"]
    data = Path(comp_path).read_bytes()
    from moose_tpu_torch.serde import deserialize_computation
    from moose_tpu_torch.textual import parse_computation

    if comp_path.endswith((".moose", ".txt")) or data[:1].isalpha():
        comp = parse_computation(data.decode())
    else:
        comp = deserialize_computation(data)
    session_id = cfg.get("session_id") or secrets.token_hex(8)
    return session_id, comp, dict(cfg["roles"])


def _load_args(path):
    if path is None:
        return {}
    raw = json.loads(Path(path).read_text())
    return {
        k: (v if isinstance(v, (str, int, float)) else np.asarray(v))
        for k, v in raw.items()
    }


def _tls_from_args(args):
    from moose_tpu_torch.distributed.tls import tls_config_from_flags

    try:
        return tls_config_from_flags(
            args.tls_cert, args.tls_key, args.tls_ca
        )
    except ValueError as e:
        raise SystemExit(str(e))


def cmd_run(args):
    from moose_tpu_torch.distributed.client import GrpcClientRuntime

    session_id, comp, roles = _load_session(args.session)
    runtime = GrpcClientRuntime(roles, tls=_tls_from_args(args))
    outputs, timings = runtime.run_computation(
        comp, _load_args(args.args), timeout=args.timeout,
    )
    for role, micros in sorted(timings.items()):
        print(f"# {role}: {micros} us", file=sys.stderr)
    _print_outputs(outputs, args.json)


def _compiled_for_roles(comp, arguments):
    """The lowered bytes of ``comp`` for ``arguments`` and each role's
    own arguments (an Input's value goes to its owner only), as
    ``GrpcClientRuntime.run_computation`` ships them."""
    from moose_tpu_torch.compilation import DEFAULT_PASSES, compile_computation
    from moose_tpu_torch.compilation.lowering import arg_specs_from_arguments
    from moose_tpu_torch.serde import serialize_computation

    compiled = compile_computation(
        comp, DEFAULT_PASSES, arg_specs=arg_specs_from_arguments(arguments)
    )
    owner_of = {
        op.name: compiled.placement_of(op).name
        for op in compiled.operations.values()
        if op.kind == "Input"
    }
    return serialize_computation(compiled), owner_of


def cmd_launch(args):
    from moose_tpu_torch.distributed.choreography import ChoreographyClient

    session_id, comp, roles = _load_session(args.session)
    arguments = _load_args(args.args)
    blob, owner_of = _compiled_for_roles(comp, arguments)
    tls = _tls_from_args(args)
    for role, endpoint in roles.items():
        own = {k: v for k, v in arguments.items() if owner_of.get(k) == role}
        ChoreographyClient(endpoint, tls=tls, expected_identity=role).launch(
            session_id, blob, own)
        print(f"launched {session_id} on {role}")


def cmd_retrieve(args):
    from moose_tpu_torch.distributed.choreography import ChoreographyClient
    from moose_tpu_torch.serde import deserialize_value

    session_id, _, roles = _load_session(args.session)
    tls = _tls_from_args(args)
    outputs = {}
    for role, endpoint in roles.items():
        result = ChoreographyClient(
            endpoint, tls=tls, expected_identity=role,
        ).retrieve(session_id, timeout=args.timeout)
        if "error" in result:
            raise SystemExit(f"{role}: {result['error']}")
        print(f"# {role}: {result.get('elapsed_time_micros', 0)} us",
              file=sys.stderr)
        for name, blob in (result.get("outputs") or {}).items():
            value = deserialize_value(blob)
            outputs[name] = None if not isinstance(value, np.ndarray) \
                else value
    _print_outputs(outputs, args.json)


def _print_outputs(outputs: dict, as_json: bool) -> None:
    if as_json:
        print(json.dumps({
            name: (None if value is None
                   else np.asarray(value).tolist())
            for name, value in outputs.items()
        }))
        return
    for name, value in outputs.items():
        print(name, "=", None if value is None else np.asarray(value))


def cmd_abort(args):
    from moose_tpu_torch.distributed.choreography import ChoreographyClient

    session_id, _, roles = _load_session(args.session)
    tls = _tls_from_args(args)
    for role, endpoint in roles.items():
        ChoreographyClient(endpoint, tls=tls,
                           expected_identity=role).abort(session_id)
        print(f"aborted {session_id} on {role}")


def main(argv=None):
    parser = argparse.ArgumentParser(prog="cometctl", description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_run = sub.add_parser("run", help="launch + retrieve a session")
    p_run.add_argument("session")
    p_run.add_argument("--args", default=None, help="JSON arguments file")
    p_run.add_argument("--json", action="store_true",
                       help="print outputs as one JSON object")
    p_run.add_argument("--timeout", type=float, default=120.0,
                       help="seconds to wait for each role's results")
    p_run.set_defaults(fn=cmd_run)
    p_launch = sub.add_parser(
        "launch", help="launch a session on every role")
    p_launch.add_argument("session")
    p_launch.add_argument("--args", default=None,
                          help="JSON arguments file")
    p_launch.set_defaults(fn=cmd_launch)
    p_retrieve = sub.add_parser(
        "retrieve", help="retrieve a launched session's outputs")
    p_retrieve.add_argument("session")
    p_retrieve.add_argument("--timeout", type=float, default=120.0)
    p_retrieve.add_argument("--json", action="store_true",
                            help="print outputs as one JSON object")
    p_retrieve.set_defaults(fn=cmd_retrieve)
    p_abort = sub.add_parser("abort", help="abort a session")
    p_abort.add_argument("session")
    p_abort.set_defaults(fn=cmd_abort)
    for p in (p_run, p_launch, p_retrieve, p_abort):
        p.add_argument("--tls-cert", default=None,
                       help="PEM certificate chain (CN = client identity)")
        p.add_argument("--tls-key", default=None,
                       help="PEM private key for --tls-cert")
        p.add_argument("--tls-ca", default=None,
                       help="PEM CA bundle that signs every party")
    args = parser.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
