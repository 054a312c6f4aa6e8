"""The port's native TCP transport (``moose_tpu_torch/native/
tcp_transport.cpp`` through ``distributed.networking.TcpNetworking``,
built with g++ at first use), its ``vixen`` worker and ``rudolph``'s
filesystem choreography, held against the JAX package's workers on the
CPU.

The graph is tests/test_distributed.py's secure dot (4x3 @ 3x2),
lowered by both packages inside their ``deterministic_sync_keys`` (the
same bytes); under ``MOOSE_TPU_FIXED_KEYS`` and the threefry PRF the
port's outputs over TCP, through three ``vixen`` mains and through a
``.session`` file launched on three gRPC workers equal the JAX workers'
outputs word for word (decoded floats, compared exactly), and within
1e-4 of x @ y.  ``rudolph`` exits 0 on SIGTERM."""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

from moose_tpu_torch.distributed.choreography import (
    ChoreographyClient,
    start_local_cluster,
)
from moose_tpu_torch.distributed.networking import TcpNetworking
from moose_tpu_torch.distributed.worker import execute_role
from moose_tpu_torch.serde import deserialize_value, serialize_computation
from moose_tpu_torch.textual import to_textual

from test_torch_distributed import IDS, RETRIEVE_S, WAIT_S, lowered_case
from torch_parity import fixed_keys_env, prf

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def case():
    return lowered_case("secure_dot", ["threefry"])


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _endpoints():
    return {i: f"127.0.0.1:{p}" for i, p in zip(IDS, _free_ports(len(IDS)))}


def _on_threads(work):
    """``work(identity)`` for each identity on its own thread; the
    results, after every thread ended within WAIT_S."""
    results, errors = {}, {}

    def run(identity):
        try:
            results[identity] = work(identity)
        except Exception as e:  # noqa: BLE001 - asserted below
            errors[identity] = e

    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in IDS]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT_S)
    assert not any(t.is_alive() for t in threads), "a role hung"
    assert not errors, errors
    return results


def _assert_the_jax_workers_outputs(case, outputs):
    want, _ = case.want["threefry"]
    assert set(outputs) == set(want)
    for name, value in want.items():
        assert np.array_equal(np.asarray(outputs[name]), value), name
    np.testing.assert_allclose(outputs["output_0"],
                               case.args["x"] @ case.args["y"], atol=1e-4)


def test_three_workers_over_native_tcp(case):
    endpoints = _endpoints()
    nets = {i: TcpNetworking(i, endpoints, device="cpu").start()
            for i in IDS}
    try:
        with prf("threefry"), fixed_keys_env():
            results = _on_threads(lambda i: execute_role(
                case.tl, i, {}, case.args, nets[i], "tcp-1",
                timeout=WAIT_S))
    finally:
        for net in nets.values():
            net.stop()
    _assert_the_jax_workers_outputs(case, {
        k: v for r in results.values() for k, v in r["outputs"].items()})


def test_vixen_mains_over_tcp(case, tmp_path, capsys):
    from moose_tpu_torch.bin import vixen

    blob = tmp_path / "comp.bin"
    blob.write_bytes(serialize_computation(case.tl))
    args = tmp_path / "args.json"
    args.write_text(json.dumps({k: v.tolist()
                                for k, v in case.args.items()}))
    spec = ",".join(f"{i}={e}" for i, e in _endpoints().items())
    with prf("threefry"), fixed_keys_env():
        _on_threads(lambda i: vixen.main([
            str(blob), "--identity", i, "--endpoints", spec,
            "--session-id", "vixen-1", "--args", str(args),
            "--passes", "", "--device", "cpu",
            "--outputs", str(tmp_path / f"{i}.npz")]))
    outputs = {}
    for i in IDS:
        with np.load(tmp_path / f"{i}.npz") as data:
            outputs.update({k: data[k] for k in data.files})
    _assert_the_jax_workers_outputs(case, outputs)
    assert "output_0 =" in capsys.readouterr().out


def test_rudolph_filesystem_choreography(case, tmp_path):
    import logging

    from moose_tpu_torch.bin.rudolph import _launch_from_file

    (tmp_path / "comp.moose").write_text(to_textual(case.tl))
    (tmp_path / "args.json").write_text(json.dumps(
        {k: v.tolist() for k, v in case.args.items()}))
    servers, endpoints = start_local_cluster(IDS, device="cpu")
    try:
        session = tmp_path / "run.session"
        session.write_text(
            'session_id = "rudolph-1"\n'
            'arguments = "args.json"\n'
            "[computation]\n"
            'path = "comp.moose"\n'
            "[roles]\n"
            + "".join(f'{k} = "{v}"\n' for k, v in endpoints.items())
        )
        log = logging.getLogger("test-rudolph")
        outputs = {}
        with prf("threefry"), fixed_keys_env():
            for srv in servers.values():
                _launch_from_file(srv, session, log)
            for endpoint in endpoints.values():
                result = ChoreographyClient(endpoint).retrieve(
                    "rudolph-1", timeout=RETRIEVE_S)
                assert "error" not in result, result
                for name, blob in (result.get("outputs") or {}).items():
                    outputs[name] = deserialize_value(blob)
    finally:
        for srv in servers.values():
            srv.stop()
    _assert_the_jax_workers_outputs(case, outputs)


def test_rudolph_exits_0_on_sigterm(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.Popen(
        [sys.executable, "-m", "moose_tpu_torch.bin.rudolph",
         "--identity", "alice", "--port", "0", "--sessions-dir",
         str(tmp_path), "--poll-interval", "0.1", "--device", "cpu"],
        stderr=subprocess.PIPE, text=True, env=env, cwd=tmp_path)
    try:
        for line in proc.stderr:
            if "watching" in line:
                break
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=WAIT_S) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
