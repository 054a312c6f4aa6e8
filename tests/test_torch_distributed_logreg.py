"""Config 3's logistic regression (6 x 4 rows, fixed(24,40), its sigmoid
lowered to 7,335 host ops) on three port workers, held against the JAX
package's workers on the CPU: under ``MOOSE_TPU_FIXED_KEYS`` and the
``threefry`` stream the outputs and every payload on the wire over
``LocalNetworking`` (the planned scheduler, the compiled fast path with
``MOOSE_TPU_JIT_SELFCHECK=1``: its validating session, then a settled
one on the same plan with no segment pinned;
``tests/test_torch_distributed.py`` holds both schedulers on the secure
dot), and the outputs of the same lowered bytes on in-process gRPC
workers (on their own fast path), equal the JAX workers' word for
word.  A file of its own: the JAX
workers' first eager run of this graph costs 15-30 s of eager compiles
on the CPU (their legacy scheduler, as ``test_torch_distributed.py``
runs it).

The gRPC session's retrieve has a limit of its own, ``RETRIEVE_S``: the
three in-process workers run the 7,335-op graph in 6-10 s on an idle
CPU, and past ``tests/test_torch_distributed.py``'s 15 s when the CPU is
shared with other test processes (reproduced with six xdist workers of
the port's heaviest test files on two cores: "receive timed out after
15.0s")."""

import pytest

from moose_tpu_torch.distributed import worker_plan
from moose_tpu_torch.distributed.choreography import start_local_cluster
from moose_tpu_torch.distributed.networking import LocalNetworking
from moose_tpu_torch.distributed.worker import execute_role

from test_torch_distributed import (
    IDS,
    _capture,
    _env,
    _run,
    check_grpc,
    check_local,
    lowered_case,
)
from torch_parity import fixed_keys_env, prf

STREAM = "threefry"
# a retrieve's deadline for config 3's lowered graph of 7,335 host ops
RETRIEVE_S = 120.0


@pytest.fixture(scope="module")
def case():
    return lowered_case("logreg", [STREAM])


@pytest.fixture(scope="module")
def endpoints():
    """One in-process gRPC cluster of port workers on the CPU."""
    servers, endpoints = start_local_cluster(IDS, device="cpu")
    try:
        yield endpoints
    finally:
        for srv in servers.values():
            srv.stop()


def test_local_workers_equal_the_jax_workers_word_for_word(case):
    check_local(case, "logreg", STREAM, "planned")


def test_fast_path_settles_on_the_jax_workers_words(case):
    """A settled session of the fast path (one with no validating
    evaluation: every validatable segment of every role replays its
    jitted form, none pinned) on the plan ``check_local`` validated:
    its outputs and wire payloads are the JAX workers' words.  Run on
    its own, the test first validates the plan in a session of its own."""
    for _ in range(2):
        net = LocalNetworking(device="cpu")
        wire = _capture(net)
        before = worker_plan.plan_stats()["validating_evaluations"]
        with prf(STREAM), fixed_keys_env(), _env(
                MOOSE_TPU_WORKER_JIT="1", MOOSE_TPU_JIT_SELFCHECK="1"):
            results, got = _run(execute_role, case.tl, case.args, net,
                                "s-logreg")
        if worker_plan.plan_stats()["validating_evaluations"] == before:
            break
    else:
        raise AssertionError("the plans never settled")
    want_out, want_wire = case.want[STREAM]
    assert set(got) == set(want_out)
    for key, value in want_out.items():
        assert (got[key] == value).all(), key
    assert wire == want_wire
    for result in results.values():
        assert result["plan_mode"] in ("segmented", "full-jit"), result
        assert result["pinned_segments"] == []


def test_grpc_workers_equal_the_jax_workers(case, endpoints):
    check_grpc(case, endpoints, "logreg", STREAM, retrieve_s=RETRIEVE_S)
