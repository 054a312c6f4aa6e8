"""Decrypt in the per-host layout against the JAX package, word for
word: ``aes.decrypt_host`` (the bit-sliced circuit on host bits,
``HostBitOps``) and ``aes.decrypt_rep`` (on replicated bit shares,
``RepBitOps``: every AND one ``replicated.and_bits`` with its zero
shares in the reference's order) on the inputs of tests/test_aes.py's
host and replicated tests, in sessions of one master key with pinned
nonces; config 4's eDSL AES-input graph (``AesWrapper``, a replicated
key lifted at its Input) through both runtimes' ``layout="per-host"``
under fixed keys (the runtime never lowers an AES graph itself; a
lowered Decrypt is held to the JAX package's bytes in
tests/test_torch_lowering.py)."""

import numpy as np
import torch

import jax.numpy as jnp
from moose_tpu import dtypes as jdt
from moose_tpu import values as jv
from moose_tpu.dialects import aes as jaes
from moose_tpu.runtime import LocalMooseRuntime as JaxRuntime

from moose_tpu_torch import dtypes as tdt
from moose_tpu_torch import values as tv
from moose_tpu_torch.dialects import aes as taes
from moose_tpu_torch.dialects import host as thost
from moose_tpu_torch.dialects import replicated as trep
from moose_tpu_torch.runtime import LocalMooseRuntime as PortRuntime

from test_torch_per_host_dialects import JREP, TREP, sessions
from torch_parity import (  # noqa: F401  (threefry: a fixture)
    assert_shares_equal,
    fixed_keys_env,
    graph_pair,
    threefry,
)

IDS = ["alice", "bob", "carole"]
KEY = bytes(range(16))
FRAC = 23


class _Op:
    """The Decrypt op the entry points read the return dtype from."""

    def __init__(self, dt):
        self.name = "d"
        self.signature = type("Sig", (), {
            "return_type": type("Ty", (), {"dtype": dt.fixed(14, FRAC)})})


def _aes_inputs(vals, nonce):
    """(JAX, port) host AES key (one copy per element) and ciphertext of
    ``vals`` on alice."""
    wire = taes.encrypt_fixed_array(KEY, nonce, vals, FRAC)
    key_bits = np.repeat(taes.bytes_to_bits_be(KEY)[:, None], len(vals),
                         axis=1)
    out = []
    for v, asarray in ((jv, jnp.asarray), (tv, torch.as_tensor)):
        key = v.HostAesKey(v.HostBitTensor(asarray(key_bits), "alice"),
                           "alice")
        ct = v.AesTensor(v.HostBitTensor(asarray(wire[:96]), "alice"),
                         v.HostBitTensor(asarray(wire[96:]), "alice"),
                         "alice")
        out.append((key, ct))
    return out


def test_decrypt_host_matches_the_jax_function():
    vals = np.array([1.5, -2.25, 1000.125])
    (jkey, jct), (tkey, tct) = _aes_inputs(vals, bytes([177] * 12))
    with sessions() as (js, ts):
        want = jaes.decrypt_host(js, "alice", jkey, jct, _Op(jdt))
        got = taes.decrypt_host(ts, "alice", tkey, tct, _Op(tdt))
    assert (got.integral_precision, got.fractional_precision) == (14, FRAC)
    assert_shares_equal(got.tensor, want.tensor)
    decoded = thost.fixedpoint_decode(got, "alice", tdt.float64)
    assert np.array_equal(decoded.value.numpy(), vals)


def test_decrypt_rep_matches_the_jax_function(threefry):
    vals = np.array([2.5, -0.125])
    (jkey, jct), (tkey, tct) = _aes_inputs(vals, bytes([7] * 12))
    with sessions() as (js, ts):
        js._placements = {"rep": JREP}
        ts._placements = {"rep": TREP}
        want = jaes.decrypt_rep(js, JREP, jkey, jct, _Op(jdt))
        got = taes.decrypt_rep(ts, TREP, tkey, tct, _Op(tdt))
    assert isinstance(got, tv.RepFixedTensor)
    assert_shares_equal(got.tensor, want.tensor)
    ring = trep.reveal(ts, TREP, got.tensor, "alice")
    decoded = thost.fixedpoint_decode(tv.HostFixedTensor(ring, 14, FRAC),
                                      "alice", tdt.float64)
    assert np.array_equal(decoded.value.numpy(), vals)


def test_aes_input_graph_matches_the_jax_per_host_runtime(threefry):
    """Config 4's front end (a replicated key shared at its Input, the
    ciphertext shared at Decrypt) and classifier per-host, word for word;
    the port at ``use_jit=True`` keeps an AES graph on the walk, as the
    JAX runtime's ``_auto_lower_passes`` does."""
    jc, tc = graph_pair("aes_input")
    x = np.random.default_rng(4).normal(size=(2, 2))
    nonce = bytes(range(16, 28))
    args = {"aes_data": taes.encrypt_fixed_array(KEY, nonce, x, 40),
            "aes_key": taes.bytes_to_bits_be(KEY)}
    with fixed_keys_env():
        want = JaxRuntime(IDS, layout="per-host", use_jit=False) \
            .evaluate_computation(jc, args)
        runtime = PortRuntime(IDS, layout="per-host", use_jit=True,
                              device="cpu")
        got = runtime.evaluate_computation(tc, args)
    assert runtime.last_plan["lowered"] is False
    assert list(got) == list(want)
    for name in want:
        g, w = got[name], np.asarray(want[name])
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w), name
    probs = got["output_0"]
    assert probs.shape == (2, 2) and np.all(np.isfinite(probs))
