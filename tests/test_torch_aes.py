"""The AES path of the port (BASELINE config 4) against the JAX package:
the host AES-128 and the wire format, the bit-sliced circuit on
party-stacked bit shares, ``decrypt_stacked``, the replicated-key Input
lift, the Bristol evaluator and the ``AesWrapper`` predictors.

Everything that draws randomness is compared word for word with
``moose_tpu``'s stacked layout (``use_jit=False``) under fixed keys.  The
JAX reference's eager AES circuit costs about 25 s the first time a
process runs it, so each PRF stream's reference runs once, in a
module-scoped fixture, at a ciphertext of 2 elements; the later JAX runs
of the same shapes reuse its compiled ops."""

import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import moose_tpu as jm
from moose_tpu import dtypes as jdt
from moose_tpu import values as jvalues
from moose_tpu.dialects import aes as jaes
from moose_tpu.dialects import bristol as jbristol
from moose_tpu.dialects import stacked as jstacked
from moose_tpu.edsl import tracer as jtracer
from moose_tpu.execution.session import EagerSession as JaxEagerSession
from moose_tpu.parallel import spmd as jspmd
from moose_tpu.predictors import AesWrapper as JAesWrapper
from moose_tpu.predictors import LinearClassifier as JLinearClassifier
from moose_tpu.predictors import sklearn_export as jsk
from moose_tpu.runtime import LocalMooseRuntime as JaxRuntime

import moose_tpu_torch as tm
from moose_tpu_torch import dtypes as tdt
from moose_tpu_torch import values as tvalues
from moose_tpu_torch import errors as terrors
from moose_tpu_torch.dialects import aes as taes
from moose_tpu_torch.dialects import ring as tring
from moose_tpu_torch.dialects import bristol as tbristol
from moose_tpu_torch.dialects import stacked as tstacked
from moose_tpu_torch.edsl import tracer as ttracer
from moose_tpu_torch.parallel import spmd as tspmd
from moose_tpu_torch.parallel import spmd_math as tsm
from moose_tpu_torch.predictors import AesWrapper as TAesWrapper
from moose_tpu_torch.predictors import LinearClassifier as TLinearClassifier
from moose_tpu_torch.predictors import sklearn_export as tsk
from moose_tpu_torch.runtime import LocalMooseRuntime as PortRuntime

from torch_parity import fixed_keys_env, prf, threefry  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

IDS = ["alice", "bob", "carole"]
PRECISION = (14, 23)
FIPS_KEY = bytes.fromhex("000102030405060708090a0b0c0d0e0f")
FIPS_PT = bytes.fromhex("00112233445566778899aabbccddeeff")
FIPS_CT = "69c4e0d86a7b0430d8cdb78070b4c55a"
MASTER = (0x01234567, 0x89ABCDEF, 0x0BADF00D, 0xDEADBEEF)
KEY = bytes(range(16))
NONCE = bytes([7] * 12)
# 2 elements: one row of two features, the shape every JAX run shares
FEATURES = np.random.default_rng(1).normal(size=(1, 2))
WEIGHTS = np.random.default_rng(2).normal(size=(2, 1))


def _placements(pm):
    alice = pm.host_placement("alice")
    bob = pm.host_placement("bob")
    carole = pm.host_placement("carole")
    rep = pm.replicated_placement("rep", players=[alice, bob, carole])
    return alice, bob, carole, rep


def secure_score(pm):
    """``examples/aes_inference.py``'s graph, also revealing the
    decrypted features."""
    alice, bob, carole, rep = _placements(pm)
    fx = pm.fixed(*PRECISION)

    @pm.computation
    def graph(aes_data: pm.Argument(alice, vtype=pm.AesTensorType(dtype=fx)),
              aes_key: pm.Argument(rep, vtype=pm.AesKeyType()),
              w: pm.Argument(bob, dtype=pm.float64)):
        with rep:
            x = pm.decrypt(aes_key, aes_data)
        with bob:
            wf = pm.cast(w, dtype=fx)
        with rep:
            score = pm.sigmoid(pm.dot(x, wf))
        with carole:
            out = pm.cast(score, dtype=pm.float64)
            plain = pm.cast(x, dtype=pm.float64)
        return out, plain

    return graph


def score_args():
    wire = taes.encrypt_fixed_array(KEY, NONCE, FEATURES, PRECISION[1])
    return {"aes_data": wire, "aes_key": taes.bytes_to_bits_be(KEY),
            "w": WEIGHTS}


def _decrypt_op(dtype):
    return SimpleNamespace(
        name="d", signature=SimpleNamespace(
            return_type=SimpleNamespace(dtype=dtype)))


def jax_decrypt_words(wire):
    """The JAX package's ``decrypt_stacked`` of a host key: all parties'
    share words."""
    sess = jspmd.SpmdSession(jnp.asarray(MASTER, dtype=jnp.uint32))
    key_bits = jnp.asarray(jaes.bytes_to_bits_be(KEY))
    key = jvalues.HostAesKey(jvalues.HostBitTensor(key_bits, "alice"),
                             "alice")
    ct = jvalues.AesTensor(
        jvalues.HostBitTensor(jnp.asarray(wire[:96]), "alice"),
        jvalues.HostBitTensor(jnp.asarray(wire[96:]), "alice"), "alice")
    out = jaes.decrypt_stacked(sess, _decrypt_op(jdt.fixed(*PRECISION)),
                               key, ct)
    return np.asarray(out.tensor.lo), np.asarray(out.tensor.hi)


def port_decrypt(wire):
    sess = tspmd.SpmdSession(MASTER, "cpu")
    key_bits = torch.as_tensor(taes.bytes_to_bits_be(KEY))
    key = tvalues.HostAesKey(tvalues.HostBitTensor(key_bits, "alice"),
                             "alice")
    ct = tvalues.AesTensor(
        tvalues.HostBitTensor(torch.as_tensor(wire[:96]), "alice"),
        tvalues.HostBitTensor(torch.as_tensor(wire[96:]), "alice"), "alice")
    return taes.decrypt_stacked(sess, _decrypt_op(tdt.fixed(*PRECISION)),
                                key, ct), sess


@pytest.fixture(scope="module", params=["threefry", "threefry-pallas"])
def reference(request):
    """One stream's JAX runs: the secure_score graph and decrypt_stacked
    of a host key."""
    stream = request.param
    args = score_args()
    with prf(stream), fixed_keys_env():
        graph = JaxRuntime(IDS, layout="stacked", use_jit=False) \
            .evaluate_computation(secure_score(jm), args)
        words = jax_decrypt_words(args["aes_data"])
    return stream, args, graph, words


def test_host_aes_matches_fips197_and_the_reference():
    assert taes.aes128_encrypt_block_np(FIPS_KEY, FIPS_PT).hex() == FIPS_CT
    assert np.array_equal(taes.SBOX, jaes.SBOX)
    assert taes.RCON == jaes.RCON
    rng = np.random.default_rng(5)
    for _ in range(4):
        key, block = rng.bytes(16), rng.bytes(16)
        assert taes.aes128_encrypt_block_np(key, block) == \
            jaes.aes128_encrypt_block_np(key, block)


@pytest.mark.parametrize("shape,frac", [
    ((), 23), ((3,), 23), ((2, 4), 40),
    # 300 elements: the index flips the nonce's last two bytes
    ((300,), 23), ((3, 100), 40),
])
def test_encrypt_fixed_array_equals_the_reference(shape, frac):
    rng = np.random.default_rng(sum(shape) + frac)
    values = rng.normal(size=shape) * 100.0
    if values.size > 3:
        flat = values.reshape(-1)
        # halfway cases (round half to even), a negative zero, and
        # values past 2^63 once scaled
        flat[:4] = [2.5 / (1 << frac), -0.0, 2.0 ** 30, -(2.0 ** 33) - 0.5]
    nonce = bytes(rng.integers(0, 256, size=12, dtype=np.uint8))
    nonce = nonce[:8] + b"\x00\x00\x00\xfe"
    got = taes.encrypt_fixed_array(KEY, nonce, values, frac)
    want = jaes.encrypt_fixed_array(KEY, nonce, values, frac)
    assert got.dtype == np.uint8 and got.shape == (224,) + shape
    assert np.array_equal(got, want)


def test_encrypt_fixed_array_wire_is_built_in_one_pass():
    # config 4's 1024 x 100 wire array in seconds (the reference's
    # element-by-element loop takes about a minute)
    import time

    x = np.random.default_rng(0).normal(size=(1024, 100))
    t0 = time.perf_counter()
    wire = taes.encrypt_fixed_array(KEY, NONCE, x, 40)
    assert time.perf_counter() - t0 < 20.0
    assert wire.shape == (224, 1024, 100)
    # the last element's nonce carries its index
    tail = np.packbits(wire[64:96, -1, -1]).tobytes()
    assert int.from_bytes(tail, "big") == \
        int.from_bytes(NONCE[-4:], "big") ^ (1024 * 100 - 1)


def test_stacked_circuit_matches_fips197(threefry):
    sess = tspmd.SpmdSession(MASTER, "cpu")
    B = taes.StackedBitOps(sess)
    kb = tsm.share_bits(sess, torch.as_tensor(
        taes.bytes_to_bits_be(FIPS_KEY)).reshape(128, 1))
    pb = tsm.share_bits(sess, torch.as_tensor(
        taes.bytes_to_bits_be(FIPS_PT)).reshape(128, 1))
    out = taes.aes128_encrypt_block(B, kb, pb)
    got = np.packbits(tsm.reveal_bits(out).numpy()[:, 0]).tobytes()
    assert got.hex() == FIPS_CT
    # two shared bit banks and 80 ANDs, one bank each
    assert sess._counter == 2 + 80


def test_decrypt_stacked_equals_the_reference(reference):
    stream, args, _, (want_lo, want_hi) = reference
    with prf(stream):
        out, sess = port_decrypt(args["aes_data"])
    lo, hi = (t.numpy().view(np.uint64) for t in (out.tensor.lo,
                                                  out.tensor.hi))
    assert lo.shape == want_lo.shape == (3, 2, 1, 2)
    assert np.array_equal(lo, want_lo) and np.array_equal(hi, want_hi)
    # the key, the nonce and the ciphertext shared, 80 ANDs, b2a's draws
    assert sess._counter > 83
    x = tspmd.reveal(out.tensor)
    plain = tring.fixedpoint_decode(*x, PRECISION[1]).numpy()
    assert np.array_equal(plain, np.round(FEATURES * 2.0 ** 23) / 2 ** 23)


def test_secure_score_graph_equals_the_reference(reference):
    stream, args, want, _ = reference
    with prf(stream), fixed_keys_env():
        got = PortRuntime(IDS, device="cpu").evaluate_computation(
            secure_score(tm), args)
    assert list(got) == list(want) == ["output_0", "output_1"]
    for name in got:
        assert np.array_equal(got[name], np.asarray(want[name]))
    plain = 1.0 / (1.0 + np.exp(-(FEATURES @ WEIGHTS)))
    assert np.abs(got["output_0"] - plain).max() < 5e-3


def test_replicated_key_input_lift_equals_the_reference(threefry):
    key_bits = taes.bytes_to_bits_be(KEY)
    wire = taes.encrypt_fixed_array(KEY, NONCE, FEATURES, PRECISION[1])
    jcomp = jtracer.trace(
        chip_smoke.decrypt_computation(jm, jm.fixed(*PRECISION)))
    tcomp = ttracer.trace(
        chip_smoke.decrypt_computation(tm, tm.fixed(*PRECISION)))
    jsess = jstacked.StackedSession(np.asarray(MASTER, dtype=np.uint32))
    tsess = tstacked.StackedSession(MASTER, "cpu")
    jop, top = jcomp.operations["aes_key"], tcomp.operations["aes_key"]
    want = jstacked.lift_aes_input(jsess, jcomp, jop, key_bits, "rep")
    got = tstacked.lift_aes_input(tsess, tcomp, top, key_bits, "rep", "cpu")
    assert isinstance(got, taes.StackedAesKey)
    assert np.array_equal(got.bits.arr.numpy(), np.asarray(want.bits.arr))
    # the key's bit bank claimed the first nonce index, at the lift
    assert tsess.spmd._counter == 1
    assert np.array_equal(tsm.reveal_bits(got.bits).numpy(), key_bits)
    # a ciphertext stays on its host, unshared
    jop, top = jcomp.operations["aes_data"], tcomp.operations["aes_data"]
    ct = tstacked.lift_aes_input(tsess, tcomp, top, wire, "alice", "cpu")
    jct = jstacked.lift_aes_input(jsess, jcomp, jop, wire, "alice")
    assert isinstance(ct, tvalues.AesTensor) and ct.plc == "alice"
    assert np.array_equal(ct.nonce_bits.value.numpy(),
                          np.asarray(jct.nonce_bits.value))
    assert np.array_equal(ct.cipher_bits.value.numpy(),
                          np.asarray(jct.cipher_bits.value))
    assert tsess.spmd._counter == 1
    with pytest.raises(terrors.KernelError, match="224"):
        tstacked.lift_aes_input(tsess, tcomp, top, wire[:100], "alice",
                                "cpu")


ADDER_2BIT = """\
3 7
2 2 2
1 3

2 1 0 2 4 XOR
2 1 1 3 5 AND
2 1 4 5 6 XOR
"""


def test_bristol_adder_on_shares_equals_the_reference_host_eval(threefry):
    circ = tbristol.parse_circuit(ADDER_2BIT)
    jcirc = jbristol.parse_circuit(ADDER_2BIT)
    assert (circ.num_gates, circ.num_wires, circ.input_widths,
            circ.output_widths) == (jcirc.num_gates, jcirc.num_wires,
                                    jcirc.input_widths, jcirc.output_widths)
    x_np = np.array([[1, 0, 1, 0], [1, 1, 0, 0]], np.uint8)
    y_np = np.array([[0, 1, 1, 0], [1, 0, 1, 1]], np.uint8)
    sess = tspmd.SpmdSession(MASTER, "cpu")
    x = tsm.share_bits(sess, torch.as_tensor(x_np))
    y = tsm.share_bits(sess, torch.as_tensor(y_np))
    (out,) = tbristol.evaluate(circ, taes.StackedBitOps(sess), [x, y])
    got = tsm.reveal_bits(out).numpy()
    jsess = JaxEagerSession()
    B = jaes.HostBitOps(jsess, "alice")
    (want,) = jbristol.evaluate(jcirc, B, [
        jvalues.HostBitTensor(jnp.asarray(x_np), "alice"),
        jvalues.HostBitTensor(jnp.asarray(y_np), "alice"),
    ])
    assert np.array_equal(got, np.asarray(want.value))
    assert np.array_equal(got[1], x_np[1] & y_np[1])
    with pytest.raises(terrors.MalformedComputationError):
        tbristol.parse_circuit("1 3\n1 1\n1 1\n\n2 1 0 1 2 NAND\n")


def _wrapped_classifier(package):
    rng = np.random.default_rng(11)
    model = SimpleNamespace(coef_=rng.normal(size=(1, 2)),
                            intercept_=rng.normal(size=(1,)) * 0.5,
                            classes_=np.array([0, 1]))
    if package == "jax":
        proto = jsk.logistic_regression_onnx(model, 2)
        return JAesWrapper(JLinearClassifier).from_onnx(proto), model
    proto = tsk.logistic_regression_onnx(model, 2)
    return TAesWrapper(TLinearClassifier).from_onnx(proto), model


@pytest.fixture(scope="module")
def wrapper_reference():
    """The JAX package's AES LinearClassifier, under threefry: its own
    predictor (the linear map) and config 4's whole inference."""
    wire = taes.encrypt_fixed_array(KEY, NONCE, FEATURES, PRECISION[1])
    args = {"aes_data": wire, "aes_key": taes.bytes_to_bits_be(KEY)}
    model, _ = _wrapped_classifier("jax")
    runtime = JaxRuntime(IDS, layout="stacked", use_jit=False)
    with prf("threefry"), fixed_keys_env():
        logits = runtime.evaluate_computation(
            model.aes_predictor_factory(jm.fixed(*PRECISION)), args)
        probs = runtime.evaluate_computation(
            chip_smoke.aes_inference_computation(
                jm, model, jm.fixed(*PRECISION)), args)
    return args, logits["output_0"], probs["output_0"]


def test_aes_wrapper_classifier_equals_the_reference(wrapper_reference):
    args, want_logits, want_probs = wrapper_reference
    model, sk = _wrapped_classifier("port")
    assert type(model).__name__ == "AesLinearClassifier"
    assert isinstance(model, TLinearClassifier)
    with prf("threefry"), fixed_keys_env():
        runtime = PortRuntime(IDS, device="cpu")
        logits = runtime.evaluate_computation(
            model(tm.fixed(*PRECISION)), args)["output_0"]
        probs = runtime.evaluate_computation(
            chip_smoke.aes_inference_computation(
                tm, model, tm.fixed(*PRECISION)), args)["output_0"]
    # the wrapper's own predictor is the linear map, as the reference's
    z = FEATURES @ sk.coef_[0] + sk.intercept_[0]
    assert np.array_equal(logits, np.asarray(want_logits))
    assert np.abs(logits - np.stack([-z, z], axis=1)).max() < 5e-3
    # config 4's inference: the classifier's whole forward pass
    assert np.array_equal(probs, np.asarray(want_probs))
    p = 1.0 / (1.0 + np.exp(-z))
    assert np.abs(probs - np.stack([1 - p, p], axis=1)).max() < \
        chip_smoke.LOGREG_TOL


def _host_decrypt(pm):
    alice, bob, carole, rep = _placements(pm)

    @pm.computation
    def host_decrypt(
        aes_data: pm.Argument(alice, vtype=pm.AesTensorType(
            dtype=pm.fixed(*PRECISION))),
        aes_key: pm.Argument(alice, vtype=pm.AesKeyType()),
    ):
        with alice:
            x = pm.decrypt(aes_key, aes_data)
        with bob:
            out = pm.cast(x, dtype=pm.float64)
        return out

    return host_decrypt


def test_aes_inputs_outside_the_stacked_layout_run_per_host(threefry):
    """A host Decrypt is not the stacked layout's: the runtime runs it on
    the per-host layout, as the JAX runtime does, with the JAX runtime's
    words (the element count of every JAX run here, 2)."""
    host_decrypt = _host_decrypt(tm)
    assert tstacked.unsupported_ops(ttracer.trace(host_decrypt)) == \
        [("HostPlacement", "Decrypt")]
    args = {"aes_data": taes.encrypt_fixed_array(KEY, NONCE, FEATURES,
                                                 PRECISION[1]),
            "aes_key": taes.bytes_to_bits_be(KEY)}
    runtime = PortRuntime(IDS, device="cpu")
    got = runtime.evaluate_computation(host_decrypt, args)["output_0"]
    want = JaxRuntime(IDS, use_jit=False).evaluate_computation(
        _host_decrypt(jm), args)["output_0"]
    assert runtime.last_plan["layout"] == "per-host"
    assert np.array_equal(got, np.asarray(want))
    assert np.array_equal(got, np.round(FEATURES * 2.0 ** PRECISION[1])
                          / 2.0 ** PRECISION[1])
    assert tstacked.supports(ttracer.trace(chip_smoke.decrypt_computation(
        tm, tm.fixed(*PRECISION))))
