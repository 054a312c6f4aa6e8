"""The reference's aes-ctr PRF in the port (BASELINE config 4's share
generation): blake3 and ``derive_seed``, the AES-128-CTR stream and its
draw orders replayed from ``moose_tpu/crypto/prf_golden.json``, the
session's draws one by one and grouped, and whole requests, each word
for word against the JAX package under ``set_prf_impl("aes-ctr")``.

The JAX package expands aes-ctr on the host, as the port does
(``ring_kernels.aes_ctr_group``); no threefry kernel runs under it."""

import json
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import moose_tpu as jm
from moose_tpu.crypto import blake3 as jblake3
from moose_tpu.dialects import ring as jring
from moose_tpu.parallel import spmd as jspmd
from moose_tpu.predictors import from_onnx as jfrom_onnx
from moose_tpu.predictors import sklearn_export as jsk
from moose_tpu.runtime import LocalMooseRuntime as JaxRuntime

import moose_tpu_torch as tm
from moose_tpu_torch.crypto import aes_prng as tprng
from moose_tpu_torch.crypto import blake3 as tblake3
from moose_tpu_torch.dialects import aes as taes
from moose_tpu_torch.dialects import ring as tring
from moose_tpu_torch.native import ring_kernels as rk
from moose_tpu_torch.parallel import spmd as tspmd
from moose_tpu_torch.predictors import from_onnx as tfrom_onnx
from moose_tpu_torch.predictors import sklearn_export as tsk
from moose_tpu_torch.runtime import LocalMooseRuntime as PortRuntime

from torch_parity import (  # noqa: F401  (fixtures)
    aes_ctr,
    assert_words_equal,
    fixed_keys_env,
)

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

GOLDEN = json.loads(
    (REPO / "moose_tpu" / "crypto" / "prf_golden.json").read_text())
IDS = ["alice", "bob", "carole"]
MASTER = (0x01234567, 0x89ABCDEF, 0x0BADF00D, 0xDEADBEEF)


def test_blake3_equals_the_reference_and_the_official_vector():
    assert tblake3.blake3(b"").hex() == (
        "af1349b9f5f9a1a6a0404dea36dcc949"
        "9bcb25c9adc112b7cc9a93cae41f3262")
    key = bytes(range(32))
    # one block, several blocks, several chunks (1024 B each)
    for data in (b"moose", bytes(range(200)), bytes(range(256)) * 20):
        for out_len in (16, 32, 100):
            assert tblake3.blake3(data, out_len=out_len) == \
                jblake3.blake3(data, out_len=out_len)
        assert tblake3.keyed_hash(key, data) == \
            jblake3.keyed_hash(key, data)
        assert tblake3.derive_key("Derive Seed", data) == \
            jblake3.derive_key("Derive Seed", data)


def test_derive_seed_replays_the_golden_vectors():
    for vec in GOLDEN["derive_seed"]:
        got = tprng.derive_seed(bytes.fromhex(vec["key"]),
                                vec["session_id"],
                                bytes.fromhex(vec["sync_key"]))
        assert got.hex() == vec["seed"], vec


def test_keystream_and_block_boundary_replay_the_golden_vectors():
    for vec in GOLDEN["keystream"]:
        rng = tprng.AesCtrRng(bytes.fromhex(vec["seed"]))
        if vec["offset"]:
            rng.next_bytes(vec["offset"])
        assert rng.next_bytes(len(vec["bytes"]) // 2).hex() == vec["bytes"]
        # byte-sized reads give the same stream
        rng = tprng.AesCtrRng(bytes.fromhex(vec["seed"]))
        for _ in range(vec["offset"]):
            rng.next_bytes(1)
        assert rng.next_bytes(len(vec["bytes"]) // 2).hex() == vec["bytes"]
    vec = GOLDEN["block_boundary"]
    seed = bytes.fromhex(vec["seed"])
    for counter, block in enumerate((vec["block0"], vec["block1"])):
        assert taes.aes128_encrypt_block_np(
            seed, counter.to_bytes(16, "little")).hex() == block
    rng = tprng.AesCtrRng(seed)
    rng.next_bytes(vec["straddle_offset"])
    assert rng.next_bytes(len(vec["straddle_bytes"]) // 2).hex() == \
        vec["straddle_bytes"]


def test_draw_orders_and_bit_tag_replay_the_golden_vectors():
    for vec in GOLDEN["u64_draws"]:
        got = tprng.AesCtrRng(bytes.fromhex(vec["seed"])).uniform_u64(
            vec["count"])
        assert [f"{v:016x}" for v in got] == vec["values"]
    for vec in GOLDEN["u128_draws"]:
        lo, hi = tprng.AesCtrRng(bytes.fromhex(vec["seed"])).uniform_u128(
            vec["count"])
        assert [f"{v:016x}" for v in lo] == vec["lo"]
        assert [f"{v:016x}" for v in hi] == vec["hi"]
    for vec in GOLDEN["bit_draws"]:
        rng = tprng.AesCtrRng(bytes.fromhex(vec["seed"]))
        assert list(map(int, rng.bits(vec["count"]))) == vec["bits"]
        fresh = tprng.AesCtrRng(bytes.fromhex(vec["seed"]))
        fresh.next_bytes(vec["consumed_bytes"])
        assert rng.next_bytes(8) == fresh.next_bytes(8)
    vec = GOLDEN["bit_domain_tag"]
    assert list(tring._bit_domain_seed(vec["seed_words"])) == \
        vec["tagged_words"]
    # the stream's key bytes are the seed words little-endian, as the
    # JAX package lays out its uint32 seed
    words = np.asarray(vec["seed_words"], dtype=np.uint32)
    assert tring.seed_bytes(vec["seed_words"]) == words.tobytes()


def test_counter_blocks_are_little_endian_128_bit_counters():
    for first in (0, 5, (1 << 40) + 255, (1 << 64) - 4):
        got = tprng.counter_blocks(first, 4)
        for i in range(4):
            assert got[i].tobytes() == (first + i).to_bytes(16, "little")


@pytest.mark.parametrize("width", [64, 128])
def test_single_draws_equal_the_reference(aes_ctr, width):
    seed = (1, 0xFFFFFFFF, 0x12345678, 0x80000001)
    jseed = jnp.asarray(seed, dtype=jnp.uint32)
    for shape in [(5,), (3, 4), ()]:
        want = jring.sample_uniform_seeded(shape, jseed, width)
        got = tring.sample_uniform_seeded(shape, seed, width, "cpu")
        assert_words_equal(got, want, f"uniform {shape}")
        want_bits, _ = jring.sample_bits_seeded(shape, jseed, width)
        got_bits = tring.sample_bits_seeded(shape, seed, "cpu")
        assert got_bits.dtype == torch.uint8
        assert np.array_equal(got_bits.numpy(),
                              np.asarray(want_bits).astype(np.uint8))


def test_sample_group_equals_the_reference_session(aes_ctr):
    jsess = jspmd.SpmdSession(jnp.asarray(MASTER, dtype=jnp.uint32))
    want = [
        jsess.sample_bank((2, 3), 128),
        jsess.sample((4,), 64),
        jsess.sample_bit_bank((5,)),
        jsess.sample_bank((3,), 64),
        jsess.sample((2,), 128),
        jsess.sample_bit_bank((2, 2)),
    ]
    after = jsess.sample((3,), 128)
    before = dict(rk.LAUNCHES)
    drawn = rk.AES_CTR_HOST["bytes"]
    tsess = tspmd.SpmdSession(MASTER, "cpu")
    # the last three draws go to planes the caller gives
    bank64 = torch.zeros(2 + 9, dtype=torch.int64)
    lo = torch.zeros(2, dtype=torch.int64)
    hi = torch.zeros(2, dtype=torch.int64)
    bits = torch.zeros(3 * 4 + 1, dtype=torch.uint8)
    got = tsess.sample_group([
        ("bank", (2, 3), 128),
        ("sample", (4,), 64),
        ("bit_bank", (5,), None),
        ("bank", (3,), 64, ((bank64, 2), None)),
        ("sample", (2,), 128, ((lo, 0), (hi, 0))),
        ("bit_bank", (2, 2), None, (bits, 1)),
    ])
    assert got[3:] == [None, None, None]
    assert_words_equal(got[0], want[0], "bank")
    assert_words_equal(got[1], want[1], "sample")
    assert np.array_equal(got[2].numpy(), np.asarray(want[2]))
    assert_words_equal((bank64[2:].view(3, 3), None), want[3], "out bank")
    assert_words_equal((lo, hi), want[4], "out sample")
    assert np.array_equal(bits[1:].view(3, 2, 2).numpy(),
                          np.asarray(want[5]))
    # the counter ends where the draws one by one leave it
    assert tsess._counter == 6
    assert_words_equal(tsess.sample((3,), 128), after, "next draw")
    # host expansions, one a group, and no kernel's count
    assert rk.LAUNCHES["prf_aes_ctr_host"] == \
        before["prf_aes_ctr_host"] + 2
    assert {k: v for k, v in rk.LAUNCHES.items()
            if k != "prf_aes_ctr_host"} == \
        {k: v for k, v in before.items() if k != "prf_aes_ctr_host"}
    words = 2 * 3 * 6 + 4 + 3 * 3 + 2 * 2 + 2 * 3
    assert rk.AES_CTR_HOST["bytes"] - drawn == 8 * words + 15 + 12


def _binary_model(seed, features):
    rng = np.random.default_rng(seed)
    return SimpleNamespace(
        coef_=rng.normal(size=(1, features)),
        intercept_=rng.normal(size=(1,)) * 0.5,
        classes_=np.array([0, 1]),
    ), rng.normal(size=(8, features)) * 1.5


def test_secure_dot_equals_the_reference(aes_ctr):
    rng = np.random.default_rng(7)
    args = {"x": rng.normal(size=(4, 3)), "y": rng.normal(size=(3, 2))}
    with fixed_keys_env():
        want = JaxRuntime(IDS, layout="stacked", use_jit=False) \
            .evaluate_computation(chip_smoke.secure_dot_computation(jm),
                                  args)["output_0"]
        got = PortRuntime(IDS, use_jit=False, device="cpu").evaluate_computation(
            chip_smoke.secure_dot_computation(tm), args)["output_0"]
    assert np.array_equal(got, np.asarray(want))
    assert np.abs(got - args["x"] @ args["y"]).max() < chip_smoke.DOT_TOL


def test_logistic_regression_request_equals_the_reference(aes_ctr):
    model, x = _binary_model(24, 5)
    jpred = jfrom_onnx(jsk.logistic_regression_onnx(model, 5))
    tpred = tfrom_onnx(tsk.logistic_regression_onnx(model, 5))
    with fixed_keys_env():
        want = JaxRuntime(IDS, layout="stacked", use_jit=False) \
            .evaluate_computation(jpred.predictor_factory(
                jm.fixed(24, 40)), {"x": x})["output_0"]
        rk.reset_launches()
        got = PortRuntime(IDS, use_jit=False, device="cpu").evaluate_computation(
            tpred.predictor_factory(tm.fixed(24, 40)), {"x": x})["output_0"]
    assert np.array_equal(got, np.asarray(want))
    p = 1.0 / (1.0 + np.exp(-(x @ model.coef_[0] + model.intercept_[0])))
    assert np.abs(got - np.stack([1 - p, p], axis=1)).max() < \
        chip_smoke.LOGREG_TOL
    # every draw of the request was expanded on the host
    assert rk.LAUNCHES["prf_aes_ctr_host"] > 40
    assert rk.LAUNCHES["prf_threefry"] == rk.LAUNCHES[
        "prf_threefry_pallas"] == 0
    assert rk.AES_CTR_HOST["bytes"] > 0


def test_aes_ctr_is_selected_from_the_environment_at_import():
    import subprocess

    code = (
        "from moose_tpu_torch.dialects import ring\n"
        "print(ring.get_prf_impl())\n"
        "ring.require_strong_prf('a test')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, check=True, timeout=120,
        env={**__import__("os").environ, "MOOSE_TPU_PRF": "aes-ctr"},
    )
    assert out.stdout.strip() == "aes-ctr"
