"""The port's PRF streams against the JAX package's, word for word: K7's
``threefry-pallas`` stream (the JAX side runs its Pallas kernel in
interpret mode), the sampling entry points under both streams, the PRF
selection, the refusal of draws beyond K7's 2^32-lane counter, and the
eDSL secure dot end to end under ``threefry-pallas``.  On the CPU the
port runs the kernel's plain version; no launch counter moves."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import moose_tpu as jm
from moose_tpu.dialects import pallas_prf as jpallas
from moose_tpu.dialects import ring as jring
from moose_tpu.runtime import LocalMooseRuntime as JaxRuntime

import moose_tpu_torch as tm
from moose_tpu_torch.dialects import pallas_prf as tpallas
from moose_tpu_torch.dialects import ring as tring
from moose_tpu_torch.errors import ConfigurationError
from moose_tpu_torch.native import ring_kernels as rk
from moose_tpu_torch.runtime import LocalMooseRuntime as PortRuntime

from torch_parity import (  # noqa: F401  (fixtures)
    assert_words_equal,
    fixed_keys_env,
    prf,
    threefry,
    threefry_pallas,
)

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

IDS = ["alice", "bob", "carole"]
SEED = (0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344)
# the seed itself, and the seed with each of its four words flipped
SEEDS = [SEED] + [
    tuple(w ^ 0xFFFFFFFF if i == j else w for i, w in enumerate(SEED))
    for j in range(4)
]
# (3, 70000) crosses the JAX kernel's 65,536-lane block
WORD_SHAPES = ((), (7,), (513, 257), (3, 70000))


def _u64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


@pytest.mark.parametrize("seed", SEEDS, ids=[f"seed{i}" for i in range(5)])
@pytest.mark.parametrize("shape", WORD_SHAPES, ids=str)
def test_pallas_words_match_jax_kernel(seed, shape):
    before = dict(rk.LAUNCHES)
    got = tpallas.random_bits_u64(seed, shape, "cpu")
    want = np.asarray(
        jpallas.random_bits_u64(np.array(seed, dtype=np.uint32), shape)
    )
    assert rk.LAUNCHES == before
    assert got.dtype == torch.int64 and tuple(got.shape) == shape
    assert np.array_equal(_u64(got), want)


SAMPLE_SHAPES = ((3, 50), (3, 2, 7), (3, 129))


@pytest.mark.parametrize("impl", ("threefry", "threefry-pallas"))
@pytest.mark.parametrize("shape", SAMPLE_SHAPES, ids=str)
def test_sampling_matches_jax_under_each_stream(impl, shape):
    """Uniform ring64 and ring128 words and bits; (3, 50) and (3, 129)
    leave a bit draw a tail that does not fill a 64-bit word."""
    with prf(impl):
        for i, seed in enumerate(SEEDS[:2]):
            jseed = np.array(seed, dtype=np.uint32)
            for width in (64, 128):
                assert_words_equal(
                    tring.sample_uniform_seeded(shape, seed, width, "cpu"),
                    jring.sample_uniform_seeded(shape, jseed, width),
                    f"{impl} ring{width} seed {i}",
                )
            bits = tring.sample_bits_seeded(shape, seed, "cpu")
            jbits, _ = jring.sample_bits_seeded(shape, jseed, 64)
            assert bits.dtype == torch.uint8
            assert np.array_equal(
                bits.numpy().astype(np.uint64), np.asarray(jbits)
            ), f"{impl} bits seed {i}"


def test_pallas_and_threefry_streams_differ():
    with prf("threefry-pallas"):
        pallas = tring.sample_uniform_seeded((3, 5), SEED, 64, "cpu")[0]
    with prf("threefry"):
        default = tring.sample_uniform_seeded((3, 5), SEED, 64, "cpu")[0]
    assert not torch.equal(pallas, default)


def test_pallas_refuses_beyond_its_counter_before_allocating(monkeypatch):
    def no_alloc(*args, **kwargs):
        raise AssertionError("allocated before refusing")

    monkeypatch.setattr(torch, "arange", no_alloc)
    monkeypatch.setattr(torch, "empty", no_alloc)
    too_many = (1 << 16, (1 << 16) + 1)
    with pytest.raises(ValueError, match="2\\^32"):
        tpallas.random_bits_u64(SEED, too_many, "cpu")
    with pytest.raises(ValueError, match="2\\^32"):
        tpallas.random_bits_u8(SEED, ((64 << 32) + 1,), "cpu")
    with pytest.raises(ValueError, match="2\\^32"):
        rk.threefry_words(1, 2, (1 << 32) + 1, "threefry-pallas", "cuda")
    with prf("threefry-pallas"):
        with pytest.raises(ValueError, match="2\\^32"):
            tring.sample_uniform_seeded(too_many, SEED, 64, "cpu")
        with pytest.raises(ValueError, match="2\\^32"):
            tring.sample_uniform_seeded(((1 << 31) + 1,), SEED, 128, "cpu")


def test_prf_wrappers_refuse_bad_arguments():
    with pytest.raises(ValueError, match="layout"):
        rk.threefry_words(1, 2, 4, "rbg", "cpu")
    with pytest.raises(ValueError, match="u32"):
        rk.threefry_bits(1 << 32, 2, 4, "threefry", "cpu")
    with pytest.raises(ValueError, match="negative"):
        rk.threefry_words(1, 2, -1, "threefry", "cpu")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        rk.threefry_words(1, 2, 4, "threefry", "meta")


def test_set_prf_impl_and_require_strong_prf(threefry):
    assert tring.get_prf_impl() == "threefry"
    tring.require_strong_prf("a test")
    tring.set_prf_impl("threefry-pallas")
    assert tring.get_prf_impl() == "threefry-pallas"
    tring.require_strong_prf("a test")
    with pytest.raises(ConfigurationError, match="XLA"):
        tring.set_prf_impl("rbg")
    # the reference's aes-ctr is selected like the others (and the
    # fixture restores the previous choice)
    tring.set_prf_impl("aes-ctr")
    assert tring.get_prf_impl() == "aes-ctr"
    tring.require_strong_prf("a test")
    tring.set_prf_impl("threefry-pallas")
    with pytest.raises(ConfigurationError, match="one of"):
        tring.set_prf_impl("philox")
    # a refused choice leaves the selection as it was
    assert tring.get_prf_impl() == "threefry-pallas"


def test_prf_choice_is_read_from_the_environment_at_import():
    # one fresh process: import under threefry-pallas, then re-import
    # under rbg, which the port refuses
    code = (
        "import importlib, os\n"
        "from moose_tpu_torch.dialects import ring\n"
        "print(ring.get_prf_impl())\n"
        "os.environ['MOOSE_TPU_PRF'] = 'rbg'\n"
        "try:\n"
        "    importlib.reload(ring)\n"
        "except ring.ConfigurationError:\n"
        "    print('refused')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO,
        env=dict(os.environ, MOOSE_TPU_PRF="threefry-pallas"),
        capture_output=True, text=True, timeout=120, check=True,
    )
    assert out.stdout.split() == ["threefry-pallas", "refused"]


def test_secure_dot_bit_identical_under_threefry_pallas(threefry_pallas):
    rng = np.random.default_rng(24)
    args = {"x": rng.normal(size=(24, 24)), "y": rng.normal(size=(24, 24))}
    with fixed_keys_env():
        want = JaxRuntime(IDS, layout="stacked").evaluate_computation(
            chip_smoke.secure_dot_computation(jm, (14, 23)), args
        )["output_0"]
        before = dict(rk.LAUNCHES)
        got = PortRuntime(IDS, device="cpu").evaluate_computation(
            chip_smoke.secure_dot_computation(tm, (14, 23)), args
        )["output_0"]
        assert rk.LAUNCHES == before
        with prf("threefry"):
            other = PortRuntime(IDS, device="cpu").evaluate_computation(
                chip_smoke.secure_dot_computation(tm, (14, 23)), args
            )["output_0"]
    assert got.shape == (24, 24) and np.array_equal(got, want)
    # the stream changes the masks, and so the truncation noise
    assert not np.array_equal(got, other)
    assert np.abs(got - args["x"] @ args["y"]).max() < chip_smoke.DOT_TOL
