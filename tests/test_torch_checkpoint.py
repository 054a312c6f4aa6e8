"""The port's secret-shared checkpoint store and ring limb planes against
the JAX package's, on the CPU.

``moose_tpu_torch.training.CheckpointStore`` goes through the five cases
of ``tests/test_training.py``'s checkpoint protocol (commit, query, pin,
retention; a torn commit; a tampered generation; a stale CURRENT and a
torn manifest; the fixed-keys tag), as one parametrised test that holds
both packages' stores to the same answers; a generation committed by
either package is read and validated by the other, and the two write the
same bytes.  ``values.ring_to_limbs``/``limbs_to_ring`` round trip at
ring64 and ring128, top bit set included, and give the JAX package's
limb planes.  No JAX computation runs here: each case takes well under
a second."""

import json
import shutil

import numpy as np
import pytest
import torch

from moose_tpu import storage as jstorage
from moose_tpu.errors import CheckpointError as JaxCheckpointError
from moose_tpu.training import checkpoint as jcheckpoint
from moose_tpu.values import HostRingTensor as JaxRing
from moose_tpu.values import limbs_to_ring as jlimbs_to_ring
from moose_tpu.values import ring_to_limbs as jring_to_limbs

from moose_tpu_torch import flight as tflight
from moose_tpu_torch import metrics as tmetrics
from moose_tpu_torch import storage as tstorage
from moose_tpu_torch.errors import CheckpointError
from moose_tpu_torch.training import checkpoint as tcheckpoint
from moose_tpu_torch.values import HostRingTensor, limbs_to_ring, \
    ring_to_limbs

from torch_parity import rand_words, to_jax, to_port

PACKAGES = {
    "jax": (jcheckpoint.CheckpointStore, jstorage.FilesystemStorage,
            JaxCheckpointError),
    "port": (tcheckpoint.CheckpointStore, tstorage.FilesystemStorage,
             CheckpointError),
}


# -- tests/test_training.py:64-196, the same steps in either package -----


def _commit_query_pin_retention(tmp_path, store_cls, fs_cls, error):
    backing = fs_cls(str(tmp_path))
    store = store_cls(backing, party="alice", retain=2)

    with pytest.raises(error):
        store.load("ckpt/model#s0")  # nothing committed yet

    for epoch, fill in ((0, 1), (1, 2), (2, 3)):
        store["ckpt/model#s0"] = np.full((2, 3), fill, dtype=np.uint64)
        store["ckpt/model#s1"] = np.full((2, 3), fill + 10, np.uint64)
        out = store.commit(epoch, expected=[
            "ckpt/model#s0", "ckpt/model#s1",
        ])
        assert out["epoch"] == epoch and not out["idempotent"]

    q = store.query()
    # retention = 2 distinct epochs: epoch 0 pruned
    assert q["epochs"] == [1, 2] and q["latest"] == 2
    assert np.asarray(store.load("ckpt/model#s0"))[0, 0] == 3

    # pinned reads resolve the pinned epoch, durably across instances
    store.pin(1)
    assert np.asarray(store.load("ckpt/model#s0"))[0, 0] == 2
    reopened = store_cls(backing, party="alice")
    assert reopened.query()["pin"] == 1
    assert np.asarray(reopened.load("ckpt/model#s0"))[0, 0] == 2
    reopened.pin(None)
    assert np.asarray(reopened.load("ckpt/model#s0"))[0, 0] == 3

    # staged writes are invisible until commit
    reopened["ckpt/model#s0"] = np.zeros((2, 3), np.uint64)
    assert np.asarray(reopened.load("ckpt/model#s0"))[0, 0] == 3

    # idempotent commit retry (ack lost, nothing staged)
    reopened.discard_staged()
    assert reopened.commit(2)["idempotent"]

    # non-checkpoint keys pass through to the backing store
    reopened["plain"] = np.arange(3.0)
    assert "plain" in backing
    np.testing.assert_array_equal(backing.load("plain"), np.arange(3.0))


def _torn_commit_rejected(tmp_path, store_cls, fs_cls, error):
    store = store_cls(fs_cls(str(tmp_path)), party="alice")
    store["ckpt/model#s0"] = np.ones((2, 2), np.uint64)
    with pytest.raises(error, match="torn commit"):
        store.commit(0, expected=["ckpt/model#s0", "ckpt/model#s1"])
    with pytest.raises(error, match="nothing staged"):
        store_cls(fs_cls(str(tmp_path / "empty")), party="a").commit(0)


def _tampered_generation_falls_back(tmp_path, store_cls, fs_cls, error):
    backing = fs_cls(str(tmp_path))
    store = store_cls(backing, party="alice")
    store["ckpt/model#s0"] = np.full((2, 2), 7, np.uint64)
    store.commit(0, expected=["ckpt/model#s0"])
    store["ckpt/model#s0"] = np.full((2, 2), 8, np.uint64)
    store.commit(1, expected=["ckpt/model#s0"])

    # tamper with the newest generation's array behind the manifest
    backing.save("_ckpt/gen-00000001/ckpt/model#s0",
                 np.full((2, 2), 99, np.uint64))

    fresh = store_cls(backing, party="alice")
    assert fresh.query()["epochs"] == [0]  # tampered epoch 1 rejected
    # CURRENT still points at gen 1: reads fall back to the previous
    # valid generation
    assert np.asarray(fresh.load("ckpt/model#s0"))[0, 0] == 7


def _stale_current_and_torn_manifest(tmp_path, store_cls, fs_cls, error):
    backing = fs_cls(str(tmp_path))
    store = store_cls(backing, party="alice")
    store["ckpt/model#s0"] = np.full((1,), 5, np.uint64)
    store.commit(0, expected=["ckpt/model#s0"])
    store["ckpt/model#s0"] = np.full((1,), 6, np.uint64)
    store.commit(1, expected=["ckpt/model#s0"])

    # torn manifest on the newest generation (truncated mid-write)
    backing.save(
        "_ckpt/gen-00000001/MANIFEST",
        np.frombuffer(b'{"format": 1, "epo', dtype=np.uint8).copy(),
    )
    fresh = store_cls(backing, party="alice")
    assert fresh.query()["epochs"] == [0]
    assert np.asarray(fresh.load("ckpt/model#s0"))[0] == 5

    # stale CURRENT: a pointer to a generation that no longer exists
    backing.save("_ckpt/CURRENT", np.frombuffer(json.dumps(
        {"format": 1, "generation": 42, "epoch": 9}).encode(),
        dtype=np.uint8).copy())
    assert np.asarray(
        store_cls(backing, party="alice").load("ckpt/model#s0"))[0] == 5


def _fixed_keys_discipline_mismatch(tmp_path, store_cls, fs_cls, error,
                                    monkeypatch):
    backing = fs_cls(str(tmp_path))
    monkeypatch.setenv("MOOSE_TPU_FIXED_KEYS", "tag-a")
    store = store_cls(backing, party="alice")
    store["ckpt/model#s0"] = np.ones((1,), np.uint64)
    store.commit(0, expected=["ckpt/model#s0"])

    # resuming under a different determinism tag would void the
    # bit-exact resume: the generation is rejected, typed
    monkeypatch.setenv("MOOSE_TPU_FIXED_KEYS", "tag-b")
    fresh = store_cls(backing, party="alice")
    assert fresh.query()["epochs"] == []
    with pytest.raises(error):
        fresh.load("ckpt/model#s0")

    # no tag at all (production randomness) accepts any generation
    monkeypatch.delenv("MOOSE_TPU_FIXED_KEYS")
    assert store_cls(backing, party="alice").query()["epochs"] == [0]


CASES = {
    "commit_query_pin_retention": _commit_query_pin_retention,
    "torn_commit_rejected": _torn_commit_rejected,
    "tampered_generation_falls_back": _tampered_generation_falls_back,
    "stale_current_and_torn_manifest": _stale_current_and_torn_manifest,
    "fixed_keys_discipline_mismatch": _fixed_keys_discipline_mismatch,
}


@pytest.mark.parametrize("package", sorted(PACKAGES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_checkpoint_store_protocol_cases(tmp_path, monkeypatch, case,
                                         package):
    monkeypatch.delenv("MOOSE_TPU_FIXED_KEYS", raising=False)
    extra = ({"monkeypatch": monkeypatch}
             if case == "fixed_keys_discipline_mismatch" else {})
    CASES[case](tmp_path, *PACKAGES[package], **extra)


# -- a generation crosses between the packages --------------------------


def _commit_two_epochs(store_cls, fs_cls, root):
    store = store_cls(fs_cls(str(root)), party="bob")
    rng = np.random.default_rng(3)
    arrays = []
    for epoch in (0, 1):
        staged = {
            "ckpt/logreg/w#s0": rng.integers(
                0, 1 << 64, size=(2, 3, 1), dtype=np.uint64),
            "ckpt/logreg/w#s1": rng.integers(
                0, 1 << 64, size=(2, 3, 1), dtype=np.uint64),
        }
        for key, value in staged.items():
            store[key] = value
        store.commit(epoch, expected=sorted(staged),
                     meta={"model": "ckpt/logreg"})
        arrays.append(staged)
    return arrays


@pytest.mark.parametrize("writer,reader", (("jax", "port"), ("port", "jax")))
def test_a_generation_written_by_one_package_reads_in_the_other(
        tmp_path, monkeypatch, writer, reader):
    monkeypatch.setenv("MOOSE_TPU_FIXED_KEYS", "cross-package")
    arrays = _commit_two_epochs(*PACKAGES[writer][:2], tmp_path)
    store_cls, fs_cls, _ = PACKAGES[reader]
    store = store_cls(fs_cls(str(tmp_path)), party="bob")
    assert store.query()["epochs"] == [0, 1]
    for key, value in arrays[1].items():
        got = np.asarray(store.load(key))
        assert got.dtype == np.uint64 and np.array_equal(got, value)
    store.pin(0)
    for key, value in arrays[0].items():
        assert np.array_equal(np.asarray(store.load(key)), value)
    # and the reader commits the next generation on top of the writer's
    store.pin(None)
    for key, value in arrays[0].items():
        store[key] = value
    assert store.commit(2, expected=sorted(arrays[0]))["generation"] == 2
    again = PACKAGES[writer][0](PACKAGES[writer][1](str(tmp_path)),
                                party="bob")
    assert again.query()["epochs"] == [1, 2]


def test_both_packages_write_the_same_bytes(tmp_path, monkeypatch):
    monkeypatch.setenv("MOOSE_TPU_FIXED_KEYS", "same-bytes")
    for name, (store_cls, fs_cls, _) in PACKAGES.items():
        _commit_two_epochs(store_cls, fs_cls, tmp_path / name)
    files = sorted(p.relative_to(tmp_path / "jax")
                   for p in (tmp_path / "jax").rglob("*") if p.is_file())
    assert files == sorted(
        p.relative_to(tmp_path / "port")
        for p in (tmp_path / "port").rglob("*") if p.is_file())
    assert any("MANIFEST" in str(f) for f in files)
    for f in files:
        assert (tmp_path / "jax" / f).read_bytes() == \
            (tmp_path / "port" / f).read_bytes(), f


def test_checkpoint_records_the_reference_s_events_and_metrics(tmp_path):
    before = tmetrics.REGISTRY.value(
        "moose_tpu_training_checkpoint_commits_total", party="carole")
    store = tcheckpoint.CheckpointStore(
        tstorage.FilesystemStorage(str(tmp_path)), party="carole")
    store["ckpt/m#s0"] = np.ones((1,), np.uint64)
    store.commit(0)
    assert tmetrics.REGISTRY.value(
        "moose_tpu_training_checkpoint_commits_total",
        party="carole") == before + 1
    events = [e for e in tflight.get_recorder().events()
              if e.get("kind") == "checkpoint_committed"
              and e.get("party") == "carole"]
    assert events and events[-1]["keys"] == 1
    # a torn copy of the store's directory is rejected with the
    # reference's reason
    shutil.copytree(tmp_path, tmp_path.parent / "torn")
    (tmp_path.parent / "torn" / "_ckpt" / "gen-00000000" /
     "MANIFEST.npy").write_bytes(b"torn")
    torn = tcheckpoint.CheckpointStore(
        tstorage.FilesystemStorage(str(tmp_path.parent / "torn")),
        party="carole")
    assert torn.query()["epochs"] == []
    assert any(e.get("kind") == "checkpoint_invalid"
               and e.get("reason") == "torn"
               for e in tflight.get_recorder().events())


def test_retention_below_two_is_refused():
    with pytest.raises(CheckpointError, match=">= 2"):
        tcheckpoint.CheckpointStore({}, retain=1)
    assert tcheckpoint.CKPT_FORMAT == jcheckpoint.CKPT_FORMAT == 1


# -- ring words as limb planes -------------------------------------------


@pytest.mark.parametrize("width", (64, 128))
@pytest.mark.parametrize("shape", ((2, 3), (5,), ()), ids=str)
def test_ring_limbs_round_trip_as_the_jax_package_writes_them(width, shape):
    rng = np.random.default_rng(width + len(shape))
    pair = rand_words(rng, shape, width)
    # the top bit set in every word of the first row, and extremes
    if shape:
        pair[0].reshape(-1)[:2] = (np.uint64(1 << 63), np.uint64(2**64 - 1))
        if pair[1] is not None:
            pair[1].reshape(-1)[:1] = np.uint64(1 << 63)
    value = HostRingTensor(*to_port(pair), width, "alice")
    limbs = ring_to_limbs(value)
    want = np.asarray(jring_to_limbs(JaxRing(*to_jax(pair), width, "alice")))
    assert limbs.dtype == np.uint64 and limbs.shape == want.shape
    assert limbs.shape == ((1 if width == 64 else 2),) + shape
    assert np.array_equal(limbs, want)
    back = limbs_to_ring(limbs, width, "bob", "cpu")
    assert back.plc == "bob" and back.width == width
    assert back.lo.dtype == torch.int64 and back.shape == shape
    assert torch.equal(back.lo, value.lo)
    assert (back.hi is None) == (width == 64)
    if width == 128:
        assert torch.equal(back.hi, value.hi)
    # the JAX package reads the port's planes back to the same words
    jback = jlimbs_to_ring(limbs, width, "bob")
    assert np.array_equal(np.asarray(jback.lo).astype(np.uint64), pair[0])


def test_limbs_to_ring_refuses_the_wrong_limb_count():
    with pytest.raises(ValueError, match="leading axis 2"):
        limbs_to_ring(np.zeros((1, 3), np.uint64), 128, "a", "cpu")
    with pytest.raises(ValueError, match="leading axis 1"):
        limbs_to_ring(np.zeros((2, 3), np.uint64), 64, "a", "cpu")


def test_limbs_to_ring_copies_a_read_only_buffer():
    words = np.frombuffer(np.arange(6, dtype=np.uint64).tobytes(),
                          dtype=np.uint64).reshape(2, 3)
    assert not words.flags.writeable
    ring = limbs_to_ring(words, 128, "a", "cpu")
    ring.lo.add_(1)  # the caller's buffer stays as it was
    assert words[0, 0] == 0
