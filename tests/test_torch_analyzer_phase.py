"""``chip_smoke.py``'s phase 21, the static analyzer on the main path,
at a small size on the CPU: the trainers' gate over phase 20's graphs
and its MSA701 refusal, the stacked draw oracle (the shape-only replay
against a request's ledger), the per-host draw oracle, and the strict
compile served from bytes with the prancer CLI and the phase timings."""

import sys
from pathlib import Path

import numpy as np
import torch

from moose_tpu_torch.dialects import ring
from moose_tpu_torch.native import ring_kernels as rk
from moose_tpu_torch.runtime import LocalMooseRuntime

import moose_tpu_torch as tm

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402


def test_phase21_runs_small_on_the_cpu(monkeypatch):
    for name, value in (("SESSION_FEATURES", 6), ("SESSION_BATCH", 16),
                        ("SESSION_STEPS", 2), ("LOGREG_ROWS", 16),
                        ("LOGREG_FEATURES", 5)):
        monkeypatch.setattr(chip_smoke, name, value)
    rng = np.random.default_rng(chip_smoke.SEED)
    classifier = chip_smoke.logistic_regression(rng, 5)
    logreg = classifier.predictor_factory()
    assert ring.get_prf_impl() == "threefry"
    record, launches = chip_smoke.run_analyzer(
        torch, rk, tm, LocalMooseRuntime, classifier, logreg, rng,
        device="cpu")
    assert record["gate"]["refused_with"] == ["MSA701"]
    assert set(record["gate"]["graphs"]) == {"init", "epoch", "export"}
    assert record["stacked_oracle"]["events"] > 0
    assert record["per_host_oracle"]["draws"] > 0
    assert record["strict_compile"]["prancer_records"] > 0
    assert "MSA805" in record["strict_compile"]["diagnostics_by_rule"]
    assert set(launches) == {"analyzer_stacked_request",
                             "analyzer_per_host_request",
                             "analyzer_strict_compiled"}
