"""The range analysis (MSA7xx) held against the JAX package's on its
dynamic oracle, on the CPU.

Every test function of ``tests/test_range_oracle.py`` runs again with its
analysis calls mirrored (``tests/torch_analysis_mirror.py``): each
predicted interval, range report and diagnostic of the port's analyzer on
the same graph, carried across as bytes, equals the JAX package's
exactly (float64 on both sides: bit for bit, no tolerance), while the
JAX test checks its measured values against the prediction.  The
trainers' build-time gate the JAX graphs pass at their trace is held
equal too (``lint_check`` is mirrored wherever the JAX package calls
it).
"""

import pytest

import test_range_oracle as jax_range_oracle
from torch_analysis_mirror import cases, mirror, run_case


@pytest.mark.parametrize("name,params", cases(jax_range_oracle))
def test_range_oracle_case_matches_port(name, params, request, monkeypatch):
    mirror(monkeypatch, jax_range_oracle)
    assert run_case(jax_range_oracle, name, params, request) > 0
