"""``tests/test_torch_training_session.py``'s MLP case: an
``MLPSGDTrainer`` (4 hidden units, 1 step an epoch) trained by the port's
``TrainingSession`` over ``LocalTrainingCluster``, init and two epochs
under ``threefry`` and fixed keys, commits every party's ``#s0``/``#s1``
words and exports the weights the JAX package's session does, within
1e-3 of ``reference_epoch``.  Its JAX run compiles shapes the logistic
regression's do not, so it runs in a file of its own, on another test
worker."""

import pytest

from test_torch_training_session import (  # noqa: F401  (fixtures)
    EPOCHS,
    _jax_run,
    check_init_and_two_epochs,
    fixed_keys,
    threefry,
)
from torch_parity import fixed_keys_env, prf


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX package's MLP run, init and two epochs, under threefry and
    fixed keys."""
    root = tmp_path_factory.mktemp("jax_training_mlp")
    with prf("threefry"), fixed_keys_env():
        return {("mlp", 1): _jax_run(root / "mlp", 1, EPOCHS, kind="mlp")}


@pytest.mark.parametrize("kind,steps", (("mlp", 1),))
def test_init_and_two_epochs_match_the_jax_package(runs, tmp_path, threefry,
                                                   fixed_keys, kind, steps):
    check_init_and_two_epochs(runs, tmp_path, kind, steps)
