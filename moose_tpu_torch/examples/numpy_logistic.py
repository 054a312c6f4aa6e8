"""The examples' float64 logistic regression, fitted with numpy: the
model sklearn's default ``LogisticRegression().fit`` finds (L2 penalty,
``C = 1.0``, an unpenalised intercept), by Newton's method, and the
split of ``train_test_split(test_size=..., random_state=...)``.  The
card's machine has no sklearn, so every machine runs this one path.

The model carries the attributes ``predictors.sklearn_export`` reads
(``coef_``, ``intercept_``, ``classes_``) and ``predict_proba``.
"""

import math

import numpy as np

NEWTON_STEPS = 100
NEWTON_TOL = 1e-12


class LogisticModel:
    """A binary logistic regression with sklearn's fitted attributes."""

    def __init__(self, coef, intercept):
        self.coef_ = np.asarray(coef, dtype=np.float64).reshape(1, -1)
        self.intercept_ = np.asarray(intercept, dtype=np.float64).reshape(1)
        self.classes_ = np.array([0, 1])

    def predict_proba(self, x):
        z = np.asarray(x) @ self.coef_[0] + self.intercept_[0]
        p = 1.0 / (1.0 + np.exp(-z))
        return np.stack([1.0 - p, p], axis=1)


def fit_logistic_regression(x, y, c=1.0):
    """Minimise sum(log(1 + exp(-s_i z_i))) + ||w||^2 / (2 c) over the
    weights w and an unpenalised intercept (labels 0/1, s_i = 2 y_i - 1,
    z = x w + b), by Newton steps until one moves less than
    ``NEWTON_TOL``."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    xa = np.hstack([x, np.ones((x.shape[0], 1))])
    penalty = np.full(xa.shape[1], 1.0 / c)
    penalty[-1] = 0.0
    theta = np.zeros(xa.shape[1])
    for _ in range(NEWTON_STEPS):
        p = 1.0 / (1.0 + np.exp(-(xa @ theta)))
        grad = xa.T @ (p - y) + penalty * theta
        hess = (xa.T * (p * (1.0 - p))) @ xa + np.diag(penalty)
        step = np.linalg.solve(hess, grad)
        theta -= step
        if np.abs(step).max() < NEWTON_TOL:
            break
    return LogisticModel(theta[:-1], theta[-1])


def train_test_split(n_samples, test_size, random_state):
    """(train, test) row indices as sklearn's ``train_test_split`` draws
    them for a float ``test_size``: one permutation from
    ``RandomState(random_state)``, its first ceil(test_size * n) entries
    the test rows and the rest the training rows."""
    n_test = math.ceil(test_size * n_samples)
    perm = np.random.RandomState(random_state).permutation(n_samples)
    return perm[n_test:], perm[:n_test]
