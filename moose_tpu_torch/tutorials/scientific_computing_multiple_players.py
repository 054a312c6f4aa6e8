"""Use case: scientific computing with multiple players.

The port's program of ``tutorials/scientific_computing_multiple_players.py``
(the reference tutorial ``scientific-computing-multiple-players.ipynb``):
two government departments each hold a private column of data (alcohol
consumption, student grades); a data scientist wants the Pearson
correlation between them WITHOUT any party revealing its column.  The
whole statistic (means, centered products, the variance product, its
square root, and the final division) is computed on secret-shared
values under 3-party replicated secret sharing; only the single
correlation coefficient is revealed.  Every party's tensors live on the
card unless ``--device cpu``.

Run locally (one process simulating all parties):

    python -m moose_tpu_torch.tutorials.scientific_computing_multiple_players

Run across three comet worker processes over gRPC (the reference's
deployment; the workers are spawned for you):

    python -m moose_tpu_torch.tutorials.scientific_computing_multiple_players --grpc
"""

# no `from __future__ import annotations`: the eDSL reads the
# pm.Argument annotations of the traced functions as objects
import argparse

import numpy as np

import moose_tpu_torch as pm
from moose_tpu_torch.examples import parse_args

FIXED = pm.fixed(24, 40)
LIMIT = 1e-2

# One placement per real-world party.  The replicated placement is the
# "virtual encrypted machine" spanned by the three of them: values that
# move onto it are secret-shared, computation on it runs on shares.
pub_health_dpt = pm.host_placement(name="pub_health_dpt")
education_dpt = pm.host_placement(name="education_dpt")
data_scientist = pm.host_placement(name="data_scientist")
encrypted_government = pm.replicated_placement(
    name="encrypted_government",
    players=[pub_health_dpt, education_dpt, data_scientist],
)

# the gRPC run's parties: the workers hold no storage, so the columns
# come in as arguments
alice = pm.host_placement("alice")
bob = pm.host_placement("bob")
carole = pm.host_placement("carole")
rep = pm.replicated_placement("rep", players=[alice, bob, carole])


def generate_synthetic_correlated_data(n_samples):
    """Synthetic (alcohol, grades) columns with a known anticorrelation
    (same construction as the reference tutorial)."""
    mu = np.array([10.0, 0.0])
    r = np.array([[3.40, -2.75], [-2.75, 5.50]])
    rng = np.random.default_rng(12)
    x = rng.multivariate_normal(mu, r, size=n_samples)
    return x[:, 0:1], x[:, 1:2]


def pearson_correlation_coefficient(x, y):
    """corr = sum((x-mx)(y-my)) / sqrt(sum((x-mx)^2) * sum((y-my)^2)),
    every op below runs on secret shares (sqrt is the secure
    2^(log2/2) protocol, div the Goldschmidt protocol)."""
    x_mean = pm.mean(x, 0)
    y_mean = pm.mean(y, 0)
    stdv_x = pm.sum(pm.square(pm.sub(x, x_mean)))
    stdv_y = pm.sum(pm.square(pm.sub(y, y_mean)))
    corr_num = pm.sum(pm.mul(pm.sub(x, x_mean), pm.sub(y, y_mean)))
    corr_denom = pm.sqrt(pm.mul(stdv_x, stdv_y))
    return pm.div(corr_num, corr_denom)


@pm.computation
def multiparty_correlation():
    # Each department loads ITS OWN data from ITS OWN storage, in
    # plaintext, then casts to the fixed-point encoding the protocol
    # computes over.
    with pub_health_dpt:
        alcohol = pm.load("alcohol_data", dtype=pm.float64)
        alcohol = pm.cast(alcohol, dtype=FIXED)

    with education_dpt:
        grades = pm.load("grades_data", dtype=pm.float64)
        grades = pm.cast(grades, dtype=FIXED)

    # Crossing from a host placement into the replicated placement
    # secret-shares the values; nothing in this block ever exists in
    # the clear on any single machine.
    with encrypted_government:
        correlation = pearson_correlation_coefficient(alcohol, grades)

    # Only the final scalar is revealed, and only to the data scientist.
    with data_scientist:
        correlation = pm.cast(correlation, dtype=pm.float64)
        correlation = pm.save("correlation", correlation)

    return correlation


@pm.computation
def corr_inputs(
    a: pm.Argument(placement=alice, dtype=pm.float64),
    g: pm.Argument(placement=bob, dtype=pm.float64),
):
    with alice:
        af = pm.cast(a, dtype=FIXED)
    with bob:
        gf = pm.cast(g, dtype=FIXED)
    with rep:
        c = pearson_correlation_coefficient(af, gf)
    with carole:
        out = pm.cast(c, dtype=pm.float64)
    return out


def run_local(alcohol, grades, device):
    from moose_tpu_torch.runtime import LocalMooseRuntime

    runtime = LocalMooseRuntime(
        identities=["pub_health_dpt", "education_dpt", "data_scientist"],
        storage_mapping={
            "pub_health_dpt": {"alcohol_data": alcohol},
            "education_dpt": {"grades_data": grades},
        },
        device=device,
    )
    runtime.set_default()
    multiparty_correlation()
    return np.asarray(
        runtime.read_value_from_storage("data_scientist", "correlation")
    )


def run_grpc(alcohol, grades, device):
    """The same statistic across three comet worker processes over gRPC,
    the reference's deployment shape.  The workers are spawned here for
    convenience; in a real deployment each party runs its own."""
    from moose_tpu_torch.dialects import ring
    from moose_tpu_torch.distributed.spawn import comet_workers
    from moose_tpu_torch.runtime import GrpcMooseRuntime

    # workers that exchange shares draw their masks from a real PRF
    prev = ring.get_prf_impl()
    ring.set_prf_impl("threefry")
    try:
        with comet_workers(device) as endpoints:
            runtime = GrpcMooseRuntime(endpoints, device=device)
            runtime.set_default()
            outputs, _timings = runtime.evaluate_computation(
                corr_inputs, {"a": alcohol, "g": grades}
            )
    finally:
        ring.set_prf_impl(prev)
    (val,) = outputs.values()
    return np.asarray(val)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--grpc", action="store_true",
                        help="run across 3 spawned comet workers")
    parser.add_argument("--samples", type=int, default=100)
    args = parse_args(parser, argv)

    alcohol, grades = generate_synthetic_correlated_data(args.samples)
    if args.grpc:
        moose_corr = run_grpc(alcohol, grades, args.device)
    else:
        moose_corr = run_local(alcohol, grades, args.device)

    np_corr = np.corrcoef(alcohol.ravel(), grades.ravel())[1, 0]
    value = float(np.ravel(moose_corr)[0])
    print(f"Correlation with moose_tpu: {value:.6f}")
    print(f"Correlation with numpy:     {np_corr:.6f}")
    if not abs(value - np_corr) < LIMIT:
        raise AssertionError(f"correlation {value} against {np_corr}")
    print("OK — secure result matches the plaintext statistic")
    return value


if __name__ == "__main__":
    main()
