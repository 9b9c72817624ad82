"""Stop rules and epsilon schedules against the JAX package on the CPU.

A stop rule stops a run and moves no draw: the port keys a round's Philox
counter by the run's ``MAX_ROUNDS`` (the round stride), and a
``min_acceptance_rate`` lowers only the loop's round bound. So the toy's
generations that the rule does not stop are bit-identical with and without
it (pop 500, seed 0, ``MedianEpsilon``: the trail 1.0609, 0.4937, 0.2379,
0.1204, the toy drawing its noise through K4's mean-only kernel), as in the
JAX package, whose runs do not depend on the rule until it stops them.

Beside it, the schedules and rules the port admits, each in both packages
(the toy, pop 500): ``ConstantEpsilon`` and ``ListEpsilon`` give equal
trails (they are the schedule, seeds 0 and 1) and posterior means over
seeds 0-31 within 0.05 of each other (a seed's mean has an sd of about
0.045 in the port and 0.087 in the JAX package under ``ConstantEpsilon(0.3)``
at pop 500, so 32 seeds put the gap's standard error near 0.017; both
packages' means lie near the exact ABC posterior mean, 0.781 at 0.3);
``max_total_nr_simulations`` and ``min_acceptance_rate`` stop each package
at the generation its own counts give (the first whose cumulative
evaluations reach the cap; no generation before the last below the rate).
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import pyabc_tpu as jpt  # noqa: E402
import pyabc_tpu_torch as tpt  # noqa: E402
from pyabc_tpu_torch.models import gaussian  # noqa: E402

torch.set_num_threads(1)

NOISE_SD, X_OBS, POP = 0.5, 1.0, 500
PROBE_TRAIL = [1.0609, 0.4937, 0.2379, 0.1204]
#: the seeds whose posterior means the schedules' cells compare
SCHEDULE_SEEDS = tuple(range(32))


def _run(pkg, seed=0, eps=None, **run_kw):
    mod = jpt if pkg == "jax" else tpt
    kw = dict(population_size=POP, eps=eps or mod.MedianEpsilon(), seed=seed)
    if pkg == "jax":
        @jpt.JaxModel.from_function(["theta"], name="gauss")
        def model(key, theta):
            return {"x": theta[0] + NOISE_SD * jax.random.normal(key)}

        abc = jpt.ABCSMC(model, jpt.Distribution(theta=jpt.RV("norm", 0.0,
                                                              1.0)),
                         jpt.PNormDistance(p=2), **kw)
    else:
        abc = tpt.ABCSMC(gaussian.make_mean_only_model(noise_sd=NOISE_SD),
                         gaussian.mean_only_prior(), tpt.PNormDistance(p=2),
                         device="cpu", **kw)
    abc.new("sqlite://", {"x": X_OBS})
    return abc.run(**run_kw)


def _pops(h):
    return h.get_all_populations().query("t >= 0")


def _mean(h):
    df, w = h.get_distribution()
    return float(np.sum(df["theta"] * w))


def test_min_acceptance_rate_moves_no_draw():
    """The roadmap's probe: with the rule (0.05) and without it, every
    generation the rule did not stop is bit-identical, and the first four
    epsilons are the probe's trail."""
    free = _run("port", max_nr_populations=6)
    ruled = _run("port", max_nr_populations=6, min_acceptance_rate=0.05)
    assert 4 <= ruled.max_t <= free.max_t
    for h in (free, ruled):
        eps = _pops(h)["epsilon"].to_numpy()
        assert np.round(eps[:4], 4).tolist() == PROBE_TRAIL
    for t in range(ruled.max_t + 1):
        a, wa = free.get_distribution(t=t)
        b, wb = ruled.get_distribution(t=t)
        np.testing.assert_array_equal(a.to_numpy(), b.to_numpy())
        np.testing.assert_array_equal(wa, wb)


@pytest.mark.parametrize("kind", ["constant", "list"])
def test_schedules_give_equal_trails(kind):
    trails, means = {}, {}
    for pkg in ("port", "jax"):
        mod = jpt if pkg == "jax" else tpt
        runs = []
        for seed in SCHEDULE_SEEDS:
            if kind == "constant":
                eps, gens = mod.ConstantEpsilon(0.3), 4
            else:
                eps, gens = mod.ListEpsilon([1.0, 0.5, 0.3, 0.2]), 6
            runs.append(_run(pkg, seed, eps=eps, max_nr_populations=gens))
        trails[pkg] = [_pops(h)["epsilon"].to_numpy().tolist()
                       for h in runs[:2]]
        means[pkg] = np.mean([_mean(h) for h in runs])
    want = [0.3] * 4 if kind == "constant" else [1.0, 0.5, 0.3, 0.2]
    for pkg in trails:
        for trail in trails[pkg]:
            np.testing.assert_allclose(trail, want, rtol=1e-7)
    assert means["port"] == pytest.approx(means["jax"], abs=0.05)


def _stop_by_total(samples, cap):
    """The generation a cap on the total evaluations stops at: the first
    whose cumulative evaluations reach it."""
    return int(np.argmax(np.cumsum(samples) >= cap))


@pytest.mark.parametrize("rule", ["total", "rate"])
def test_stop_rules_stop_where_the_counts_say(rule):
    for pkg in ("port", "jax"):
        for seed in (0, 1):
            if rule == "total":
                h = _run(pkg, seed, max_nr_populations=12,
                         max_total_nr_simulations=20000)
                samples = _pops(h)["samples"].to_numpy()
                assert np.cumsum(samples)[-1] >= 20000
                assert h.max_t == _stop_by_total(samples, 20000), pkg
            else:
                # the rule stops after the first generation whose rate falls
                # below it; in both packages a generation that would need
                # more than n / rate evaluations does not complete (its
                # round budget), so the one before it is the last
                h = _run(pkg, seed, max_nr_populations=12,
                         min_acceptance_rate=0.2)
                rates = POP / _pops(h)["samples"].to_numpy()
                assert h.max_t < 11, pkg
                assert (rates[:-1] >= 0.2).all(), pkg
