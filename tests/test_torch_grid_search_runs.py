"""Whole runs with GridSearchCV (K17) in both packages on the CPU.

Three configurations of the JAX suite, each run by the JAX package and by
the port over the same seeds: the toy (``tests/test_fused.py:722-737``:
pop 300, grid 0.5, 1, 2, cv 3, 4 generations), the list schedule
(``tests/test_population_strategy.py:384-410``: 200, 260, 150, 220, grid
0.25, 1, 2.25, cv 5) and the tractable pair with two GridSearchCVs
(``tests/test_fused.py:941-970``: pop 500, cv 4, 5 generations). Each
package is held to the JAX suite's rules; the port's seed means sit beside
the JAX package's within tolerances its random streams (Philox against
threefry) justify: the toy's posterior-mean seed means within 0.1 (a seed's
mean moves by about 0.03, so 4 seeds' means differ by about 0.02), epsilon
trails within 25 % generation by generation (the JAX suite's own rule for
the pair), the pair's P(m = 0) within 0.15 (the JAX suite's tolerance
against the exact value).
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import pyabc_tpu as jpt  # noqa: E402
from pyabc_tpu.models import model_selection as jmsel  # noqa: E402
from pyabc_tpu.storage.history import History as JHistory  # noqa: E402
import pyabc_tpu_torch as tpt  # noqa: E402
from pyabc_tpu_torch.models import gaussian  # noqa: E402
from pyabc_tpu_torch.models import model_selection as tmsel  # noqa: E402

torch.set_num_threads(1)

NOISE_SD, X_OBS = 0.5, 1.0
POST_MU = gaussian.conjugate_posterior(X_OBS, noise_sd=NOISE_SD)[0]
TOY_SEEDS = (1, 2, 3, 4)
SCHEDULE = (200, 260, 150, 220)
PAIR_X = 0.7


def _grid(mod, scalings, cv):
    return mod.GridSearchCV(mod.MultivariateNormalTransition(),
                            {"scaling": list(scalings)}, cv=cv)


def _toy(pkg, seed, population_size=300, scalings=(0.5, 1.0, 2.0), cv=3,
         gens=4, db="sqlite://", fused_generations=8):
    mod = jpt if pkg == "jax" else tpt
    kw = dict(population_size=population_size, eps=mod.MedianEpsilon(),
              seed=seed, fused_generations=fused_generations,
              transitions=_grid(mod, scalings, cv))
    if pkg == "jax":
        @jpt.JaxModel.from_function(["theta"], name="gauss")
        def model(key, theta):
            return {"x": theta[0] + NOISE_SD * jax.random.normal(key)}

        abc = jpt.ABCSMC(model, jpt.Distribution(theta=jpt.RV("norm", 0.0,
                                                              1.0)),
                         jpt.PNormDistance(p=2), **kw)
        assert abc._fused_chunk_capable()
    else:
        abc = tpt.ABCSMC(gaussian.make_mean_only_model(noise_sd=NOISE_SD),
                         gaussian.mean_only_prior(), tpt.PNormDistance(p=2),
                         device="cpu", **kw)
    abc.new(db, {"x": X_OBS})
    return abc.run(max_nr_populations=gens)


def _mean(h, m=0):
    df, w = h.get_distribution(m)
    return float(np.sum(df["theta"] * w))


def _eps(h):
    return h.get_all_populations().query("t >= 0")["epsilon"].to_numpy()


def _counts(h):
    s = h.get_nr_particles_per_population()
    return [int(v) for v in s[s.index >= 0]]


@pytest.fixture(scope="module")
def toy_runs():
    return {pkg: [_toy(pkg, s) for s in TOY_SEEDS] for pkg in ("port", "jax")}


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_toy_meets_the_jax_rules(toy_runs, pkg):
    """``test_fused_gridsearch_transition_runs_and_recovers_posterior``:
    the fused path, the posterior mean within 0.3, epsilon falling."""
    for h in toy_runs[pkg]:
        assert h.get_telemetry(2).get("fused_chunk")
        assert _mean(h) == pytest.approx(POST_MU, abs=0.3)
        assert (np.diff(_eps(h)) < 0).all()


def test_toy_agrees_with_jax_and_records_its_winners(toy_runs):
    port, jax_ = toy_runs["port"], toy_runs["jax"]
    assert np.mean([_mean(h) for h in port]) == pytest.approx(
        np.mean([_mean(h) for h in jax_]), abs=0.1)
    np.testing.assert_allclose(np.mean([_eps(h) for h in port], axis=0),
                               np.mean([_eps(h) for h in jax_], axis=0),
                               rtol=0.25)
    for h in port:
        chosen = [h.get_telemetry(t)["gridsearch_scaling"]
                  for t in range(h.n_populations)]
        assert set(chosen) <= {0.5, 1.0, 2.0}


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_list_schedule_counts_follow_the_schedule(pkg, tmp_path):
    """``test_fused_gridsearch_list_population``: the counts are the
    schedule; the port's db opens in the JAX package's History with the
    same counts; the two packages' posterior means within 0.3 (that test's
    rule between its fused and host runs)."""
    db = f"sqlite:///{tmp_path / 'grid_list.db'}"
    h = _toy(pkg, 31, population_size=(jpt if pkg == "jax" else tpt)
             .ListPopulationSize(list(SCHEDULE)), scalings=(0.25, 1.0, 2.25),
             cv=5, gens=len(SCHEDULE), db=db, fused_generations=3)
    assert _counts(h) == list(SCHEDULE)
    if pkg == "port":
        assert _counts(JHistory(db)) == list(SCHEDULE)
        other = _toy("jax", 31, population_size=jpt.ListPopulationSize(
            list(SCHEDULE)), scalings=(0.25, 1.0, 2.25), cv=5,
            gens=len(SCHEDULE), fused_generations=3)
        assert _mean(h) == pytest.approx(_mean(other), abs=0.3)
    assert _mean(h) == pytest.approx(POST_MU, abs=0.3)


def _pair(pkg, seed=15):
    mod, msel = (jpt, jmsel) if pkg == "jax" else (tpt, tmsel)
    models, priors, analytic = msel.tractable_pair()
    kw = {} if pkg == "jax" else {"device": "cpu"}
    abc = mod.ABCSMC(models, priors, mod.PNormDistance(p=2),
                     population_size=500, eps=mod.MedianEpsilon(), seed=seed,
                     fused_generations=4,
                     transitions=[_grid(mod, (0.5, 1.0, 2.0), 4),
                                  _grid(mod, (0.5, 1.0, 2.0), 4)], **kw)
    if pkg == "jax":
        assert abc._fused_chunk_capable()
    abc.new("sqlite://", {"x": PAIR_X})
    return abc.run(max_nr_populations=5), analytic(PAIR_X)


@pytest.fixture(scope="module")
def pair_runs():
    return {pkg: _pair(pkg) for pkg in ("port", "jax")}


def _p0(h):
    return float(h.get_model_probabilities(h.max_t)["p"].get(0, 0.0))


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_pair_meets_the_jax_rules(pair_runs, pkg):
    """``test_fused_multimodel_gridsearchcv``: P(m = 0) within 0.15 of the
    exact, the winning model's posterior mean within 0.3 of the conjugate
    one."""
    h, truth = pair_runs[pkg]
    assert h.get_telemetry(3).get("fused_chunk")
    assert _p0(h) == pytest.approx(truth[0], abs=0.15)
    post_var = 1.0 / (1 / 1.0 ** 2 + 1 / 0.6 ** 2)
    assert _mean(h) == pytest.approx(post_var * PAIR_X / 0.6 ** 2, abs=0.3)


def test_pair_agrees_with_jax(pair_runs):
    """P(m = 0) within 0.15 of the JAX package's, epsilon trails within
    25 %, and each model's winning scaling in the grid."""
    (h, _t), (jh, _jt) = pair_runs["port"], pair_runs["jax"]
    assert h.n_populations == jh.n_populations == 5
    assert _p0(h) == pytest.approx(_p0(jh), abs=0.15)
    np.testing.assert_allclose(_eps(h), _eps(jh), rtol=0.25)
    for t in range(1, 5):
        chosen = h.get_telemetry(t)["gridsearch_scaling"]
        assert len(chosen) == 2 and set(chosen) <= {0.5, 1.0, 2.0}
