"""Whole runs under a listed or adaptive population size: the port against
the JAX package's own adaptive-n rules and runs on the CPU.

The Gaussian toy of the JAX suite's ``TestAdaptiveNFused`` (start 150,
mean_cv 0.5, n in [20, 600], 5 bootstraps) runs in both packages over
seeds 1-4; the tractable pair and the ODE family run over several models;
a list of sizes is stored exactly and reads back in the JAX package's
History; the syncs a generation are those of a constant n; segmented
early reject and noisy ABC take an adaptive n too; and what stays unported
raises with its ROADMAP item.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import pyabc_tpu as jpt  # noqa: E402
from pyabc_tpu.models import gillespie as jg  # noqa: E402
from pyabc_tpu.populationstrategy import (  # noqa: E402
    AdaptivePopulationSize as JAdaptive)
from pyabc_tpu.storage.history import History as JHistory  # noqa: E402
import pyabc_tpu_torch as tpt  # noqa: E402
from pyabc_tpu_torch.inference.context import DeviceContext  # noqa: E402
from pyabc_tpu_torch.kernels.bootstrap_cv import n_probes  # noqa: E402
from pyabc_tpu_torch.models import gaussian  # noqa: E402
from pyabc_tpu_torch.models import gillespie as tg  # noqa: E402
from pyabc_tpu_torch.models import model_selection as msel  # noqa: E402

torch.set_num_threads(1)

NOISE_SD, X_OBS = 0.5, 1.0
POST_MU = gaussian.conjugate_posterior(X_OBS, noise_sd=NOISE_SD)[0]
SEEDS = (1, 2, 3, 4)
APS = dict(start_nr_particles=150, mean_cv=0.5, min_population_size=20,
           max_population_size=600, n_bootstrap=5)


def _counts(h):
    s = h.get_nr_particles_per_population()
    return [int(v) for v in s[s.index >= 0]]


def _mean(h, m=0):
    df, w = h.get_distribution(m)
    return float(np.sum(df["theta"] * w))


def _port_toy(seed, aps, gens=5, **kw):
    abc = tpt.ABCSMC(gaussian.make_mean_only_model(noise_sd=NOISE_SD),
                     gaussian.mean_only_prior(), tpt.PNormDistance(p=2),
                     population_size=aps, eps=tpt.MedianEpsilon(), seed=seed,
                     fused_generations=3, device="cpu", **kw)
    abc.new("sqlite://", {"x": X_OBS})
    return abc, abc.run(max_nr_populations=gens)


def _jax_toy(seed):
    @jpt.JaxModel.from_function(["theta"], name="gauss")
    def model(key, theta):
        return {"x": theta[0] + NOISE_SD * jax.random.normal(key)}

    aps = JAdaptive(**APS)
    abc = jpt.ABCSMC(model, jpt.Distribution(theta=jpt.RV("norm", 0.0, 1.0)),
                     jpt.PNormDistance(p=2), population_size=aps,
                     eps=jpt.MedianEpsilon(), seed=seed, fused_generations=3)
    abc.new("sqlite://", {"x": X_OBS})
    return aps, abc.run(max_nr_populations=5)


@pytest.fixture(scope="module")
def toy_runs():
    """Both packages' adaptive toy over SEEDS: {seed: (n trail, posterior
    mean, the strategy's mirrored n)} per package."""
    port, ref = {}, {}
    for seed in SEEDS:
        aps = tpt.AdaptivePopulationSize(**APS)
        _abc, h = _port_toy(seed, aps)
        port[seed] = (_counts(h), _mean(h), aps.nr_particles, h)
        j_aps, jh = _jax_toy(seed)
        ref[seed] = (_counts(jh), _mean(jh), j_aps.nr_particles, jh)
    return port, ref


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_adaptive_toy_meets_the_jax_rules(toy_runs, pkg, seed):
    """``tests/test_population_strategy.py:277-299``: n0 == 150, n moves,
    20 <= n <= 600, the mirrored n inside the bounds, and the posterior
    mean within 0.35 of the analytic one (both packages)."""
    ns, mu, mirrored, _h = toy_runs[0 if pkg == "port" else 1][seed]
    assert len(ns) == 5 and ns[0] == 150
    assert any(n != 150 for n in ns[1:])
    assert all(20 <= n <= 600 for n in ns)
    assert 20 <= mirrored <= 600
    assert mu == pytest.approx(POST_MU, abs=0.35)


def test_adaptive_toy_first_move_agrees_with_jax(toy_runs):
    """n1 moves the same way off the start size in both packages on every
    seed, and the 4-seed means of n1 agree within three standard errors
    of their difference (from the seeds' spread in both) plus one
    particle for the integer bisection."""
    port, ref = toy_runs
    n1_port = np.array([port[s][0][1] for s in SEEDS], float)
    n1_jax = np.array([ref[s][0][1] for s in SEEDS], float)
    assert (np.sign(n1_port - 150) == np.sign(n1_jax - 150)).all()
    se = np.sqrt(n1_port.var(ddof=1) / len(SEEDS)
                 + n1_jax.var(ddof=1) / len(SEEDS))
    assert abs(n1_port.mean() - n1_jax.mean()) <= 3 * se + 1


def test_adaptive_toy_telemetry_and_mirror(toy_runs):
    """Each generation's telemetry holds its n and the device's next n;
    n_next is the next generation's n, and the last generation keeps its
    own (K16 does not run after the run's last generation)."""
    for seed in SEEDS:
        ns, _mu, mirrored, h = toy_runs[0][seed]
        tel = [h.get_telemetry(t) for t in range(len(ns))]
        assert [x["n_target"] for x in tel] == ns
        nxt = [x["n_next"] for x in tel]
        assert nxt[:-1] == ns[1:] and nxt[-1] == ns[-1] == mirrored
        # K16's probes that did work and the CV at max_n: one probe when
        # that CV misses the target (n goes to max_n), else the bisection
        assert "k16_probes" not in tel[-1]
        for x in tel[:-1]:
            assert 1 <= x["k16_probes"] <= n_probes(20, 600)
            assert x["k16_cv_max"] > 0
            missed = x["k16_cv_max"] > APS["mean_cv"]
            assert missed == (x["k16_probes"] == 1)
            if missed:
                assert x["n_next"] == 600


def test_k16_skipped_after_the_last_generation(monkeypatch):
    calls = []
    orig = DeviceContext.bootstrap_n

    def counting(self, *a, **k):
        calls.append(a[2])
        return orig(self, *a, **k)

    monkeypatch.setattr(DeviceContext, "bootstrap_n", counting)
    _abc, h = _port_toy(2, tpt.AdaptivePopulationSize(**APS), gens=4)
    assert h.max_t == 3 and calls == [0, 1, 2]


def test_adaptive_n_keeps_the_sync_budget():
    """One counter read a round and one fetch a chunk, as at a constant n:
    the n rides the round's read and K16's answer the chunk's fetch."""
    for aps in (tpt.AdaptivePopulationSize(**APS),
                tpt.ConstantPopulationSize(150)):
        abc, h = _port_toy(3, aps, gens=5)
        by = abc.sync_ledger.summary()["by_kind"]
        rounds = sum(g["rounds"] for g in abc.generation_log)
        chunks = len({g["chunk_index"] for g in abc.generation_log})
        assert set(by) == {"round_counters", "chunk_fetch"}
        assert by["chunk_fetch"] == chunks == 2
        # the calibration's rounds are the only other counter reads
        assert 1 <= by["round_counters"] - rounds <= 2
        assert all(g["syncs"] == g["rounds"] for g in abc.generation_log)


def test_tractable_pair_under_adaptive_n():
    """``test_fused_adaptive_n_multimodel``'s config (the pair, start 150,
    n in [100, 600], seed 23): n moves and stays in its bounds, and the
    model probability of model 0 is within 0.3 of the exact one."""
    models, priors, analytic = msel.tractable_pair()
    aps = tpt.AdaptivePopulationSize(
        start_nr_particles=150, mean_cv=0.5, min_population_size=100,
        max_population_size=600, n_bootstrap=5)
    abc = tpt.ABCSMC(models, priors, tpt.PNormDistance(p=2),
                     population_size=aps, eps=tpt.MedianEpsilon(), seed=23,
                     fused_generations=3, device="cpu")
    abc.new("sqlite://", {"x": 0.7})
    h = abc.run(max_nr_populations=5)
    ns = _counts(h)
    assert any(n != 150 for n in ns[1:])
    assert all(100 <= n <= 600 for n in ns)
    probs = h.get_model_probabilities(h.max_t)["p"]
    assert float(probs.get(0, 0.0)) == pytest.approx(analytic(0.7)[0],
                                                     abs=0.3)


def test_ode_family_under_adaptive_n():
    """Config 5's three models at a small cap: K16 weights the models' CVs
    by their probabilities; the trail stays in bounds, each n_next is the
    next n, and the model probabilities sum to 1."""
    models, priors, _ts = msel.ode_family()
    aps = tpt.AdaptivePopulationSize(start_nr_particles=120, mean_cv=0.2,
                                     min_population_size=60,
                                     max_population_size=300, n_bootstrap=4)
    abc = tpt.ABCSMC(models, priors, tpt.PNormDistance(p=2),
                     population_size=aps, eps=tpt.MedianEpsilon(), seed=0,
                     device="cpu")
    abc.new("sqlite://", msel.observed_ode_family(seed=0, true_model=1))
    h = abc.run(max_nr_populations=4)
    ns = _counts(h)
    tel = [h.get_telemetry(t) for t in range(len(ns))]
    assert len(ns) == 4 and ns[0] == 120
    assert all(60 <= n <= 300 for n in ns)
    assert [x["n_next"] for x in tel[:-1]] == ns[1:]
    p = h.get_model_probabilities(h.max_t)["p"]
    assert float(p.sum()) == pytest.approx(1.0, abs=1e-9)


SIZES = [500, 1000, 2000, 1000, 500]


def test_list_population_size_counts_and_jax_history(tmp_path):
    """The counts equal the schedule exactly, the run stops at the list's
    end, and the db opens in the JAX package's History with the same
    counts and populations."""
    db = f"sqlite:///{tmp_path / 'list.db'}"
    abc = tpt.ABCSMC(gaussian.make_mean_only_model(noise_sd=NOISE_SD),
                     gaussian.mean_only_prior(), tpt.PNormDistance(p=2),
                     population_size=tpt.ListPopulationSize(SIZES),
                     eps=tpt.MedianEpsilon(), seed=1, fused_generations=2,
                     device="cpu")
    abc.new(db, {"x": X_OBS})
    h = abc.run(max_nr_populations=9)
    assert _counts(h) == SIZES
    assert [g["n"] for g in abc.generation_log] == SIZES
    jh = JHistory(db)
    assert _counts(jh) == SIZES
    for t in range(len(SIZES)):
        df, w = h.get_distribution(0, t)
        jdf, jw = jh.get_distribution(0, t)
        assert len(df) == len(jdf) == SIZES[t]
        np.testing.assert_allclose(w, jw, rtol=1e-12)
    assert _mean(h) == pytest.approx(POST_MU, abs=0.2)
    assert h.get_telemetry(2)["n_target"] == 2000
    assert "n_next" not in h.get_telemetry(2)


def test_segmented_early_reject_under_adaptive_n():
    """Under a fixed p-norm the populations stay bit-identical with early
    reject on and off, so K16 sees the same fits and picks the same n."""
    small = dict(n_leaps=100, n_obs=20)
    obs = {k: np.asarray(v) for k, v in jg.observed_birth_death(
        segments=5, **small).items()}
    runs = []
    for early in ("auto", False):
        aps = tpt.AdaptivePopulationSize(start_nr_particles=64, mean_cv=0.3,
                                         min_population_size=32,
                                         max_population_size=128,
                                         n_bootstrap=4)
        abc = tpt.ABCSMC(tg.make_birth_death_model(segments=5, **small),
                         tg.birth_death_prior(), tpt.PNormDistance(p=2),
                         population_size=aps, eps=tpt.MedianEpsilon(),
                         seed=11, early_reject=early, fused_generations=2,
                         device="cpu")
        abc.new("sqlite://", obs)
        runs.append(abc.run(max_nr_populations=3))
    h_on, h_off = runs
    assert _counts(h_on) == _counts(h_off)
    assert "retired_early" in h_on.get_telemetry(1)
    for t in range(3):
        a, wa = h_on.get_distribution(0, t)
        b, wb = h_off.get_distribution(0, t)
        assert np.array_equal(a.to_numpy(), b.to_numpy())
        assert np.array_equal(wa, wb)


def test_noisy_abc_under_adaptive_n():
    """A stochastic acceptor with a temperature takes an adaptive n: the
    run reaches T = 1 with n in its bounds."""
    abc = tpt.ABCSMC(
        tpt.TorchModel(lambda theta, gen: {"x": theta[:, 0]}, ["theta"],
                       name="det"),
        gaussian.mean_only_prior(), tpt.IndependentNormalKernel(var=[0.09]),
        population_size=tpt.AdaptivePopulationSize(
            start_nr_particles=200, mean_cv=0.2, min_population_size=50,
            max_population_size=400, n_bootstrap=4),
        eps=tpt.Temperature(), acceptor=tpt.StochasticAcceptor(), seed=3,
        device="cpu")
    abc.new("sqlite://", {"x": 0.8})
    h = abc.run(max_nr_populations=8)
    ns = _counts(h)
    assert ns[0] == 200 and all(50 <= n <= 400 for n in ns)
    assert float(h.get_all_populations()["epsilon"].iloc[-1]) == 1.0


@pytest.mark.parametrize("what", ["unbounded", "bootstraps",
                                  "local_adaptive", "local_list", "other"])
def test_what_is_not_ported_raises(what):
    model, prior = gaussian.make_mean_only_model(), gaussian.mean_only_prior()
    kw = {}
    if what == "unbounded":
        kw["population_size"] = tpt.AdaptivePopulationSize(150)
        match = "unbounded max_population_size.*item 16"
    elif what == "bootstraps":
        # refused at construction, before a generation runs
        kw["population_size"] = tpt.AdaptivePopulationSize(
            150, max_population_size=600, n_bootstrap=33)
        match = "n_bootstrap 33 above 32.*item 12"
    elif what == "other":
        kw["population_size"] = object()
        match = "population strategy object.*item 12"
    elif what == "local_adaptive":
        # a bounded adaptive size runs LocalTransition (K16's local mode);
        # an unbounded one is refused with the strategy, as for the MVN
        kw["population_size"] = tpt.AdaptivePopulationSize(150)
        kw["transitions"] = tpt.LocalTransition()
        match = "unbounded max_population_size.*item 16"
    else:
        # a list runs LocalTransition; models whose LocalTransitions differ
        # take the JAX package's host loop
        kw["population_size"] = tpt.ListPopulationSize([100])
        kw["transitions"] = [tpt.LocalTransition(k_fraction=0.25),
                             tpt.LocalTransition(k_fraction=0.5)]
        model, prior = [model, model], [prior, prior]
        match = "LocalTransition with several models whose transitions " \
                "differ.*item 16"
    with pytest.raises(NotImplementedError, match=match):
        tpt.ABCSMC(model, prior, tpt.PNormDistance(p=2), device="cpu", **kw)


def test_more_models_than_k16_takes_raise_at_construction():
    """K16 takes at most ``MAX_MODELS`` models, as K8 does: nine models
    under an adaptive n are refused before a generation runs."""
    from pyabc_tpu_torch.kernels.mvn_fit import MAX_MODELS

    k = MAX_MODELS + 1
    with pytest.raises(ValueError, match=f"{k} models"):
        tpt.ABCSMC([gaussian.make_mean_only_model() for _ in range(k)],
                   [gaussian.mean_only_prior() for _ in range(k)],
                   tpt.PNormDistance(p=2),
                   population_size=tpt.AdaptivePopulationSize(
                       150, max_population_size=600), device="cpu")
