"""Whole sharded runs (``ABCSMC(..., sharded=8)`` without a mesh): the port
against the JAX package's virtual-shard runs of ``tests/test_sharded.py``'s
configurations on the CPU, at that file's rules.

The Gaussian toy (x = theta + 0.5 z, prior N(0, 1), x_obs 1) at pop 128
runs in both packages and unsharded: the posterior mean within 0.25 of
the conjugate answer and within 0.2 of the JAX package's sharded run, the
sd within 0.15; pop 300 and 100 (uneven quotas) persist exactly n
particles every generation with weights summing to 1; the tractable pair
lands within 0.2 of the analytic model probabilities. The MVN refit flags
follow the JAX package's chunk cadence exactly. A configuration the JAX
package cannot shard raises its ValueError word for word; one it shards
and the port does not yet raises ``not_ported`` naming itself.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import pyabc_tpu as jpt  # noqa: E402
from pyabc_tpu.models import model_selection as jmsel  # noqa: E402
import pyabc_tpu_torch as tpt  # noqa: E402
from pyabc_tpu_torch.kernels import compact_round, pack_fetch  # noqa: E402
from pyabc_tpu_torch.models import gaussian  # noqa: E402
from pyabc_tpu_torch.models import gillespie as tg  # noqa: E402
from pyabc_tpu_torch.models import model_selection as tmsel  # noqa: E402

torch.set_num_threads(1)

NOISE_SD, X_OBS = 0.5, 1.0
POST_MU = gaussian.conjugate_posterior(X_OBS, noise_sd=NOISE_SD)[0]


def _jax_model():
    @jpt.JaxModel.from_function(["theta"], name="gauss_sharded")
    def model(key, theta):
        return {"x": theta[0] + NOISE_SD * jax.random.normal(key)}

    return model


def _make(pkg, seed, pop=128, G=3, sharded=8, **kw):
    if pkg == "jax":
        abc = jpt.ABCSMC(_jax_model(),
                         jpt.Distribution(theta=jpt.RV("norm", 0.0, 1.0)),
                         jpt.PNormDistance(p=2), population_size=pop,
                         eps=jpt.MedianEpsilon(), seed=seed, sharded=sharded,
                         fused_generations=G, **kw)
    else:
        abc = tpt.ABCSMC(gaussian.make_mean_only_model(noise_sd=NOISE_SD),
                         gaussian.mean_only_prior(), tpt.PNormDistance(p=2),
                         population_size=pop, eps=tpt.MedianEpsilon(),
                         seed=seed, sharded=sharded, fused_generations=G,
                         device="cpu", **kw)
    abc.new("sqlite://", {"x": X_OBS})
    return abc


def _moments(h):
    df, w = h.get_distribution(0, h.max_t)
    mu = float(np.sum(df["theta"] * w))
    return mu, float(np.sqrt(np.sum(w * (df["theta"] - mu) ** 2)))


def _refits(h):
    return [bool(h.get_telemetry(t).get("refit"))
            for t in range(h.max_t + 1)]


@pytest.fixture(scope="module")
def toy():
    """{(pkg, sharded): (abc, History)} of the toy at pop 128, seed 23,
    six generations in chunks of 3 (``test_sharded.py``'s parity run)."""
    out = {}
    for pkg in ("jax", "port"):
        for sharded in (8, None):
            if pkg == "jax" and sharded is None:
                continue
            abc = _make(pkg, 23, sharded=sharded)
            out[pkg, sharded] = (abc, abc.run(max_nr_populations=6))
    return out


def test_sharded_toy_against_the_jax_package(toy):
    """``test_sharded_statistical_parity_with_single_device``'s rules,
    the port's sharded run held to the JAX package's and to its own
    unsharded run."""
    mu, sd = _moments(toy["port", 8][1])
    mu_j, sd_j = _moments(toy["jax", 8][1])
    mu_u, sd_u = _moments(toy["port", None][1])
    assert mu == pytest.approx(POST_MU, abs=0.25)
    assert mu == pytest.approx(mu_j, abs=0.2)
    assert sd == pytest.approx(sd_j, abs=0.15)
    assert mu == pytest.approx(mu_u, abs=0.2)
    assert sd == pytest.approx(sd_u, abs=0.15)


#: the seeds whose epsilon trails the trail cell averages: the fixture's
#: seed 23 and the seven after it
TRAIL_SEEDS = tuple(range(23, 31))


def _trail(h):
    return h.get_all_populations().query("t >= 0")["epsilon"].to_numpy()


def test_sharded_toy_epsilon_trail_against_the_jax_package(toy):
    """The trails fall alike: each generation's epsilon, averaged over
    TRAIL_SEEDS, within 25 % of the JAX package's sharded runs' (different
    Philox and threefry draws; one seed's trail at pop 128 strays by about
    as much, so the cell compares seed means)."""
    trails = {pkg: [_trail(toy[pkg, 8][1])] for pkg in ("port", "jax")}
    for pkg in trails:
        for seed in TRAIL_SEEDS[1:]:
            trails[pkg].append(_trail(_make(pkg, seed).run(
                max_nr_populations=6)))
    a, b = (np.mean(trails[pkg], axis=0) for pkg in ("port", "jax"))
    assert len(a) == len(b) == 6
    np.testing.assert_allclose(a, b, rtol=0.25)
    for trail in trails["port"]:
        assert np.all(np.diff(trail) < 0)


def test_refit_flags_equal_the_jax_package(toy):
    """The MVN refit at the chunk cadence (``smc.py:2739-2748``): the
    first generation and every G = 3 after it, the flags equal to the JAX
    package's telemetry; the unsharded run records none."""
    flags = _refits(toy["port", 8][1])
    assert flags == _refits(toy["jax", 8][1])
    assert flags == [True, False, False, True, False, False]
    assert [e[1] for e in toy["port", 8][0].refit_events] == flags
    assert toy["port", None][0].refit_events == []


def test_explicit_refit_every_is_honoured():
    """``refit_every=2`` under sharding: the JAX package's flags."""
    hs = [_make(pkg, 5, pop=64, refit_every=2).run(max_nr_populations=5)
          for pkg in ("jax", "port")]
    assert _refits(hs[0]) == _refits(hs[1]) == [True, False, True, False,
                                                True]


@pytest.mark.parametrize("pop", [300, 100])
def test_uneven_population_keeps_n_rows(pop):
    """``TestUnevenShards``: pop % 8 != 0, the leading shards take the
    remainder, every generation has exactly pop particles with finite
    weights summing to 1, and the posterior within 0.3 of the conjugate
    mean; the JAX package's run beside it within 0.2."""
    h = _make("port", 31, pop=pop).run(max_nr_populations=5)
    counts = h.get_nr_particles_per_population()
    for t in range(h.max_t + 1):
        assert counts[t] == pop, (t, counts[t])
        df, w = h.get_distribution(0, t)
        w = np.asarray(w)
        assert len(df) == pop
        assert np.all(np.isfinite(w)) and w.sum() == pytest.approx(1.0)
        assert np.all(np.isfinite(df["theta"].to_numpy()))
    mu, _ = _moments(h)
    assert mu == pytest.approx(POST_MU, abs=0.3)
    mu_j, _ = _moments(_make("jax", 31, pop=pop).run(max_nr_populations=5))
    assert mu == pytest.approx(mu_j, abs=0.2)


def test_tractable_pair_sharded():
    """``test_multimodel_sharded``: K = 2 rides the sharded path, the model
    column merged with the rows; within 0.2 of the analytic answer, and
    the JAX package's run beside it; the refit flags equal."""
    models, priors, analytic = tmsel.tractable_pair()
    abc = tpt.ABCSMC(models, priors, tpt.PNormDistance(p=2),
                     population_size=600, eps=tpt.MedianEpsilon(), seed=22,
                     sharded=8, fused_generations=3, device="cpu")
    abc.new("sqlite://", {"x": X_OBS})
    h = abc.run(max_nr_populations=5)
    jm, jp, _ja = jmsel.tractable_pair()
    jabc = jpt.ABCSMC(jm, jp, jpt.PNormDistance(p=2), population_size=600,
                      eps=jpt.MedianEpsilon(), seed=22, sharded=8,
                      fused_generations=3)
    jabc.new("sqlite://", {"x": X_OBS})
    jh = jabc.run(max_nr_populations=5)
    expected = analytic(X_OBS)
    probs = h.get_model_probabilities(h.max_t)
    jprobs = jh.get_model_probabilities(jh.max_t)
    for m in range(2):
        p = float(probs["p"].get(m, 0.0))
        assert p == pytest.approx(expected[m], abs=0.2), (m, p)
        assert p == pytest.approx(float(jprobs["p"].get(m, 0.0)), abs=0.2)
    assert _refits(h) == _refits(jh)
    for t in range(h.max_t + 1):
        assert h.get_nr_particles_per_population()[t] == 600


def test_sharded_sync_budget(toy):
    """One counter read a round (the shards' table in it), one fetch a
    chunk, and the host calibration's round and collect: nothing else."""
    abc = toy["port", 8][0]
    rounds = sum(g["rounds"] for g in abc.generation_log)
    report = abc.sync_ledger.budget_report(rounds=rounds, chunks=2, slack=2)
    assert report["ok"], report
    assert report["by_kind"] == {"round_counters": rounds + 1,
                                 "generation_collect": 1, "chunk_fetch": 2}


def test_sharded_count_resolution():
    """Without a mesh ``True``, ``None`` and 1 run unsharded (the JAX
    package's ``_sharded_n``); 8 shards; on the CPU the wrappers take
    their plain versions and count no launch."""
    for s in (True, None, 1, False):
        assert _make("port", 1, sharded=s).sharded_n is None
    launches = compact_round.mode_launches["shards"]
    merged = pack_fetch.mode_launches["merge"]
    abc = _make("port", 1, pop=64)
    assert abc.sharded_n == 8
    abc.run(max_nr_populations=2)
    assert compact_round.mode_launches["shards"] == launches
    assert pack_fetch.mode_launches["merge"] == merged


@pytest.mark.parametrize("kw,match", [
    ({"sharded": 6}, "shard count 6 is not a power of two"),
    ({"sharded": 128, "pop": 10},
     "population capacity 64 is not divisible by 128 shards"),
    ({"G": 1}, "config cannot run fused chunks"),
])
def test_refusals_are_the_jax_packages(kw, match):
    """What the JAX package cannot shard raises its ValueError, word for
    word."""
    with pytest.raises(ValueError) as port_err:
        _make("port", 0, **kw)
    jabc = _make("jax", 0, **kw)
    with pytest.raises(ValueError) as jax_err:
        jabc._sharded_n()
    assert str(port_err.value) == str(jax_err.value)
    assert match in str(port_err.value)


def test_median_scale_refusal_is_the_jax_packages():
    jd = jpt.AdaptivePNormDistance(p=2)
    jabc = jpt.ABCSMC(_jax_model(),
                      jpt.Distribution(theta=jpt.RV("norm", 0.0, 1.0)), jd,
                      population_size=64, sharded=8, fused_generations=3)
    jabc.new("sqlite://", {"x": X_OBS})
    with pytest.raises(ValueError) as jax_err:
        jabc._sharded_n()
    with pytest.raises(ValueError) as port_err:
        tpt.ABCSMC(gaussian.make_mean_only_model(),
                   gaussian.mean_only_prior(), tpt.AdaptivePNormDistance(p=2),
                   population_size=64, sharded=8, device="cpu")
    assert str(port_err.value) == str(jax_err.value)
    assert "moment-decomposable" in str(port_err.value)


def _unserved():
    model, prior = gaussian.make_mean_only_model(), gaussian.mean_only_prior()
    pn = tpt.PNormDistance(p=2)
    return {
        "a StochasticAcceptor or a temperature": dict(
            distance_function=tpt.IndependentNormalKernel(var=[0.09]),
            eps=tpt.Temperature(), acceptor=tpt.StochasticAcceptor()),
        "learned summary statistics": dict(
            distance_function=tpt.PNormDistance(
                p=2, sumstat=tpt.PredictorSumstat(tpt.LinearPredictor()))),
        "an AdaptivePopulationSize": dict(
            population_size=tpt.AdaptivePopulationSize(
                64, max_population_size=128)),
        "a GridSearchCV": dict(transitions=tpt.GridSearchCV(
            tpt.MultivariateNormalTransition(), {"scaling": [0.5, 1.0]},
            cv=3)),
        "a LocalTransition": dict(transitions=tpt.LocalTransition()),
    }, model, prior


@pytest.mark.parametrize("what", sorted(_unserved()[0]))
def test_unserved_configurations_are_not_ported(what):
    """Each configuration the JAX package shards and this slice does not
    raises ``not_ported`` at construction, naming itself, ROADMAP item
    15; none silently runs unsharded."""
    cases, model, prior = _unserved()
    kw = {"population_size": 64, "distance_function": tpt.PNormDistance(p=2),
          **cases[what]}
    with pytest.raises(NotImplementedError,
                       match=f"sharded sampling with {what}.*item 15"):
        tpt.ABCSMC(model, prior, sharded=8, device="cpu", **kw)


def _now_served():
    """The configurations of the JAX suite's
    ``test_previously_gated_configs_now_shard`` that the port once refused
    (``tests/test_sharded.py:715-745``)."""
    pn = tpt.PNormDistance(p=2)
    return {
        "an AggregatedDistance": lambda: tpt.AggregatedDistance(
            [pn, tpt.PNormDistance(p=1)]),
        "an AdaptiveAggregatedDistance": lambda: (
            tpt.AdaptiveAggregatedDistance([pn, tpt.PNormDistance(p=1)])),
        "a user weight schedule": lambda: tpt.PNormDistance(
            p=2, weights={0: [1.0], 1: [2.0]}),
    }


@pytest.mark.parametrize("what", sorted(_now_served()))
def test_previously_unserved_configurations_now_shard(what):
    """An aggregated distance, fixed or adaptive, and a user weight
    schedule resolve the shard count, as in the JAX package."""
    abc = tpt.ABCSMC(gaussian.make_mean_only_model(),
                     gaussian.mean_only_prior(), _now_served()[what](),
                     population_size=64, sharded=8, device="cpu")
    assert abc.sharded_n == 8


def test_mesh_and_segmented_early_reject_are_not_ported():
    """A mesh runs (``tests/test_torch_mesh.py``) when it is a
    one-dimensional ``DeviceMesh``; anything else is a TypeError naming
    it. Segmented early reject in a sharded run stays unported."""
    model, prior = gaussian.make_mean_only_model(), gaussian.mean_only_prior()
    with pytest.raises(TypeError,
                       match="one-dimensional torch DeviceMesh.*got object"):
        tpt.ABCSMC(model, prior, mesh=object(), device="cpu")
    small = dict(n_leaps=20, n_obs=4, t1=2.0)
    with pytest.raises(NotImplementedError,
                       match="segmented early reject in a sharded run.*13"):
        tpt.ABCSMC(tg.make_birth_death_model(segments=2, **small),
                   tg.birth_death_prior(), tpt.PNormDistance(p=2),
                   population_size=64, sharded=8, device="cpu")
    abc = tpt.ABCSMC(tg.make_birth_death_model(segments=2, **small),
                     tg.birth_death_prior(), tpt.PNormDistance(p=2),
                     population_size=64, sharded=8, early_reject=False,
                     device="cpu")
    assert abc.sharded_n == 8
