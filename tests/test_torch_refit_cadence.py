"""LocalTransition on the fused path, whole runs on the CPU in both packages:
refit every generation and under the refit cadence (``refit_every``,
``refit_drift_threshold``), the drift guard, the cadence rules, a small
Lotka-Volterra run, the History the port writes and the configurations
that stay unported.

The model is ``tests/test_refit_cadence.py``'s conjugate Gaussian
(x | theta ~ N(theta, 0.5^2), theta ~ N(0, 1), x_obs 1). The two packages
draw different random numbers, so posteriors and epsilon trails are held
statistically, each tolerance with its reason; the refit decisions, which
the cadence fixes whatever the draws, are held exactly.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import pyabc_tpu as jpt  # noqa: E402
from pyabc_tpu.models import gaussian as jgauss  # noqa: E402
from pyabc_tpu.models import lotka_volterra as jlv  # noqa: E402
import pyabc_tpu_torch as tpt  # noqa: E402
from pyabc_tpu_torch.models import gaussian, lotka_volterra  # noqa: E402
from pyabc_tpu_torch.models import gillespie  # noqa: E402

torch.set_num_threads(2)

NOISE_SD, X_OBS = 0.5, 1.0
POST_VAR = 1.0 / (1.0 + 1.0 / NOISE_SD ** 2)
POST_MU = POST_VAR * X_OBS / NOISE_SD ** 2


def _mu(h):
    df, w = h.get_distribution(0, h.max_t)
    return float(np.sum(df["theta"] * w))


def _trail(h):
    return np.asarray(h.get_all_populations()["epsilon"][1:])


def _run(pkg, refit_every, thr, *, seed=11, eps=None, gens=6, pop=300,
         db="sqlite://"):
    if pkg == "jax":
        mod, model = jpt, jgauss.make_mean_only_model(NOISE_SD)
        prior, kw = jgauss.mean_only_prior(), {}
    else:
        mod, model = tpt, gaussian.make_mean_only_model(NOISE_SD)
        prior, kw = gaussian.mean_only_prior(), {"device": "cpu"}
    abc = mod.ABCSMC(
        model, prior,
        mod.PNormDistance(p=2) if eps is not None
        else mod.AdaptivePNormDistance(p=2),
        population_size=pop,
        eps=eps(mod) if eps is not None else mod.MedianEpsilon(),
        seed=seed, fused_generations=8,
        transitions=mod.LocalTransition(k_fraction=0.3),
        refit_every=refit_every, refit_drift_threshold=thr, **kw)
    abc.new(db, {"x": X_OBS})
    h = abc.run(max_nr_populations=gens)
    return abc, h


#: seeds of the refit-every-generation runs in each package
SEEDS = (1, 2, 3, 4)


@pytest.fixture(scope="module")
def every_gen():
    return ([_run("port", 1, 1e9, seed=s) for s in SEEDS],
            [_run("jax", 1, 1e9, seed=s) for s in SEEDS])


@pytest.fixture(scope="module")
def cadence4():
    return _run("port", 4, float("inf")), _run("jax", 4, float("inf"))


def test_refit_every_generation_posterior_and_trail(every_gen):
    ports, refs = every_gen
    assert all(h.n_populations == 6 for _a, h in ports + refs)
    # cadence off: no refit events, no refit telemetry (as the JAX package)
    assert all(a.refit_events == [] for a, _h in ports)
    assert "refit" not in ports[0][1].get_telemetry(2)
    # one run at pop 300: the weighted mean's Monte Carlo error (~0.05
    # over seeds) plus the ABC bias at the last epsilon stay inside 0.3
    mps = [_mu(h) for _a, h in ports]
    mjs = [_mu(h) for _a, h in refs]
    assert all(abs(m - POST_MU) < 0.3 for m in mps)
    assert np.mean(mps) == pytest.approx(np.mean(mjs), abs=0.3)
    # each epsilon is the median of 300 accepted distances and the errors
    # compound along the trail: one seed's log epsilon spreads by 0.05-0.16
    # sd per generation, so the packages' geometric means over the seeds
    # are held within 0.25 relative
    tp = np.exp(np.mean([np.log(_trail(h)) for _a, h in ports], axis=0))
    tj = np.exp(np.mean([np.log(_trail(h)) for _a, h in refs], axis=0))
    np.testing.assert_allclose(tp, tj, rtol=0.25)


def test_cadence_refit_flags_equal_jax(cadence4):
    (pa, ph), (ja, jh) = cadence4
    want = [True, False, False, False, True, False]
    assert [e[1] for e in pa.refit_events] == want
    assert [e[1] for e in ja.refit_events] == want
    # refits factorize every row of the 512-row reservoir (the population
    # moved, and the first fit starts from nothing); skips factorize none
    assert [e[3] for e in pa.refit_events] == [
        e[3] for e in ja.refit_events] == [512, 0, 0, 0, 512, 0]
    # the drift is measured on every generation (0 before the first fit)
    assert pa.refit_events[0][2] == 0.0
    assert all(e[2] > 0.0 for e in pa.refit_events[1:])
    tel = ph.get_telemetry(2)
    assert tel["refit"] is False and tel["refit_rows_changed"] == 0
    assert ph.get_telemetry(4)["refit"] is True
    assert _mu(ph) == pytest.approx(POST_MU, abs=0.3)
    assert _mu(ph) == pytest.approx(_mu(jh), abs=0.3)


def test_never_refit_posterior_still_holds():
    """Refits withheld after the forced first one: the proposal is
    maximally stale, the importance weights keep the posterior."""
    abc, h = _run("port", 1000, 1e9)
    flags = [e[1] for e in abc.refit_events]
    assert h.n_populations == 6
    assert flags[0] is True and not any(flags[1:])
    assert _mu(h) == pytest.approx(POST_MU, abs=0.3)


def test_drift_guard_fires_as_jax_does():
    """A sharp epsilon drop at t = 3 contracts the accepted population:
    the drift passes 0.6 there and forces a refit, in both packages."""
    def eps(mod):
        return mod.ListEpsilon([2.0, 1.6, 1.4, 0.35, 0.3])

    pa, ph = _run("port", 1000, 0.6, eps=eps, gens=5)
    ja, _jh = _run("jax", 1000, 0.6, eps=eps, gens=5)
    assert ph.n_populations == 5
    for events in (pa.refit_events, ja.refit_events):
        assert [e[1] for e in events[:4]] == [True, False, False, True]
        assert events[3][2] > 0.6
        assert events[1][2] < 0.6 and events[2][2] < 0.6
    assert _mu(ph) == pytest.approx(POST_MU, abs=0.3)


def test_refit_cadence_cfg_rules_match_jax():
    def pair(**kw):
        tr = kw.pop("tr", True)
        port = tpt.ABCSMC(
            gaussian.make_mean_only_model(), gaussian.mean_only_prior(),
            tpt.PNormDistance(p=2), population_size=100,
            transitions=tpt.LocalTransition() if tr else None,
            device="cpu", **kw)
        ref = jpt.ABCSMC(
            jgauss.make_mean_only_model(), jgauss.mean_only_prior(),
            jpt.PNormDistance(p=2), population_size=100,
            transitions=jpt.LocalTransition() if tr else None, **kw)
        return port, ref

    for kw, n_cap, want in (({}, 8192, None), ({}, 16384, (16, 0.3)),
                            (dict(refit_every=4, refit_drift_threshold=0.7),
                             512, (4, 0.7)),
                            (dict(refit_every=1), 16384, None),
                            (dict(refit_every=4, tr=False), 16384, None)):
        port, ref = pair(**kw)
        assert port._refit_cadence_cfg(n_cap) == want
        assert ref._refit_cadence_cfg(n_cap) == want


def test_small_lotka_volterra_tracks_jax():
    """LV at pop 400 for 4 generations under AdaptivePNormDistance, both
    packages on the JAX package's observation: the trails agree within
    0.25 relative (the medians of 400 distances, whose scale the adaptive
    weights re-set each generation; the trail may rise in both)."""
    obs = {k: np.asarray(v) for k, v in jlv.observed_data(seed=123).items()}
    port = tpt.ABCSMC(lotka_volterra.make_lv_model(),
                      lotka_volterra.default_prior(),
                      tpt.AdaptivePNormDistance(p=2), population_size=400,
                      eps=tpt.MedianEpsilon(), seed=101,
                      transitions=tpt.LocalTransition(k_fraction=0.25),
                      device="cpu")
    port.new("sqlite://", obs, store_sum_stats=False)
    hp = port.run(max_nr_populations=4)
    ref = jpt.ABCSMC(jlv.make_lv_model(), jlv.default_prior(),
                     jpt.AdaptivePNormDistance(p=2), population_size=400,
                     eps=jpt.MedianEpsilon(), seed=101,
                     transitions=jpt.LocalTransition(k_fraction=0.25))
    ref.new("sqlite://", obs, store_sum_stats=False)
    hj = ref.run(max_nr_populations=4)
    assert hp.n_populations == hj.n_populations == 4
    np.testing.assert_allclose(_trail(hp), _trail(hj), rtol=0.25)
    # the posterior means of the four rates agree within 25 %
    dp, wp = hp.get_distribution(0, 3)
    dj, wj = hj.get_distribution(0, 3)
    mp = (dp.to_numpy() * wp[:, None]).sum(0)
    mj = (dj.to_numpy() * wj[:, None]).sum(0)
    np.testing.assert_allclose(mp, mj, rtol=0.25)


def test_port_history_with_refit_telemetry_opens_in_jax_history(tmp_path):
    db = "sqlite:///" + str(tmp_path / "local.db")
    _abc, h = _run("port", 4, float("inf"), gens=5, pop=200, db=db)
    jh = jpt.History(db)
    assert jh.max_t == h.max_t == 4
    for t in range(5):
        df_j, w_j = jh.get_distribution(0, t)
        df_t, w_t = h.get_distribution(0, t)
        np.testing.assert_array_equal(df_j.to_numpy(), df_t.to_numpy())
        np.testing.assert_allclose(w_j, w_t, rtol=1e-12)
        tel = jh.get_telemetry(t)
        assert set(tel) >= {"refit", "drift", "refit_rows_changed"}
        assert tel == h.get_telemetry(t)


class _Strategy:
    """A population strategy the port does not run (the JAX package's
    AdaptivePopulationSize role)."""

    nr_calibration_particles = None

    def __call__(self, t):
        return 100


def test_unadmitted_local_transition_configurations_raise():
    model, prior = gaussian.make_mean_only_model(), gaussian.mean_only_prior()
    # several models run one LocalTransition configuration; models whose
    # LocalTransitions differ take the JAX package's host loop
    with pytest.raises(NotImplementedError, match="item 16"):
        tpt.ABCSMC([model, model], [prior, prior], tpt.PNormDistance(p=2),
                   transitions=[tpt.LocalTransition(),
                                tpt.LocalTransition(scaling=2.0)],
                   device="cpu")
    with pytest.raises(NotImplementedError, match="item 12"):
        tpt.ABCSMC(model, prior, tpt.IndependentNormalKernel(var=[0.1]),
                   eps=tpt.Temperature(), acceptor=tpt.StochasticAcceptor(),
                   transitions=tpt.LocalTransition(), device="cpu")
    with pytest.raises(NotImplementedError, match="item 12"):
        tpt.ABCSMC(model, prior, tpt.PNormDistance(p=2),
                   population_size=_Strategy(),
                   transitions=tpt.LocalTransition(), device="cpu")
    seg = tpt.ABCSMC(gillespie.make_birth_death_model(n_leaps=100, n_obs=20,
                                                      segments=5),
                     gillespie.birth_death_prior(), tpt.PNormDistance(p=2),
                     population_size=64, eps=tpt.MedianEpsilon(),
                     transitions=tpt.LocalTransition(), device="cpu")
    seg.new("sqlite://", gillespie.observed_birth_death(n_leaps=100,
                                                        n_obs=20,
                                                        segments=5))
    with pytest.raises(NotImplementedError, match="item 12"):
        seg.run(max_nr_populations=2)
    # an early_reject=False run of the same model takes the classic path
    off = tpt.ABCSMC(gillespie.make_birth_death_model(n_leaps=100, n_obs=20,
                                                      segments=5),
                     gillespie.birth_death_prior(), tpt.PNormDistance(p=2),
                     population_size=64, eps=tpt.MedianEpsilon(),
                     transitions=tpt.LocalTransition(), early_reject=False,
                     device="cpu")
    off.new("sqlite://", gillespie.observed_birth_death(n_leaps=100,
                                                        n_obs=20,
                                                        segments=5))
    assert off.run(max_nr_populations=2).n_populations == 2
