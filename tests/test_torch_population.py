"""The adaptive population size (K16) and the population strategies: the
port against the JAX package on the CPU.

Inputs come from numpy seeds and go through the JAX function and its
counterpart in the port (the plain PyTorch versions of the kernels): the
bootstrap CV on the JAX package's own ancestor draws (one model, and the
model-weighted aggregate over three with one dead), the bisection on a
deterministic CV function, the host strategies on the JAX suite's
fixed-CV stubs, and the law of K16's draw.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import importlib  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402
import pytest  # noqa: E402
import scipy.stats  # noqa: E402
import torch  # noqa: E402

from pyabc_tpu import populationstrategy as jps  # noqa: E402
from pyabc_tpu.transition import multivariatenormal as jmvn  # noqa: E402
from pyabc_tpu.transition import util as jutil  # noqa: E402
import pyabc_tpu_torch as tpt  # noqa: E402
from pyabc_tpu_torch import convert  # noqa: E402
from pyabc_tpu_torch import populationstrategy as tps  # noqa: E402
from pyabc_tpu_torch.kernels import mvn_fit  # noqa: E402
from pyabc_tpu_torch.transition import (  # noqa: E402
    MultivariateNormalTransition, device_bootstrap_indices, device_mean_cv,
    device_required_nr, silverman_rule_of_thumb)

bc = importlib.import_module("pyabc_tpu_torch.kernels.bootstrap_cv")

torch.set_num_threads(1)

JMVN = jmvn.MultivariateNormalTransition
STATICS = {"scaling": 1.0, "bandwidth_selector": silverman_rule_of_thumb}
J_STATICS = {"scaling": 1.0,
             "bandwidth_selector": jutil.silverman_rule_of_thumb}
#: the bootstrap CV against the JAX package's on the same ancestors: the
#: fits and densities are float32 sums in another order, and the CV of
#: ten densities moves by about their relative error over the CV
CV_RTOL = 1e-4


def _population(seed, n_cap, d, n_live):
    rng = np.random.default_rng(seed)
    th = np.zeros((n_cap, d), np.float32)
    th[:n_live] = rng.normal(size=(n_live, d)) * np.linspace(0.5, 2.0, d) + 1
    w = np.zeros(n_cap, np.float32)
    w[:n_live] = rng.random(n_live) + 0.1
    return th, w / w.sum()


def _jax_fit(th, w, dim):
    return JMVN.device_fit(jnp.asarray(th), jnp.asarray(w), dim=dim,
                           **J_STATICS)


def _jax_indices(params, key, n_bootstrap):
    """The JAX package's ancestors, as ``transition/util.py:164-170``
    draws them."""
    w = params["weights"]
    logw = jnp.where(w > 0, jnp.log(jnp.maximum(w, 1e-38)), -jnp.inf)
    n_cap = w.shape[0]
    keys = jax.random.split(key, n_bootstrap)
    return np.stack([np.asarray(jax.random.categorical(k, logw,
                                                       shape=(n_cap,)))
                     for k in keys]).astype(np.int32)


# ------------------------------------------------------------ K16's CV
#: (d, weighted rows, n): n = 2, n_cap / 3 and n_cap. Two rows in three
#: dimensions leave a rank-1 covariance that only the ladder's last rung
#: factorizes; the JAX package's densities then turn NaN (its CV reads 0)
#: where the port's stay finite, so d 3 starts at n_cap / 3
CV_CASES = [(1, 70, 2), (1, 70, 32), (1, 70, 96), (2, 96, 2), (2, 96, 32),
            (2, 96, 96), (3, 70, 32), (3, 70, 96)]


@pytest.mark.parametrize("d,n_live,n", CV_CASES)
def test_device_mean_cv_matches_jax(d, n_live, n):
    n_cap, nb = 96, 6
    th, w = _population(3 + d, n_cap, d, n_live)
    jp = _jax_fit(th, w, d)
    key = jax.random.PRNGKey(11)
    ref = float(jutil.device_mean_cv(JMVN, jp, key, jnp.asarray(n), dim=d,
                                     n_bootstrap=nb, **J_STATICS))
    idx = torch.from_numpy(_jax_indices(jp, key, nb))
    params = convert.transition_params(
        {k: np.asarray(v) for k, v in jp.items()}, device="cpu")
    got = float(MultivariateNormalTransition.device_mean_cv(
        params, idx, n, dim=d, **STATICS))
    assert got == pytest.approx(ref, rel=CV_RTOL)
    # the K16 entries (fit, then density + CV) on the same ancestors
    state = torch.tensor([10, n_cap, n, 0, 0], dtype=torch.int32)
    stacked = {k: params[k][None] for k in ("thetas", "weights")}
    fit = bc.bootstrap_cv.fit(stacked["thetas"], idx[None], state, dims=[d],
                              statics=[STATICS])
    part = bc.bootstrap_cv.density(stacked["thetas"], stacked["weights"],
                                   fit, state)
    cv = float(part[0, :, 0].sum() / part[0, :, 1].sum())
    assert cv == pytest.approx(ref, rel=CV_RTOL)


def _jax_aggregate_cv(fits, probs, boot_key, n, nb, dims):
    """``inference/util.py:2112-2134``'s model-weighted CV."""
    probs_sum = jnp.maximum(probs.sum(), 1e-38)
    tot = 0.0
    for m, fit in enumerate(fits):
        cv_m = jutil.device_mean_cv(
            JMVN, fit, jax.random.fold_in(boot_key, m), jnp.asarray(n),
            dim=dims[m], n_bootstrap=nb, **J_STATICS)
        tot = tot + jnp.where(probs[m] > 0, probs[m] / probs_sum * cv_m, 0.0)
    return float(tot)


@pytest.mark.parametrize("n", [3, 40, 128])
def test_model_weighted_cv_matches_jax(n):
    """K = 3 on a d_max-2 reservoir (dims 1, 2, 2), model 1 dead: the
    aggregate CV of the bisect step equals the JAX package's, each model
    on its own JAX draws."""
    n_cap, nb, K, dims = 128, 5, 3, [1, 2, 2]
    th, w = _population(21, n_cap, 2, n_cap)
    m = (np.arange(n_cap) % K).astype(np.int32)
    m[m == 1] = 2
    th[m == 0, 1] = 0.0
    fits, idx = [], []
    boot_key = jax.random.PRNGKey(5)
    for k in range(K):
        wk = np.where(m == k, w, 0.0).astype(np.float32)
        fit = _jax_fit(th, wk / max(wk.sum(), 1e-30), dims[k])
        fits.append(fit)
        idx.append(_jax_indices(fit, jax.random.fold_in(boot_key, k), nb))
    probs = np.array([w[m == k].sum() for k in range(K)], np.float32)
    ref = _jax_aggregate_cv(fits, jnp.asarray(probs), boot_key, n, nb, dims)
    ours = mvn_fit.models(torch.from_numpy(th), torch.from_numpy(w),
                          torch.from_numpy(m), dims=dims,
                          statics=[STATICS] * K)
    state = torch.tensor([10, n_cap, n, 0, 0], dtype=torch.int32)
    idx_t = torch.from_numpy(np.stack(idx))
    fit = bc.bootstrap_cv.fit(ours["thetas"], idx_t, state, dims=dims,
                              statics=[STATICS] * K)
    part = bc.bootstrap_cv.density(ours["thetas"], ours["weights"], fit,
                                   state)
    assert float(part[1].abs().sum()) == 0.0  # the dead model adds nothing
    cvs = torch.zeros(bc.MAX_PROBES)
    bc.bootstrap_cv.bisect(part, state, cvs,
                           model_p=torch.from_numpy(probs), target=1e9)
    assert float(cvs[0]) == pytest.approx(ref, rel=CV_RTOL)


# -------------------------------------------------------- the bisection
def _sqrt_cv(n):
    return 1.0 / np.sqrt(np.float32(max(int(n), 1)))


@pytest.mark.parametrize("target,min_n,max_n,expect", [
    (0.1, 10, 10_000, 100),      # reachable: n* = 1 / 0.1^2
    (0.07, 10, 600, 205),        # reachable, between two powers
    (1e-6, 10, 500, 500),        # unreachable: max_n at once
    (10.0, 25, 1000, 25),        # loose: min_n
    (0.3, 40, 40, 40),           # one candidate
])
def test_required_nr_matches_jax(target, min_n, max_n, expect):
    def jcv(n):
        return 1.0 / jnp.sqrt(jnp.maximum(n, 1).astype(jnp.float32))

    ref = int(jutil.device_required_nr(jcv, target_cv=target, min_n=min_n,
                                       max_n=max_n))
    got = device_required_nr(_sqrt_cv, target_cv=target, min_n=min_n,
                             max_n=max_n)
    assert got == ref
    if expect is not None:
        assert got == expect
    # K16's bisect step, fed each probe's CV as one block of weight 1,
    # reaches the same n within its fixed number of probes
    state = torch.tensor([min_n, max_n, max_n, 0, 0], dtype=torch.int32)
    cvs = torch.zeros(bc.MAX_PROBES)
    for _ in range(bc.n_probes(min_n, max_n)):
        n = int(state[bc.PROBE])
        part = torch.tensor([[[_sqrt_cv(n), 1.0]]], dtype=torch.float32)
        bc.bootstrap_cv.bisect(part, state, cvs, model_p=None, target=target)
    assert int(state[bc.DONE]) == 1 and int(state[bc.HI]) == ref


def test_mvn_required_nr_matches_jax():
    """The MVN statics on a fitted population: the same n as the JAX
    package's ``device_required_nr`` on the same ancestors, and K16's
    pipeline (draw replaced by those ancestors) lands there too."""
    n_cap, nb, d = 128, 8, 2
    th, w = _population(7, n_cap, d, n_cap)
    jp = _jax_fit(th, w, d)
    key = jax.random.PRNGKey(3)
    kw = dict(dim=d, n_bootstrap=nb, **J_STATICS)
    cv96 = float(JMVN.device_mean_cv(jp, key, jnp.asarray(96), **kw))
    ref = int(JMVN.device_required_nr(jp, key, target_cv=cv96, min_n=10,
                                      max_n=n_cap, **kw))
    params = convert.transition_params(
        {k: np.asarray(v) for k, v in jp.items()}, device="cpu")
    idx = torch.from_numpy(_jax_indices(jp, key, nb))
    got = MultivariateNormalTransition.device_required_nr(
        params, idx, target_cv=cv96, min_n=10, max_n=n_cap, dim=d,
        **STATICS)
    assert got == ref
    state = torch.tensor([10, n_cap, n_cap, 0, 0], dtype=torch.int32)
    cvs = torch.zeros(bc.MAX_PROBES)
    T, W = params["thetas"][None], params["weights"][None]
    for _ in range(bc.n_probes(10, n_cap)):
        fit = bc.bootstrap_cv.fit(T, idx[None], state, dims=[d],
                                  statics=[STATICS])
        part = bc.bootstrap_cv.density(T, W, fit, state)
        bc.bootstrap_cv.bisect(part, state, cvs, model_p=None, target=cv96)
    assert int(state[bc.HI]) == ref


def test_required_nr_pipeline_and_probe_count():
    """``required_nr`` drives the four entries: the state ends done, the
    answer is the plain bisection's on the same draw, and a probe after
    done changes nothing."""
    n_cap, d = 200, 2
    th, w = _population(9, n_cap, d, 150)
    p = mvn_fit(torch.from_numpy(th), torch.from_numpy(w), dim=d, **STATICS)
    kw = dict(seed=4, generation=2, max_rounds=256, min_n=10, max_n=n_cap,
              n_bootstrap=5)
    res = bc.required_nr(p["thetas"][None], p["weights"][None],
                         p["cdf"][None], dims=[d], statics=[STATICS],
                         target_cv=0.3, **kw)
    ref = MultivariateNormalTransition.device_required_nr(
        p, res["idx"][0], target_cv=0.3, min_n=10, max_n=n_cap, dim=d,
        **STATICS)
    assert int(res["n_next"]) == ref and int(res["state"][bc.DONE]) == 1
    assert int(res["state"][bc.STEP]) <= bc.n_probes(10, n_cap)
    before = res["state"].clone()
    bc.bootstrap_cv.bisect(torch.zeros(1, 1, 2), res["state"],
                           res["cvs"], model_p=None, target=0.3)
    assert torch.equal(res["state"], before)
    assert bc.n_probes(10, 16384) == 15 and bc.n_probes(20, 600) == 11


# ---------------------------------------------------------- the draw
def test_draw_law_and_zero_weight_rows():
    """K16's draw against the weights: a chi-square over 16 bins of 256
    rows each (p > 1e-3), zero-weight rows never drawn, and the draw a
    function of (seed, generation, model, bootstrap) alone."""
    n_cap, nb = 4096, 32
    rng = np.random.default_rng(0)
    w = rng.random(n_cap).astype(np.float32) + 0.05
    w[rng.random(n_cap) < 0.3] = 0.0
    w[1024:1280] = 0.0  # one whole bin empty
    w /= w.sum()
    cdf = torch.from_numpy(convert.ancestor_cdf(w))
    idx, state = bc.bootstrap_cv.draw(cdf[None], n_boot=nb, seed=7,
                                      generation=3, max_rounds=256,
                                      min_n=10, max_n=n_cap)
    assert idx.shape == (1, nb, n_cap) and idx.dtype == torch.int32
    assert state.tolist() == [10, n_cap, n_cap, 0, 0]
    flat = idx.reshape(-1).numpy()
    assert (w[flat] > 0).all()
    obs = np.bincount(flat // 256, minlength=16)
    exp = np.array([w[b * 256:(b + 1) * 256].sum(dtype=np.float64)
                    for b in range(16)])
    keep = exp > 0
    assert obs[~keep].sum() == 0
    _chi2, pval = scipy.stats.chisquare(obs[keep],
                                        exp[keep] / exp.sum() * flat.size)
    assert pval > 1e-3
    again, _ = bc.bootstrap_cv.draw(cdf[None], n_boot=nb, seed=7,
                                    generation=3, max_rounds=256, min_n=0,
                                    max_n=0)
    other, _ = bc.bootstrap_cv.draw(cdf[None], n_boot=nb, seed=7,
                                    generation=4, max_rounds=256, min_n=0,
                                    max_n=0)
    assert torch.equal(idx, again) and not torch.equal(idx, other)
    # a model's blocks do not depend on the number of models
    two, _ = bc.bootstrap_cv.draw(torch.stack([cdf, cdf]), n_boot=nb,
                                  seed=7, generation=3, max_rounds=256,
                                  min_n=0, max_n=0)
    assert torch.equal(two[0], idx[0]) and not torch.equal(two[1], idx[0])
    p = {"cdf": cdf}
    assert torch.equal(device_bootstrap_indices(p, nb, seed=7, generation=3,
                                                max_rounds=256), idx[0])
    with pytest.raises(ValueError, match="n_bootstrap"):
        bc.bootstrap_cv.draw(cdf[None], n_boot=bc.MAX_BOOTSTRAP + 1, seed=0,
                             generation=0, max_rounds=256, min_n=0, max_n=0)


def test_generic_mean_cv_on_port_draws_decreases_with_n():
    """The JAX suite's monotonicity check on the port's own draws."""
    n_cap, d = 128, 2
    th, w = _population(7, n_cap, d, n_cap)
    p = mvn_fit(torch.from_numpy(th), torch.from_numpy(w), dim=d, **STATICS)
    idx = device_bootstrap_indices(p, 20, seed=0, generation=1,
                                   max_rounds=256)
    cv = [float(device_mean_cv(p, idx, n, dim=d, **STATICS))
          for n in (8, 128)]
    assert cv[0] > cv[1] > 0


# ------------------------------------------------------ host strategies
class _FixedCVTransition:
    """The JAX suite's stub: mean_cv a known function of n."""

    NR_BOOTSTRAP = 5

    def __init__(self, cv_fn):
        self.cv_fn = cv_fn
        self.seen_bootstrap = []

    def mean_cv(self, n):
        self.seen_bootstrap.append(self.NR_BOOTSTRAP)
        return self.cv_fn(n)


@pytest.mark.parametrize("cvs,weights,nb", [
    ((0.2, 0.6), (0.25, 0.75), 7), ((0.4,), (2.0,), 3),
    ((0.1, 0.3, 0.5), (1.0, 0.0, 3.0), 11)])
def test_calc_cv_matches_jax(cvs, weights, nb):
    def stubs():
        return [_FixedCVTransition(lambda n, c=c: c) for c in cvs]

    ours, ref = stubs(), stubs()
    for t in ours + ref:
        t.NR_BOOTSTRAP = 13
    got = tps.calc_cv(100, np.array(weights), nb, ours)
    want = jps.calc_cv(100, np.array(weights), nb, ref)
    assert got == pytest.approx(want, rel=1e-12)
    assert [t.seen_bootstrap for t in ours] == [[nb]] * len(cvs)
    assert all(t.NR_BOOTSTRAP == 13 for t in ours)


@pytest.mark.parametrize("kw,cv_fn", [
    (dict(start_nr_particles=100, mean_cv=0.1, min_population_size=10,
          max_population_size=10_000), lambda n: 1.0 / np.sqrt(n)),
    (dict(start_nr_particles=100, mean_cv=1e-6, min_population_size=10,
          max_population_size=500), lambda n: 1.0 / np.sqrt(n)),
    (dict(start_nr_particles=100, mean_cv=10.0, min_population_size=25,
          max_population_size=1000), lambda n: 1.0 / np.sqrt(n)),
    (dict(start_nr_particles=300, mean_cv=0.05), lambda n: 2.0 / n),
    (dict(start_nr_particles=77, mean_cv=0.05), None),
])
def test_adaptive_update_matches_jax(kw, cv_fn):
    """``update`` on the JAX suite's cases: the bisection's threshold, the
    unreachable and loose targets, an unbounded cap (10 n or 1000) and a
    degenerate transition that keeps the previous n."""
    class _Boom:
        NR_BOOTSTRAP = 5

        def mean_cv(self, n):
            raise RuntimeError("degenerate")

    ours, ref = tps.AdaptivePopulationSize(**kw), jps.AdaptivePopulationSize(
        **kw)
    for aps in (ours, ref):
        tr = _Boom() if cv_fn is None else _FixedCVTransition(cv_fn)
        aps.update([tr], np.array([1.0]), t=0)
    assert ours.nr_particles == ref.nr_particles
    assert ours(3) == ours.nr_particles
    assert ours.get_config() == ref.get_config()


def test_update_refuses_a_transition_without_mean_cv():
    """The port's transitions have no host ``mean_cv`` (a run picks n with
    K16): ``update`` raises with the host loop's item, where it used to
    log a warning and keep n."""
    aps = tps.AdaptivePopulationSize(100, max_population_size=500)
    with pytest.raises(NotImplementedError,
                       match="MultivariateNormalTransition.*item 16"):
        aps.update([MultivariateNormalTransition()], np.array([1.0]), t=0)
    assert aps.nr_particles == 100


def test_strategies_match_jax():
    lst, jlst = tps.ListPopulationSize([5, 7, 9]), jps.ListPopulationSize(
        [5, 7, 9])
    assert [lst(t) for t in range(3)] == [jlst(t) for t in range(3)]
    assert lst.get_config() == jlst.get_config()
    const = tps.ConstantPopulationSize(40, nr_calibration_particles=80)
    assert const(9) == 40 and const.nr_calibration_particles == 80
    base = tps.PopulationStrategy()
    base.update([], np.ones(1))
    with pytest.raises(NotImplementedError):
        base(0)
    assert tpt.AdaptivePopulationSize is tps.AdaptivePopulationSize
    assert tpt.ListPopulationSize is tps.ListPopulationSize
    for j in (jps.ConstantPopulationSize(33, nr_calibration_particles=50),
              jps.ListPopulationSize([3, 4], nr_calibration_particles=9),
              jps.AdaptivePopulationSize(120, mean_cv=0.2,
                                         max_population_size=900,
                                         min_population_size=30,
                                         n_bootstrap=6,
                                         nr_calibration_particles=70)):
        ours = convert.population_strategy(j)
        assert type(ours).__name__ == type(j).__name__
        assert ours.get_config() == j.get_config()
        assert ours(0) == j(0)
        assert ours.nr_calibration_particles == j.nr_calibration_particles
    ada = convert.population_strategy(jps.AdaptivePopulationSize(
        120, mean_cv=0.2, max_population_size=900, min_population_size=30,
        n_bootstrap=6))
    assert (ada.max_population_size, ada.min_population_size,
            ada.n_bootstrap) == (900, 30, 6)


def test_history_counts_query_matches_jax(tmp_path):
    """``get_nr_particles_per_population`` of a port db read by both
    packages' History (index t from -1, one row count per generation)."""
    from pyabc_tpu.storage.history import History as JHistory

    from pyabc_tpu_torch.models import gaussian

    db = f"sqlite:///{tmp_path / 'counts.db'}"
    abc = tpt.ABCSMC(gaussian.make_mean_only_model(),
                     gaussian.mean_only_prior(), tpt.PNormDistance(p=2),
                     population_size=tpt.ListPopulationSize([60, 90, 70]),
                     eps=tpt.MedianEpsilon(), seed=2, device="cpu")
    abc.new(db, {"x": 1.0})
    h = abc.run(max_nr_populations=5)
    ours = h.get_nr_particles_per_population()
    ref = JHistory(db).get_nr_particles_per_population()
    pd.testing.assert_series_equal(ours, ref, check_dtype=False)
    assert ours.loc[0:].tolist() == [60, 90, 70]
