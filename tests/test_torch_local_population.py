"""K16's LocalTransition mode (the bootstrap CV of the local KDE and its
bisection) and LocalTransition under listed and adaptive population sizes:
the port against the JAX package on the CPU.

The port's own ancestors (K16's draw on the BOOT stream) go through the
JAX package's formula (``transition/util.py:150-186`` with
``LocalTransition.device_fit`` and the vmapped ``device_logpdf``) and
through K16's gather, K12 and K13, local density and bisect (their plain
versions). Tolerances, with their reasons:

- the CV: 1e-4 relative (the fits and densities are float32 sums in
  another order; the CV of ten densities moves by about their relative
  error over the CV, as the MVN's in ``test_torch_population.py``);
- the bootstrap fits: selections and counts exactly (the distances are the
  same tile in both), factors 1e-5 + 1e-4 relative, precisions 1e-3 of the
  row's largest entry (duplicate rows leave a near-degenerate neighbour
  covariance; the port inverts through the Cholesky factor, the JAX
  package by LU);
- the bisection: the same n;
- whole runs: the JAX suite's own rules, and the two packages' posterior
  means within 0.35 (their random streams differ).
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import pyabc_tpu as jpt  # noqa: E402
from pyabc_tpu.transition import util as jutil  # noqa: E402
from pyabc_tpu.transition.local_transition import (  # noqa: E402
    LocalTransition as JLocal)
import pyabc_tpu_torch as tpt  # noqa: E402
from pyabc_tpu_torch import convert  # noqa: E402
from pyabc_tpu_torch.kernels import bootstrap_cv  # noqa: E402
from pyabc_tpu_torch.kernels.bootstrap_cv import (  # noqa: E402
    DONE, HI, MAX_PROBES, local_fit, local_fit_buffers, local_probe,
    n_probes)
from pyabc_tpu_torch.models import gaussian  # noqa: E402
from pyabc_tpu_torch.transition import LocalTransition  # noqa: E402

torch.set_num_threads(2)

CV_RTOL = 1e-4
NOISE_SD, X_OBS = 0.5, 1.0
POST_MU = gaussian.conjugate_posterior(X_OBS, noise_sd=NOISE_SD)[0]


def _population(seed, n_cap, d, n_live, n_distinct=None):
    """A fitted population: n_live weighted rows (of n_distinct distinct
    values, repeated, where given), the rest empty."""
    rng = np.random.default_rng(seed)
    th = np.zeros((n_cap, d), np.float32)
    base = rng.normal(size=(n_distinct or n_live, d)) * np.linspace(
        0.5, 2.0, d) + 1.0
    th[:n_live] = base[np.arange(n_live) % len(base)]
    w = np.zeros(n_cap, np.float32)
    w[:n_live] = rng.random(n_live) + 0.1
    return th, w / w.sum()


def _jax_fit(th, w, dim, statics):
    return JLocal.device_fit(jnp.asarray(th), jnp.asarray(w), dim=dim,
                             **statics)


def _port_ancestors(params, nb, seed=5, generation=3):
    """K16's draw on the fit's ancestor cdf -> (nb, n_cap) int32."""
    idx, _state = bootstrap_cv.draw(
        params["cdf"][None].contiguous(), n_boot=nb, seed=seed,
        generation=generation, max_rounds=256, min_n=0, max_n=0)
    return idx[0]


def _jax_local_cv(jp, idx, n, dim, statics):
    """``transition/util.py:162-186`` with LocalTransition, on the given
    ancestors: the refits on ``thetas[idx[b]]`` with weight 1/n on the
    first n rows and the CV of the fitted particles' densities."""
    thetas, w = jnp.asarray(jp["thetas"]), jnp.asarray(jp["weights"])
    n_cap = thetas.shape[0]
    boot_w = jnp.where(jnp.arange(n_cap) < n, 1.0 / jnp.maximum(n, 1),
                       0.0).astype(thetas.dtype)
    lds = []
    for b in range(idx.shape[0]):
        p = JLocal.device_fit(thetas[jnp.asarray(idx[b])], boot_w, dim=dim,
                              **statics)
        lds.append(jax.vmap(lambda th, p=p: JLocal.device_logpdf(th, p))(
            thetas))
    logdens = jnp.stack(lds)
    dens = jnp.exp(logdens - logdens.max(axis=0, keepdims=True))
    mean = dens.mean(axis=0)
    std = dens.std(axis=0)
    cvs = jnp.where(mean > 0, std / mean, 0.0)
    return jnp.sum(w * cvs) / jnp.maximum(w.sum(), 1e-38)


def _port_local_cv(params, idx, n, dim, statics):
    """One probe of K16's LocalTransition mode at n on one model
    (``bootstrap_cv.local_probe``: the gather, K12 and K13, the local
    density) -> the weighted mean CV its partial sums hold."""
    n_cap, d = params["thetas"].shape
    thetas = params["thetas"][None].contiguous()
    state = torch.tensor([n, n, n, 0, 0], dtype=torch.int32)
    partial = local_probe(
        thetas, params["weights"][None].contiguous(), idx[None], state,
        local_fit_buffers(1, idx.shape[0], n_cap, d, "cpu"), dims=[dim],
        configs=[LocalTransition.field_config(n_cap, dim, **statics)])[0]
    return partial[:, 0].sum() / partial[:, 1].sum().clamp_min(1e-38)


# ------------------------------------------------------------ K16's CV
#: (d, n_cap, weighted rows, distinct values, n, device_fit's keywords):
#: both selections, the diff and the norm distance form (block_rows below
#: n_cap tiles the JAX package's field and selects the port's norm form),
#: n below n_cap and at it, and duplicate-heavy resamples (30 distinct
#: values: every bootstrap repeats each about n / 30 times, so equal
#: distances sit at the radius)
CV_CASES = {
    "topk": (2, 128, 120, None, 48, dict(scaling=1.0, k_cap=30,
                                         k_fraction=0.25)),
    "topk_at_n_cap": (2, 128, 128, None, 128,
                      dict(scaling=1.0, k_cap=32, k_fraction=0.25)),
    "threshold": (3, 128, 128, None, 60,
                  dict(scaling=1.0, k_cap=32, k_fraction=0.25,
                       selection="threshold")),
    "threshold_stride4": (2, 256, 240, None, 100,
                          dict(scaling=1.0, k_cap=64, k_fraction=0.25,
                               selection="threshold", bisect_stride=4)),
    "norm_form": (2, 256, 256, None, 120,
                  dict(scaling=1.0, k_cap=64, k_fraction=0.25,
                       block_rows=64)),
    "duplicates_topk": (2, 128, 128, 30, 64,
                        dict(scaling=1.0, k_cap=32, k_fraction=0.25)),
    "duplicates_threshold": (2, 128, 128, 30, 64,
                             dict(scaling=1.0, k_cap=32, k_fraction=0.25,
                                  selection="threshold")),
    "duplicates_norm_form": (2, 256, 256, 30, 128,
                             dict(scaling=1.0, k_cap=64, k_fraction=0.25,
                                  selection="threshold", block_rows=64)),
}


@pytest.mark.parametrize("case", sorted(CV_CASES))
def test_local_cv_matches_jax(case):
    d, n_cap, n_live, distinct, n, statics = CV_CASES[case]
    nb = 4
    th, w = _population(30 + len(case), n_cap, d, n_live, distinct)
    jp = jax.tree.map(np.asarray, _jax_fit(th, w, d, statics))
    params = convert.local_transition_params(jp, device="cpu")
    idx = _port_ancestors(params, nb)
    ref = float(_jax_local_cv(jp, idx.numpy(), n, d, statics))
    got = float(_port_local_cv(params, idx, n, d, statics))
    assert np.isfinite(ref) and ref > 0
    assert got == pytest.approx(ref, rel=CV_RTOL)


@pytest.mark.parametrize("case", ["topk", "threshold_stride4", "norm_form",
                                  "duplicates_threshold",
                                  "duplicates_norm_form"])
def test_bootstrap_fits_match_jax(case):
    """K16's gather, K12 and K13 on the resampled rows equal the JAX
    package's ``device_fit`` on ``thetas[idx[b]]``: selections, factors
    and densities."""
    d, n_cap, n_live, distinct, n, statics = CV_CASES[case]
    nb = 3
    th, w = _population(30 + len(case), n_cap, d, n_live, distinct)
    jp = jax.tree.map(np.asarray, _jax_fit(th, w, d, statics))
    params = convert.local_transition_params(jp, device="cpu")
    idx = _port_ancestors(params, nb, seed=9)
    state = torch.tensor([n, n, n, 0, 0], dtype=torch.int32)
    thetas = params["thetas"][None]
    rows, boot_w, go = bootstrap_cv.local_gather(thetas, idx[None], state)
    assert int(go) == 1
    np.testing.assert_array_equal(rows.numpy(),
                                  jp["thetas"][idx.numpy()])
    fits = local_fit(rows, boot_w, go, state,
                     local_fit_buffers(1, nb, n_cap, d, "cpu"), dims=[d],
                     configs=[LocalTransition.field_config(n_cap, d,
                                                           **statics)])
    boot_wj = jnp.where(jnp.arange(n_cap) < n, 1.0 / max(n, 1), 0.0
                        ).astype(jnp.float32)
    np.testing.assert_array_equal(boot_w.numpy(), np.asarray(boot_wj))
    for b in range(nb):
        ref = jax.tree.map(np.asarray, JLocal.device_fit(
            jnp.asarray(jp["thetas"][idx[b].numpy()]), boot_wj, dim=d,
            **statics))
        np.testing.assert_array_equal(fits["thetas"][b].numpy(),
                                      ref["thetas"])
        np.testing.assert_allclose(fits["weights"][b].numpy(),
                                   ref["weights"], rtol=1e-6)
        np.testing.assert_allclose(fits["chols"][b].numpy(), ref["chols"],
                                   atol=1e-5, rtol=1e-4)
        np.testing.assert_allclose(fits["logdets"][b].numpy(),
                                   ref["logdets"], atol=1e-4, rtol=1e-4)
        scale = np.abs(ref["precs"]).reshape(n_cap, -1).max(axis=1)
        err = np.abs(fits["precs"][b].numpy() - ref["precs"]).reshape(
            n_cap, -1).max(axis=1)
        assert np.all(err <= 1e-3 * scale)
    # the density entry's log-densities are K14's on each fit
    partial, ld = bootstrap_cv.local_density(
        thetas, params["weights"][None], fits, state, want_ld=True)
    from pyabc_tpu_torch.kernels.local_logpdf import local_logpdf
    live = params["weights"] > 0
    for b in range(nb):
        want = local_logpdf(params["thetas"], {
            k: fits[k][b] for k in ("thetas", "precs", "lconst",
                                    "weights")})
        assert torch.equal(ld[b][live], want[live])
    assert partial.shape == (1, 1, 2)


def test_done_probe_does_nothing():
    """A probe whose state reads done gathers nothing (go 0, zero
    bootstrap weights), fits nothing and adds nothing to the CV."""
    d, n_cap = 2, 64
    th, w = _population(3, n_cap, d, 60)
    params = LocalTransition.device_fit(torch.tensor(th), torch.tensor(w),
                                        dim=d, scaling=1.0, k_cap=16)
    idx = _port_ancestors(params, 2)
    state = torch.tensor([10, 40, 40, 1, 3], dtype=torch.int32)
    rows, boot_w, go = bootstrap_cv.local_gather(params["thetas"][None],
                                                 idx[None], state)
    assert int(go) == 0 and float(boot_w.abs().sum()) == 0.0
    fits = local_fit_buffers(1, 2, n_cap, d, "cpu")
    local_fit(rows, boot_w, go, state, fits, dims=[d],
              configs=[LocalTransition.field_config(n_cap, d, scaling=1.0,
                                                    k_cap=16)])
    assert all(float(v.abs().sum()) == 0 for v in fits.values())
    part = bootstrap_cv.local_density(params["thetas"][None],
                                      params["weights"][None], fits, state)
    assert float(part.abs().sum()) == 0.0


def test_local_bisection_matches_jax():
    """K16's LocalTransition pipeline (gather, K12, K13, local density,
    bisect) over the port's ancestors ends at the n of the JAX package's
    ``device_required_nr`` over the JAX formula on the same ancestors,
    with a target that the CV meets below max_n."""
    d, n_cap, nb = 2, 128, 3
    statics = dict(scaling=1.0, k_cap=32, k_fraction=0.25)
    th, w = _population(41, n_cap, d, n_cap)
    jp = jax.tree.map(np.asarray, _jax_fit(th, w, d, statics))
    params = convert.local_transition_params(jp, device="cpu")
    idx = _port_ancestors(params, nb, seed=7)
    cv64 = float(_jax_local_cv(jp, idx.numpy(), 64, d, statics))
    min_n, max_n = 10, n_cap
    ref = int(jutil.device_required_nr(
        lambda nn: _jax_local_cv(jp, idx.numpy(), nn, d, statics),
        target_cv=cv64, min_n=min_n, max_n=max_n))
    assert min_n < ref < max_n
    state = torch.tensor([min_n, max_n, max_n, 0, 0], dtype=torch.int32)
    cvs = torch.zeros(MAX_PROBES)
    thetas, weights = params["thetas"][None], params["weights"][None]
    fits = local_fit_buffers(1, nb, n_cap, d, "cpu")
    configs = [LocalTransition.field_config(n_cap, d, **statics)]
    for _ in range(n_probes(min_n, max_n)):
        rows, boot_w, go = bootstrap_cv.local_gather(thetas, idx[None],
                                                     state)
        local_fit(rows, boot_w, go, state, fits, dims=[d], configs=configs)
        part = bootstrap_cv.local_density(thetas, weights, fits, state)
        bootstrap_cv.bisect(part, state, cvs, model_p=None, target=cv64)
    assert int(state[DONE]) == 1 and int(state[HI]) == ref


def _jax_aggregate_local_cv(fits, probs, idx, n, dims, statics):
    """``inference/util.py:2112-2134``'s model-weighted CV over the port's
    ancestors of each model."""
    probs_sum = max(float(probs.sum()), 1e-38)
    tot = 0.0
    for k, fit in enumerate(fits):
        if probs[k] > 0:
            tot += probs[k] / probs_sum * float(_jax_local_cv(
                fit, idx[k], n, dims[k], statics))
    return tot


@pytest.mark.parametrize("n", [12, 60])
def test_model_weighted_local_cv_matches_jax(n):
    """K = 3 (dims 1, 2, 2 on d_max 2) with model 1 dead: K16's
    LocalTransition mode weights the models' CVs by their probabilities
    and adds nothing for the dead model, as the JAX package's sum."""
    n_cap, nb, K, dims = 96, 3, 3, [1, 2, 2]
    statics = dict(scaling=1.0, k_cap=24, k_fraction=0.25)
    rng = np.random.default_rng(23)
    th = (rng.normal(size=(n_cap, 2)) + 1.0).astype(np.float32)
    m = (np.arange(n_cap) % K).astype(np.int32)
    m[m == 1] = 2
    th[m == 0, 1] = 0.0
    w = (rng.random(n_cap) + 0.1).astype(np.float32)
    w /= w.sum()
    fits = []
    for k in range(K):
        wk = np.where(m == k, w, 0.0).astype(np.float32)
        fits.append(jax.tree.map(np.asarray, JLocal.device_fit(
            jnp.asarray(th), jnp.asarray(wk), dim=dims[k], **statics)))
    # the dead model carries the never-fitted placeholder (a refit below
    # dim + 1 rows keeps the old params; a fit of no rows would read NaN
    # weights in XLA, which flushes the 1e-38 floor to 0)
    fits[1] = {**jax.tree.map(np.zeros_like, fits[1]), "dim": fits[1]["dim"]}
    probs = np.array([w[m == k].sum() for k in range(K)], np.float32)
    params = convert.stacked_local_transition_params(fits, device="cpu")
    idx, state = bootstrap_cv.draw(params["cdf"], n_boot=nb, seed=5,
                                   generation=2, max_rounds=256, min_n=10,
                                   max_n=n_cap)
    ref = _jax_aggregate_local_cv(fits, probs, idx.numpy(), n, dims,
                                  statics)
    state = torch.tensor([10, n_cap, n, 0, 0], dtype=torch.int32)
    rows, boot_w, go = bootstrap_cv.local_gather(params["thetas"], idx,
                                                 state)
    fit = local_fit(rows, boot_w, go, state,
                    local_fit_buffers(K, nb, n_cap, 2, "cpu"), dims=dims,
                    configs=[LocalTransition.field_config(n_cap, dk,
                                                          **statics)
                             for dk in dims])
    part = bootstrap_cv.local_density(params["thetas"], params["weights"],
                                      fit, state)
    assert float(part[1].abs().sum()) == 0.0  # the dead model adds nothing
    cvs = torch.zeros(MAX_PROBES)
    bootstrap_cv.bisect(part, state, cvs, model_p=torch.from_numpy(probs),
                        target=1e9)
    assert float(cvs[0]) == pytest.approx(ref, rel=CV_RTOL)


# ----------------------------------------------------------- whole runs
def _counts(h):
    s = h.get_nr_particles_per_population()
    return [int(v) for v in s[s.index >= 0]]


def _mean(h, m=0):
    df, w = h.get_distribution(m)
    return float(np.sum(df["theta"] * w))


APS = dict(start_nr_particles=150, mean_cv=0.5, min_population_size=20,
           max_population_size=600, n_bootstrap=5)
SCHEDULE = (200, 300, 150, 250, 100)


def _toy(pkg, seed, population_size, gens=5):
    if pkg == "jax":
        @jpt.JaxModel.from_function(["theta"], name="gauss")
        def model(key, theta):
            return {"x": theta[0] + NOISE_SD * jax.random.normal(key)}

        abc = jpt.ABCSMC(
            model, jpt.Distribution(theta=jpt.RV("norm", 0.0, 1.0)),
            jpt.PNormDistance(p=2), population_size=population_size(jpt),
            eps=jpt.MedianEpsilon(), seed=seed, fused_generations=3,
            transitions=jpt.LocalTransition(k_fraction=0.3))
        assert abc._fused_chunk_capable()
    else:
        abc = tpt.ABCSMC(
            gaussian.make_mean_only_model(noise_sd=NOISE_SD),
            gaussian.mean_only_prior(), tpt.PNormDistance(p=2),
            population_size=population_size(tpt), eps=tpt.MedianEpsilon(),
            seed=seed, fused_generations=3,
            transitions=tpt.LocalTransition(k_fraction=0.3), device="cpu")
    abc.new("sqlite://", {"x": X_OBS})
    return abc.run(max_nr_populations=gens)


@pytest.fixture(scope="module")
def adaptive_runs():
    """The JAX suite's adaptive-local run
    (``tests/test_population_strategy.py:334-351``) in both packages."""
    return {pkg: _toy(pkg, 11, lambda mod: mod.AdaptivePopulationSize(
        **APS)) for pkg in ("port", "jax")}


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_adaptive_local_meets_the_jax_rules(adaptive_runs, pkg):
    h = adaptive_runs[pkg]
    ns = _counts(h)
    assert len(ns) == 5 and ns[0] == 150
    assert any(n != 150 for n in ns[1:])
    assert all(20 <= n <= 600 for n in ns)
    assert _mean(h) == pytest.approx(POST_MU, abs=0.35)


def test_adaptive_local_agrees_with_jax(adaptive_runs):
    """The posterior means within 0.35 of each other, and K16's telemetry:
    n_next is the next n, the probes that did work within the bisection's
    count."""
    h = adaptive_runs["port"]
    assert _mean(h) == pytest.approx(_mean(adaptive_runs["jax"]), abs=0.35)
    ns = _counts(h)
    tel = [h.get_telemetry(t) for t in range(len(ns))]
    assert [x["n_next"] for x in tel[:-1]] == ns[1:]
    assert "k16_probes" not in tel[-1]
    assert all(1 <= x["k16_probes"] <= n_probes(20, 600) for x in tel[:-1])


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_list_population_size_under_local_transition(pkg):
    """``tests/test_fused.py:480-492`` with a LocalTransition: the stored
    counts are the schedule, the posterior mean within 0.35."""
    h = _toy(pkg, 4, lambda mod: mod.ListPopulationSize(list(SCHEDULE)))
    assert _counts(h) == list(SCHEDULE)
    assert _mean(h) == pytest.approx(POST_MU, abs=0.35)


def test_local_k_bound_comes_from_the_largest_n():
    """K12's k bound is the rule at the run's largest n (the schedule's or
    the adaptive cap's, JAX ``smc.py:2344-2368`` with n_max), not at the
    first generation's."""
    abc = tpt.ABCSMC(gaussian.make_mean_only_model(),
                     gaussian.mean_only_prior(), tpt.PNormDistance(p=2),
                     population_size=tpt.ListPopulationSize([100, 800]),
                     transitions=tpt.LocalTransition(k_fraction=0.25),
                     device="cpu")
    abc.new("sqlite://", {"x": X_OBS})
    ctx = abc._build_context(abc._n_max(), 0.0)
    assert ctx.local_configs[0]["k_cap"] == 200
    assert ctx.local_configs[0]["topk"]
