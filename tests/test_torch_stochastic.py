"""Port parity for noisy ABC (BASELINE config 4): K21a (the noise kernel's
log-density, the stochastic accept test and the log weight) against the
JAX package's ``StochasticAcceptor.device_fn`` composed with
``IndependentNormalKernel.device_fn``; the noise kernel and acceptor on
the host; the whole fused path on the CPU against the analytic posterior
of the noisy Gaussian anchor and against the JAX package's runs.

JAX draws the accept uniforms from its own key, so the accept decision is
checked by feeding the port's Philox uniforms into JAX's formula
``log(u) < log_ratio``.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import pyabc_tpu as jpt  # noqa: E402
from pyabc_tpu.acceptor import pdf_norm as jpdf  # noqa: E402
from pyabc_tpu.distance import kernel as jkernel  # noqa: E402
from pyabc_tpu.epsilon import temperature as jtemp  # noqa: E402
from pyabc_tpu.models import sir as jsir  # noqa: E402
import pyabc_tpu_torch as pt  # noqa: E402
from pyabc_tpu_torch import convert  # noqa: E402
from pyabc_tpu_torch.core.sumstat_spec import SumStatSpec  # noqa: E402
from pyabc_tpu_torch.kernels import kernel_accept, philox  # noqa: E402
from pyabc_tpu_torch.kernels.kernel_accept import (  # noqa: E402
    accept_uniforms)
from pyabc_tpu_torch.models import sir  # noqa: E402

torch.set_num_threads(1)

NOISE_VAR, X_OBS = 0.09, 0.8
#: the anchor's exact posterior: N(0.7339, 0.2874^2)
POST_VAR = 1.0 / (1.0 + 1.0 / NOISE_VAR)
POST_MU, POST_SD = POST_VAR * X_OBS / NOISE_VAR, float(np.sqrt(POST_VAR))


# ------------------------------------------------------------------ K21a
def _round(B=96, S=15, seed=0):
    rng = np.random.default_rng(seed)
    x0 = rng.normal(50.0, 30.0, S).astype(np.float32)
    ss = (x0 + rng.normal(0.0, 12.0, (B, S))).astype(np.float32)
    ss[:8] = x0  # at the observation: v = pdf_max
    var = rng.uniform(50.0, 150.0, S).astype(np.float32)
    return ss, x0, var


def _jax_lanes(ss, x0, var, temp, pdf_norm, scale):
    spec = jpt.SumStatSpec({"infected": np.zeros(ss.shape[1])})
    kern = jkernel.IndependentNormalKernel(var=var)
    kern.ret_scale = scale
    acc = jpt.StochasticAcceptor()
    acc._kernel = kern
    fn = acc.device_fn(kern.device_fn(spec))
    keys = jax.random.split(jax.random.key(0), ss.shape[0])
    v, _a, log_acc_w = jax.vmap(
        lambda k, x: fn(k, x, jnp.asarray(x0), jnp.float32(temp),
                        jnp.asarray(var), jnp.float32(pdf_norm)))(
        keys, jnp.asarray(ss))
    v = np.asarray(v)
    logv = (np.log(np.maximum(v, np.float32(1e-30))) if scale == jkernel.
            SCALE_LIN else v)
    return v, (logv - np.float32(pdf_norm)) / np.float32(temp), \
        np.asarray(log_acc_w)


@pytest.mark.parametrize("scale", ["SCALE_LOG", "SCALE_LIN"])
@pytest.mark.parametrize("temp", [1.0, 37.5])
def test_kernel_accept_matches_jax(scale, temp):
    ss, x0, var = _round()
    pdf_norm = np.float32(-0.5 * np.sum(np.log(2 * np.pi) + np.log(var)))
    if scale == "SCALE_LIN":
        pdf_norm = np.float32(-60.0)
    v_j, ratio_j, law_j = _jax_lanes(ss, x0, var, temp, pdf_norm, scale)
    stream = philox.PhiloxStream(9, 3, philox.ACCEPT, 256,
                                 torch.tensor([0, 2, 0, 0],
                                              dtype=torch.int32))
    valid = torch.ones(len(ss), dtype=torch.bool)
    v, accept, lw = kernel_accept(
        torch.from_numpy(ss), torch.from_numpy(x0), torch.from_numpy(var),
        torch.tensor(temp), torch.tensor(pdf_norm), valid, stream=stream,
        lin=scale == "SCALE_LIN", apply_iw=True)
    # the same float32 terms summed in another order: rel 1e-5
    np.testing.assert_allclose(v.numpy(), v_j, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(lw.numpy(), law_j, rtol=1e-5, atol=1e-5)
    # the port's uniforms in JAX's rule, where log u lies clear of the
    # ratio's rounding
    logu = np.log(accept_uniforms(stream, len(ss)).numpy())
    clear = np.abs(logu - ratio_j) > 1e-4 * (1 + np.abs(ratio_j))
    np.testing.assert_array_equal(accept.numpy()[clear],
                                  (logu < ratio_j)[clear])
    if scale == "SCALE_LOG" and temp == 1.0:
        # at the observation log_ratio is 0: accepted, importance weight 0
        assert accept[:8].all() and (lw[:8].abs() < 1e-4).all()
        assert 0 < int(accept.sum()) < len(ss)


def test_kernel_accept_transition_weights_and_invalid_lanes():
    ss, x0, var = _round(B=64, seed=1)
    pdf_norm = np.float32(-70.0)  # below every v at the observation
    _v, _r, law_j = _jax_lanes(ss, x0, var, 20.0, pdf_norm, "SCALE_LOG")
    rng = np.random.default_rng(2)
    logpri = rng.normal(size=64).astype(np.float32)
    logq = rng.normal(size=64).astype(np.float32)
    valid = torch.from_numpy(rng.random(64) > 0.2)
    stream = philox.PhiloxStream(9, 3, philox.ACCEPT, 256,
                                 torch.zeros(4, dtype=torch.int32))
    _v, accept, lw = kernel_accept(
        torch.from_numpy(ss), torch.from_numpy(x0), torch.from_numpy(var),
        torch.tensor(20.0), torch.tensor(pdf_norm), valid, stream=stream,
        lin=False, apply_iw=True, logpri=torch.from_numpy(logpri),
        logq=torch.from_numpy(logq))
    # _lane_transition: (log model prior + logpri + log_acc_w - log model
    # factor) - logq with K = 1, -inf where invalid, accept & valid
    want = np.where(valid.numpy(), (logpri + law_j) - logq, -np.inf)
    np.testing.assert_allclose(lw.numpy(), want, rtol=1e-5, atol=1e-5)
    assert not accept[~valid].any()
    assert (law_j[:8] > 0).all()  # above the norm: weighted, not capped
    # without importance weighting the excess is dropped
    _v, _a, lw0 = kernel_accept(
        torch.from_numpy(ss), torch.from_numpy(x0), torch.from_numpy(var),
        torch.tensor(20.0), torch.tensor(pdf_norm), valid, stream=stream,
        lin=False, apply_iw=False)
    np.testing.assert_array_equal(lw0[valid].numpy(), 0.0)


# ------------------------------------------------------------ host objects
def test_noise_kernel_and_acceptor_match_jax_on_the_host():
    obs = {"infected": np.linspace(1.0, 30.0, 15)}
    x = {"infected": obs["infected"] + np.arange(15) * 0.5}
    kern, jkern = (pt.IndependentNormalKernel(var=[4.0] * 15),
                   jpt.IndependentNormalKernel(var=[4.0] * 15))
    kern.initialize(SumStatSpec(obs))
    jkern.initialize(0, None, obs)
    assert kern.pdf_max == pytest.approx(jkern.pdf_max, rel=1e-12)
    assert kern(x, obs) == pytest.approx(jkern(x, obs), rel=1e-12)
    np.testing.assert_array_equal(
        kern.device_params("cpu").numpy(),
        np.asarray(jkern.device_params(), np.float32))
    # the acceptor's host recursion over the same kernel values
    vals = {"distance": np.array([-40.0, -35.5, -38.0])}
    for meth in ("max_found", "scaled"):
        acc = pt.StochasticAcceptor(
            pt.ScaledPDFNorm() if meth == "scaled" else
            pt.pdf_norm_max_found)
        jacc = jpt.StochasticAcceptor(
            jpdf.ScaledPDFNorm() if meth == "scaled"
            else jpdf.pdf_norm_max_found)
        for a, k in ((acc, kern), (jacc, jkern)):
            a.initialize(0, lambda: vals, k)
            a.update(1, lambda: {"distance": vals["distance"] + 3.0})
        assert acc.pdf_norms == jacc.pdf_norms
        assert acc._max_found == jacc._max_found
        assert acc.get_epsilon_config(1) == jacc.get_epsilon_config(1)


@pytest.mark.parametrize("what", ["callable var", "keys"])
def test_what_is_not_ported_raises(what):
    with pytest.raises(NotImplementedError, match="item 11"):
        if what == "callable var":
            pt.IndependentNormalKernel(var=lambda par: [1.0])
        else:
            pt.IndependentNormalKernel(keys=["x"])


def test_sanity_pairing_as_the_jax_package():
    model, prior = _det_model(), _prior()
    with pytest.raises(ValueError, match="StochasticKernel"):
        pt.ABCSMC(model, prior, pt.PNormDistance(), eps=pt.Temperature(),
                  acceptor=pt.StochasticAcceptor(), device="cpu")
    with pytest.raises(ValueError, match="Temperature"):
        pt.ABCSMC(model, prior, pt.IndependentNormalKernel(),
                  eps=pt.MedianEpsilon(), acceptor=pt.StochasticAcceptor(),
                  device="cpu")
    with pytest.raises(NotImplementedError, match="item 11"):
        pt.ABCSMC(model, prior, pt.IndependentNormalKernel(),
                  eps=pt.Temperature(), device="cpu")


# --------------------------------------------------------- the whole path
def _det_model():
    return pt.TorchModel(lambda theta, gen: {"x": theta[:, 0]}, ["theta"],
                         name="det")


def _prior():
    return pt.Distribution(theta=pt.RV("norm", 0.0, 1.0))


def _anchor(seed, eps=None, pop=1000, **kw):
    abc = pt.ABCSMC(_det_model(), _prior(),
                    pt.IndependentNormalKernel(var=[NOISE_VAR]),
                    population_size=pop,
                    eps=eps if eps is not None else pt.Temperature(),
                    acceptor=pt.StochasticAcceptor(), seed=seed,
                    device="cpu", **kw)
    abc.new("sqlite://", {"x": X_OBS})
    return abc


def _jax_anchor(seed, eps, pop=400):
    @jpt.JaxModel.from_function(["theta"], name="det")
    def model(key, theta):
        return {"x": theta[0]}

    abc = jpt.ABCSMC(model, jpt.Distribution(theta=jpt.RV("norm", 0.0, 1.0)),
                     jpt.IndependentNormalKernel(var=[NOISE_VAR]),
                     population_size=pop, eps=eps,
                     acceptor=jpt.StochasticAcceptor(), seed=seed)
    abc.new("sqlite://", {"x": X_OBS})
    return abc


def _moments(h, t=None):
    df, w = h.get_distribution(t=t) if t is not None else \
        h.get_distribution()
    x = np.asarray(df["theta"])
    mu = float(np.sum(w * x))
    return mu, float(np.sqrt(np.sum(w * (x - mu) ** 2)))


@pytest.fixture(scope="module")
def anchor_run():
    abc = _anchor(seed=3)
    return abc, abc.run(max_nr_populations=7)


def test_noisy_anchor_posterior_is_the_exact_one(anchor_run):
    abc, h = anchor_run
    temps = [float(x) for x in h.get_all_populations()["epsilon"][1:]]
    # the default minimum_epsilon stops a Temperature run at T = 1
    assert temps[-1] == 1.0 and temps[0] > 1.0
    assert all(b <= a for a, b in zip(temps, temps[1:]))
    mu, sd = _moments(h)
    # pop 1000 at T = 1: the seed-to-seed sd of the mean is about 0.011
    assert abs(mu - POST_MU) < 0.05 and abs(sd - POST_SD) < 0.05
    # host objects mirror the device trail and norms
    assert [abc.eps.temperatures[t] for t in range(len(temps))] == \
        pytest.approx(temps, rel=1e-6)
    assert abc.acceptor.pdf_norms[0] == pytest.approx(
        -0.5 * (np.log(2 * np.pi) + np.log(NOISE_VAR)), rel=1e-6)
    assert np.isfinite(abc.acceptor._max_found)
    # one counter read per round plus one fetch per chunk: no host read
    # for the temperature, the norm or the calibration
    rounds = sum(g["rounds"] for g in abc.generation_log)
    cal_rounds = abc.sync_ledger.summary()["by_kind"]["round_counters"] \
        - rounds
    assert abc.sync_ledger.summary()["by_kind"] == {
        "round_counters": rounds + cal_rounds, "chunk_fetch": 1}
    assert cal_rounds >= 1


def test_noisy_anchor_exp_decay_trail_tracks_jax():
    """ExpDecayFixedIterScheme from T0 = 64 is deterministic: both
    packages' trails agree within 1e-3 relative."""
    h = _anchor(seed=7, pop=300, eps=pt.Temperature(
        schemes=[pt.ExpDecayFixedIterScheme()], initial_temperature=64.0)
    ).run(max_nr_populations=7)
    hj = _jax_anchor(seed=7, pop=300, eps=jpt.Temperature(
        schemes=[jtemp.ExpDecayFixedIterScheme()], initial_temperature=64.0)
    ).run(max_nr_populations=7)
    port = [float(x) for x in h.get_all_populations()["epsilon"][1:]]
    ref = [float(x) for x in hj.get_all_populations()["epsilon"][1:]]
    assert len(port) == len(ref) == 7 and port[-1] == 1.0
    np.testing.assert_allclose(port, ref, rtol=1e-3)


def test_noisy_anchor_default_trail_follows_the_min_rule(anchor_run):
    """Under the default schemes each temperature is at most the ExpDecay
    step from the one before (the min over the proposals), as in the JAX
    package, whose trail from its own calibration is run beside it."""
    abc, h = anchor_run
    temps = [float(x) for x in h.get_all_populations()["epsilon"][1:]]
    n = 7
    for t, (a, b) in enumerate(zip(temps, temps[1:]), start=1):
        t_to_go = n - t
        bound = 1.0 if t_to_go <= 1 else a ** ((t_to_go - 1) / t_to_go)
        assert b <= bound * (1 + 1e-5)
    hj = _jax_anchor(seed=3, eps=jpt.Temperature(), pop=1000).run(
        max_nr_populations=7)
    ref = [float(x) for x in hj.get_all_populations()["epsilon"][1:]]
    # both calibrate T0 from a prior sample of 1000 at a 0.3 target rate
    assert 1.0 < ref[0] < 4.0 and 1.0 < temps[0] < 4.0
    assert ref[-1] == temps[-1] == 1.0
    mu_j, _sd = _moments(hj)
    assert abs(mu_j - POST_MU) < 0.05


def test_list_temperature_ladder_comes_from_the_host():
    abc = _anchor(seed=1, eps=pt.ListTemperature([8.0, 3.0, 1.0]), pop=400)
    h = abc.run(max_nr_populations=3)
    temps = [float(x) for x in h.get_all_populations()["epsilon"][1:]]
    assert temps == [8.0, 3.0, 1.0]
    assert abc.eps.temperatures == {0: 8.0, 1: 3.0, 2: 1.0}
    assert len(abc.acceptor.pdf_norms) == 4
    # the health word's epsilon-stall window arms for a temperature that
    # adapts to the data, not for a fixed ladder (JAX ``_health_cfg``)
    assert abc._health_config()[2] == 0
    assert _anchor(seed=1)._health_config()[2] == abc.eps_stall_window > 0


def test_sir_config4_tracks_jax_at_pop_200():
    """SIR config 4 (var 100 = the observation's noise, Temperature,
    StochasticAcceptor, 8 generations) at pop 200: both packages' posterior
    means at their last common generation lie within 4 of the larger
    posterior sd of each other, and near TRUE_PARS; the temperature
    trails agree within 10 % (each from its own calibration sample)."""
    obs = sir.observed_data(seed=11)
    abc = pt.ABCSMC(sir.make_sir_model(), sir.default_prior(),
                    pt.IndependentNormalKernel(var=[100.0] * 15),
                    population_size=200, eps=pt.Temperature(),
                    acceptor=pt.StochasticAcceptor(), seed=0, device="cpu")
    abc.new("sqlite://", obs, store_sum_stats=False)
    h = abc.run(max_nr_populations=8)
    jabc = jpt.ABCSMC(jsir.make_sir_model(), jsir.default_prior(),
                      jpt.IndependentNormalKernel(var=[100.0] * 15),
                      population_size=200, eps=jpt.Temperature(),
                      acceptor=jpt.StochasticAcceptor(), seed=0)
    jabc.new("sqlite://", jsir.observed_data(seed=11))
    hj = jabc.run(max_nr_populations=8)
    port = [float(x) for x in h.get_all_populations()["epsilon"][1:]]
    ref = [float(x) for x in hj.get_all_populations()["epsilon"][1:]]
    assert all(b <= a for a, b in zip(port, port[1:]))
    n = min(len(port), len(ref))
    assert n >= 7
    np.testing.assert_allclose(port[:n], ref[:n], rtol=0.1)
    t = n - 1
    df, w = h.get_distribution(t=t)
    dfj, wj = hj.get_distribution(0, t)
    for k, true in sir.TRUE_PARS.items():
        mu, mu_j = float(np.sum(df[k] * w)), float(np.sum(dfj[k] * wj))
        sd = max(float(np.sqrt(np.sum(w * (df[k] - mu) ** 2))),
                 float(np.sqrt(np.sum(wj * (dfj[k] - mu_j) ** 2))))
        assert abs(mu - mu_j) < 4 * sd, k
        assert abs(mu - true) < 0.05, k


def test_convert_carry_takes_the_noisy_slots():
    fit = {k: np.zeros(s, np.float32) for k, s in (
        ("thetas", (4, 1)), ("weights", (4,)), ("chol", (1, 1)),
        ("prec", (1, 1)), ("center", (1,)), ("thetas_c", (4, 1)),
        ("quad", (4,)), ("logdet", ()))}
    fit["weights"][:] = 0.25
    fit["dim"] = np.float32(1)
    jax_carry = ((fit,), np.zeros(1, np.float32), np.array([True]),
                 np.array([NOISE_VAR], np.float32), np.float32(2.5),
                 (np.float32(-0.2), np.float32(-0.3), np.float32(1.75)),
                 np.array(False), (np.float32(3.0), np.int32(1)))
    c = convert.carry(jax_carry, device="cpu")
    assert float(c.eps) == 2.5 and float(c.pdf_norm) == np.float32(-0.2)
    assert float(c.max_found) == np.float32(-0.3)
    assert float(c.daly_k) == 1.75
    assert c.dist_w.tolist() == [np.float32(NOISE_VAR)]
    assert int(c.stall_count) == 1 and float(c.eps_prev) == 3.0


# ------------------------------------------------ the other noise models
C_OBS, A_OBS = (10.0, 6.0, 15.0), (0.3, 0.2, -0.25)
#: family -> (port kernel, JAX kernel, observation): a three-statistic
#: model x_i = c_i exp(a_i theta) observed through each noise model
_COV3 = [[1.0, 0.5, 0.2], [0.5, 1.5, 0.3], [0.2, 0.3, 2.0]]
FAMILIES = {
    "normal": (lambda m: m.NormalKernel(cov=_COV3), (11.0, 6.0, 13.0)),
    "normal-lin": (lambda m: m.NormalKernel(cov=_COV3,
                                            ret_scale="SCALE_LIN"),
                   (11.0, 6.0, 13.0)),
    "laplace": (lambda m: m.IndependentLaplaceKernel(scale=[1.0, 0.8, 1.5]),
                (11.0, 6.0, 13.0)),
    "binomial": (lambda m: m.BinomialKernel(p=0.9), (9.0, 5.0, 12.0)),
    "poisson": (lambda m: m.PoissonKernel(), (11.0, 6.0, 13.0)),
    "poisson-lin": (lambda m: m.PoissonKernel(ret_scale="SCALE_LIN"),
                    (11.0, 6.0, 13.0)),
    "negbin": (lambda m: m.NegativeBinomialKernel(p=0.5), (11.0, 6.0, 13.0)),
    "negbin-mean": (lambda m: m.NegativeBinomialKernel(
        p=0.6, parameterization="mean"), (11.0, 6.0, 13.0)),
}


def _family_runs(family, db="sqlite://", pop=200, gens=4, seed=5):
    make, obs = FAMILIES[family]
    c, a = np.asarray(C_OBS, np.float32), np.asarray(A_OBS, np.float32)
    model = pt.TorchModel(
        lambda theta, gen: {"x": torch.as_tensor(c) * torch.exp(
            torch.as_tensor(a) * theta[:, :1])}, ["theta"], name="counts")
    abc = pt.ABCSMC(model, _prior(), make(pt), population_size=pop,
                    eps=pt.Temperature(schemes=[pt.ExpDecayFixedIterScheme()],
                                       initial_temperature=20.0),
                    acceptor=pt.StochasticAcceptor(), seed=seed,
                    device="cpu")
    abc.new(db, {"x": np.asarray(obs)})
    h = abc.run(max_nr_populations=gens)

    @jpt.JaxModel.from_function(["theta"], name="counts")
    def jmodel(key, theta):
        return {"x": jnp.asarray(c) * jnp.exp(jnp.asarray(a) * theta[0])}

    jk = make(jkernel)
    # the JAX fused path reads NormalKernel.device_params before it
    # initializes the kernel (reference red, ROADMAP queue C): initialize
    # it first, as its own run later does again
    jk.initialize(0, None, {"x": np.asarray(obs)})
    jabc = jpt.ABCSMC(jmodel, jpt.Distribution(theta=jpt.RV("norm", 0.0,
                                                            1.0)),
                      jk, population_size=pop,
                      eps=jpt.Temperature(
                          schemes=[jtemp.ExpDecayFixedIterScheme()],
                          initial_temperature=20.0),
                      acceptor=jpt.StochasticAcceptor(), seed=seed)
    jabc.new("sqlite://", {"x": np.asarray(obs)})
    return abc, h, jabc.run(max_nr_populations=gens), jk


def _exact_mean(jk, family):
    """The exact posterior mean of theta on a grid: the N(0, 1) prior
    times the JAX kernel's host density of the observation."""
    _make, obs = FAMILIES[family]
    grid = np.linspace(-6.0, 6.0, 6001)
    c, a = np.asarray(C_OBS), np.asarray(A_OBS)
    val = np.array([jk(c * np.exp(a * th), np.asarray(obs)) for th in grid])
    logp = (np.log(np.maximum(val, 1e-300)) if jk.ret_scale == "SCALE_LIN"
            else val) - 0.5 * grid ** 2
    w = np.exp(logp - logp.max())
    w /= w.sum()
    mu = float(np.sum(w * grid))
    return mu, float(np.sqrt(np.sum(w * (grid - mu) ** 2)))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_each_noise_model_runs_the_fused_path_as_jax(family, tmp_path):
    """A fused noisy run for each noise model in both packages: the
    temperature trails (exponential decay from T0 = 20 to T = 1) agree
    within 1e-3 relative, the norms follow the kernel's pdf_max (or the
    running maximum for the negative binomial), the weighted posterior
    means at T = 1 lie within 0.25 of each other (pop 200) and the port's
    near the exact posterior mean (a grid over the JAX kernel's host
    density), and the port's History opens in the JAX package's."""
    db = "sqlite:///" + str(tmp_path / "port.db")
    abc, h, hj, jk = _family_runs(family, db)
    jh = jpt.History(db)
    assert jh.max_t == h.max_t
    np.testing.assert_array_equal(jh.get_all_populations()["epsilon"],
                                  h.get_all_populations()["epsilon"])
    df_j, w_j = jh.get_distribution(0, h.max_t)
    df_t, w_t = h.get_distribution(0, h.max_t)
    np.testing.assert_array_equal(df_j.to_numpy(), df_t.to_numpy())
    np.testing.assert_allclose(w_j, w_t, rtol=1e-12)
    port = [float(x) for x in h.get_all_populations()["epsilon"][1:]]
    ref = [float(x) for x in hj.get_all_populations()["epsilon"][1:]]
    assert len(port) == len(ref) == 4 and port[-1] == ref[-1] == 1.0
    np.testing.assert_allclose(port[:2], ref[:2], rtol=1e-3)
    np.testing.assert_allclose(port, ref, rtol=1e-3)
    kern = abc.distance_function
    norms = list(abc.acceptor.pdf_norms.values())
    if kern.pdf_max is None:
        assert all(np.isfinite(norms))
        assert norms == sorted(norms)  # the running maximum found
    else:
        want = (np.log(kern.pdf_max) if kern.ret_scale == "SCALE_LIN"
                else kern.pdf_max)
        assert norms == pytest.approx([want] * len(norms), abs=1e-6)
    mu, _sd = _moments(h)
    mu_j, _sd_j = _moments(hj, t=hj.max_t)
    assert abs(mu - mu_j) < 0.25, (mu, mu_j)
    # and the port's mean within 4 Monte Carlo sd (the exact posterior sd
    # over the root of the population's ESS) of the exact one
    mu_x, sd_x = _exact_mean(jk, family)
    _df, w = h.get_distribution(t=h.max_t)
    ess = 1.0 / float(np.sum((w / w.sum()) ** 2))
    assert abs(mu - mu_x) < 4 * sd_x / np.sqrt(ess), (mu, mu_x, sd_x, ess)
