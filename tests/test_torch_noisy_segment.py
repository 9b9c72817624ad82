"""Noisy early reject: K18's stochastic mode (plain version) and the noisy
segmented run loop against the JAX package on the CPU.

The JAX engine's contract: under a ``StochasticAcceptor`` a candidate
retires only when the noise kernel's log-density upper bound proves that
its pre-committed accept draw cannot pass, so the accepted populations,
their weights and the temperature trail are bit-identical with early
reject on and off. The runs are the JAX package's own noisy configuration
(``tests/test_segment.py::test_stochastic_early_reject_bit_identical``:
birth-death in 5 segments, 100 leaps, 20 observations, ``Temperature
(ExpDecayFixedIterScheme, T0 = 50)``, seed 7, chunks of 4) at pop 64, 4
generations. With the default max-found norm the norm is the kernel's
``pdf_max`` (0 for Poisson), far above any simulation's log-density at S =
20, so T = 1 is out of reach and the run stops where a generation
exhausts its round budget; ``ScaledPDFNorm`` takes both kernels to T = 1.
"""
import functools
import math
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import pyabc_tpu as jpt  # noqa: E402
from pyabc_tpu.acceptor import pdf_norm as jpdf  # noqa: E402
from pyabc_tpu.distance import kernel as jkernel  # noqa: E402
from pyabc_tpu.epsilon import temperature as jtemp  # noqa: E402
from pyabc_tpu.models import gillespie as jg  # noqa: E402
import pyabc_tpu_torch as tpt  # noqa: E402
from pyabc_tpu_torch import convert  # noqa: E402
from pyabc_tpu_torch.core.sumstat_spec import SumStatSpec  # noqa: E402
from pyabc_tpu_torch.epsilon import ExpDecayFixedIterScheme  # noqa: E402
from pyabc_tpu_torch.kernels import (compact_round, kernel_accept,  # noqa
                                     philox, segment_round)
from pyabc_tpu_torch.kernels.segment_round import (  # noqa: E402
    RESOLVED, RETIRED)
from pyabc_tpu_torch.models import gillespie as tg  # noqa: E402

torch.set_num_threads(1)

SMALL = dict(n_leaps=100, n_obs=20)


def _obs():
    return {k: np.asarray(v) for k, v in jg.observed_birth_death(
        segments=5, **SMALL).items()}


def _poisson_obs():
    """The birth-death observation with Poisson noise (numpy, seed 0)."""
    rng = np.random.default_rng(0)
    return {k: rng.poisson(np.maximum(v, 0.0)).astype(np.float64)
            for k, v in _obs().items()}


def _run(kernel, obs, early, scaled=True, max_rounds=None, pop=64,
         seed=7, gens=4):
    acc = tpt.StochasticAcceptor(
        pdf_norm_method=tpt.ScaledPDFNorm() if scaled
        else tpt.pdf_norm_max_found)
    abc = tpt.ABCSMC(
        tg.make_birth_death_model(segments=5, **SMALL),
        tg.birth_death_prior(), kernel, population_size=pop,
        eps=tpt.Temperature(schemes=[ExpDecayFixedIterScheme()],
                            initial_temperature=50.0),
        acceptor=acc, seed=seed, early_reject=early, fused_generations=4,
        device="cpu")
    if max_rounds is not None:
        abc.MAX_ROUNDS = max_rounds
    abc.new("sqlite://", obs)
    return abc, abc.run(max_nr_populations=gens)


def _trail(h):
    return h.get_all_populations()["epsilon"].to_numpy()


CONFIGS = {
    "independent_normal": (lambda: tpt.IndependentNormalKernel(var=4.0),
                           _obs, True),
    "poisson": (tpt.PoissonKernel, _poisson_obs, True),
    # the JAX test's own norm: stops where a generation runs out of rounds
    "independent_normal-max_found": (
        lambda: tpt.IndependentNormalKernel(var=4.0), _obs, False),
}


@functools.lru_cache(maxsize=None)
def _on_off(name):
    make, obs, scaled = CONFIGS[name]
    kw = dict(scaled=scaled, max_rounds=None if scaled else 8)
    return _run(make(), obs(), "auto", **kw), _run(make(), obs(), False,
                                                   **kw)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_on_and_off_are_bit_identical(name):
    (abc_on, h_on), (abc_off, h_off) = _on_off(name)
    assert h_on.max_t == h_off.max_t >= 1
    np.testing.assert_array_equal(_trail(h_on), _trail(h_off))
    for t in range(h_on.max_t + 1):
        d1, w1 = h_on.get_distribution(m=0, t=t)
        d2, w2 = h_off.get_distribution(m=0, t=t)
        np.testing.assert_array_equal(np.asarray(d1), np.asarray(d2))
        np.testing.assert_array_equal(w1, w2)
    assert abc_on.acceptor.pdf_norms == abc_off.acceptor.pdf_norms
    assert abc_on.acceptor._max_found == abc_off.acceptor._max_found
    tel = [h_on.get_telemetry(t) for t in range(h_on.max_t + 1)]
    assert sum(x["retired_early"] for x in tel) > 0
    assert all("retired_early" not in (h_off.get_telemetry(t) or {})
               for t in range(h_off.max_t + 1))
    # one counter read per round plus one fetch per chunk
    rounds = sum(g["rounds"] for g in abc_on.generation_log)
    kinds = abc_on.sync_ledger.summary()["by_kind"]
    assert kinds["chunk_fetch"] == 1
    assert kinds["round_counters"] >= rounds
    if name != "independent_normal-max_found":
        assert _trail(h_on)[-1] == 1.0 and h_on.max_t == 3


def test_posterior_mean_against_the_jax_classic_run():
    """At T = 1 both packages sample the exact posterior of the noise
    model: the port's (early reject on) and the JAX package's classic
    weighted means at pop 64 lie within 0.35 (a few Monte Carlo sd at
    this population) in log_b and log_d."""
    (_abc_on, h_on), _off = _on_off("independent_normal")
    jabc = jpt.ABCSMC(
        jg.make_birth_death_model(segments=5, **SMALL),
        jg.birth_death_prior(), jkernel.IndependentNormalKernel(var=4.0),
        population_size=64,
        eps=jpt.Temperature(schemes=[jtemp.ExpDecayFixedIterScheme()],
                            initial_temperature=50.0),
        acceptor=jpt.StochasticAcceptor(
            pdf_norm_method=jpdf.ScaledPDFNorm()),
        seed=7, early_reject=False, fused_generations=4)
    jabc.new("sqlite://", _obs())
    hj = jabc.run(max_nr_populations=4)
    assert _trail(hj)[-1] == 1.0
    df, w = h_on.get_distribution(m=0, t=h_on.max_t)
    dfj, wj = hj.get_distribution(m=0, t=hj.max_t)
    for col in ("log_b", "log_d"):
        mu = float(np.sum(np.asarray(df[col]) * w))
        mu_j = float(np.sum(np.asarray(dfj[col]) * wj))
        assert abs(mu - mu_j) < 0.35, (col, mu, mu_j)


# --------------------------------------------------------------- gates
def _ladder(pkg):
    return pkg.ListTemperature([50.0, 30.0])


def _acceptance_rate(pkg, scheme):
    return pkg.Temperature(schemes=[scheme()], initial_temperature=50.0)


#: gate -> (JAX kernel, its observation, JAX epsilon, port epsilon)
GATES = {
    "normal": (lambda: jkernel.NormalKernel(cov=np.eye(20) * 4.0), _obs,
               lambda: _ladder(jpt), lambda: _ladder(tpt)),
    "negbin": (lambda: jkernel.NegativeBinomialKernel(p=0.5), _poisson_obs,
               lambda: _ladder(jpt), lambda: _ladder(tpt)),
    "poisson-lin": (lambda: jkernel.PoissonKernel(ret_scale="SCALE_LIN"),
                    _poisson_obs, lambda: _ladder(jpt),
                    lambda: _ladder(tpt)),
    "acceptance_rate": (
        lambda: jkernel.IndependentNormalKernel(var=4.0), _obs,
        lambda: _acceptance_rate(jpt, jtemp.AcceptanceRateScheme),
        lambda: _acceptance_rate(tpt, tpt.AcceptanceRateScheme)),
}


def _port_abc(kernel, eps, obs, early):
    abc = tpt.ABCSMC(tg.make_birth_death_model(segments=5, **SMALL),
                     tg.birth_death_prior(), kernel, population_size=32,
                     eps=eps, acceptor=tpt.StochasticAcceptor(),
                     early_reject=early, device="cpu")
    abc.new("sqlite://", obs)
    return abc


@pytest.mark.parametrize("gate", sorted(GATES))
def test_gate_reasons_are_the_jax_package_s(gate):
    """Unbounded kernels (NormalKernel, NegativeBinomialKernel, lin-scale
    Poisson) and the AcceptanceRateScheme keep the classic path with the
    JAX package's reason: under "auto" the fallback is recorded, under
    True the run raises its ValueError."""
    make, obs_of, eps_j, eps_t = GATES[gate]
    obs = obs_of()
    jk = make()
    jabc = jpt.ABCSMC(jg.make_birth_death_model(segments=5, **SMALL),
                      jg.birth_death_prior(), jk, population_size=32,
                      eps=eps_j(), acceptor=jpt.StochasticAcceptor())
    jabc.new("sqlite://", obs)
    jk.initialize(0, None, obs)  # pdf_max, which an upper bound starts at
    want = jabc._early_reject_incapable_reason(
        adaptive=False, stochastic=True, sumstat_mode=False, sharded_n=None)
    assert want is not None
    abc = _port_abc(convert.noise_kernel(jk), eps_t(), obs, True)
    abc.distance_function.initialize(abc.spec)
    assert abc._early_reject_incapable_reason(
        adaptive=False, stochastic=True) == want
    with pytest.raises(ValueError) as err:
        abc.run(max_nr_populations=2)
    assert str(err.value) == f"early_reject=True unavailable: {want}"
    # "auto": the classic path, one generation, the fallback recorded
    abc = _port_abc(convert.noise_kernel(jk), eps_t(), obs, "auto")
    h = abc.run(max_nr_populations=2, max_total_nr_simulations=1)
    fallback = {"gate": "early_reject", "reason": want}
    assert abc.capability_fallbacks == [fallback]
    tel = h.get_telemetry(0)
    assert tel["capability_fallbacks"] == [fallback]
    assert "retired_early" not in tel and h.max_t == 0


def test_direction_is_checked_both_ways():
    """A lower distance bound under a stochastic acceptor, or an upper
    log-density bound under a uniform one, never serves (the JAX
    ``segment_cfg`` soundness gate)."""
    abc = tpt.ABCSMC(tg.make_birth_death_model(segments=5, **SMALL),
                     tg.birth_death_prior(), tpt.PNormDistance(p=2),
                     population_size=32, device="cpu")
    abc.new("sqlite://", _obs())
    ctx = abc._build_context(32, 0.0)
    ctx.stochastic = True
    with pytest.raises(ValueError, match="lower distance bound"):
        ctx.segment_cfg()
    assert "LOWER bound" in abc._early_reject_incapable_reason(
        adaptive=False, stochastic=True)
    abc.distance_function = tpt.IndependentNormalKernel(var=4.0)
    abc.distance_function.initialize(abc.spec)
    assert "upper bound only decides" in abc._early_reject_incapable_reason(
        adaptive=False, stochastic=False)


# --------------------------------------------- K18's stochastic mode
def _round(kernel_t, B=512, temp=3.0, seed=3):
    model = tg.make_birth_death_model(segments=5, **SMALL)
    obs = _obs()
    spec = SumStatSpec(obs)
    kernel_t.initialize(spec)
    gen = torch.Generator()
    gen.manual_seed(seed)
    theta = tg.birth_death_prior().rvs_array(B, gen, torch.device("cpu"))
    valid = torch.rand(B, generator=gen) > 0.05
    ctr = torch.tensor([0, 2, 0, 0], dtype=torch.int32)
    sim = philox.PhiloxStream(11, 3, philox.SIM_NOISE, 16, ctr)
    acc = philox.PhiloxStream(11, 3, philox.ACCEPT, 16, ctr)
    x0 = torch.as_tensor(spec.flatten_host(obs), dtype=torch.float32)
    params = kernel_t.device_params("cpu")
    return dict(model=model, spec=spec, theta=theta, valid=valid, sim=sim,
                acc=acc, x0=x0, params=params,
                temp=torch.tensor(temp), kernel=kernel_t)


def _stochastic(r, pdf_norm, temp=None):
    seg_ctr = torch.zeros(4, dtype=torch.int64)
    ss, keep = segment_round(
        r["model"].segmented, r["theta"], r["valid"], r["sim"],
        imap=r["model"].index_map(r["spec"], "cpu"), x0=r["x0"],
        w=r["params"], p=2.0, eps=r["temp"] if temp is None else temp,
        width=r["spec"].total_size, seg_ctr=seg_ctr,
        noise=r["kernel"].device_bound_fn(), pdf_norm=pdf_norm,
        accept=r["acc"])
    return ss, keep, seg_ctr


@pytest.mark.parametrize("family", ["independent_normal", "laplace",
                                    "binomial", "poisson"])
def test_stochastic_round_retires_only_rejected_slots(family):
    """Every retired slot is one the full accept test (K21a/K21c on the
    classic statistics, with the same uniform) rejects; kept slots carry
    the classic statistics; slots retire at all."""
    kernel = {"independent_normal": lambda: tpt.IndependentNormalKernel(
                  var=4.0),
              "laplace": lambda: tpt.IndependentLaplaceKernel(scale=2.0),
              "binomial": lambda: tpt.BinomialKernel(p=0.9),
              "poisson": tpt.PoissonKernel}[family]()
    r = _round(kernel)
    classic = r["model"].simulate_flat(r["theta"], None, r["spec"],
                                       stream=r["sim"])
    v, _a, _lw = kernel_accept(
        classic, r["x0"], r["params"], torch.tensor(math.inf),
        torch.tensor(0.0), r["valid"], stream=r["acc"], lin=False,
        apply_iw=True, family=kernel.family)
    fin = torch.isfinite(v) & r["valid"]
    pdf_norm = torch.quantile(v[fin], 0.9).to(torch.float32)
    ss, keep, seg_ctr = _stochastic(r, pdf_norm)
    _v, accept, _lw = kernel_accept(
        classic, r["x0"], r["params"], r["temp"], pdf_norm, r["valid"],
        stream=r["acc"], lin=False, apply_iw=True, family=kernel.family)
    retired = r["valid"] & ~keep
    # invalid slots retire after their first segment too
    assert int(seg_ctr[RETIRED]) == int((~keep).sum())
    assert int(seg_ctr[RESOLVED]) == len(keep)
    assert retired.any() and not (retired & accept).any()
    assert torch.equal(ss[keep], classic[keep])
    # at T = +inf no slot retires but the invalid ones
    _ss, keep_inf, ctr_inf = _stochastic(r, pdf_norm,
                                         temp=torch.tensor(math.inf))
    assert torch.equal(keep_inf, r["valid"])


def test_stochastic_mode_refuses_unbounded_families():
    r = _round(tpt.IndependentNormalKernel(var=4.0))
    with pytest.raises(ValueError, match="no upper bound"):
        segment_round(
            r["model"].segmented, r["theta"], r["valid"], r["sim"],
            imap=r["model"].index_map(r["spec"], "cpu"), x0=r["x0"],
            w=r["params"], p=2.0, eps=r["temp"], width=20,
            seg_ctr=torch.zeros(4, dtype=torch.int64),
            noise={"family": "negbin_size", "init_value": 0.0},
            pdf_norm=torch.tensor(0.0), accept=r["acc"])


def test_record_ring_keeps_completed_evaluations_only():
    """K6's ring mask: a valid slot's row is written with valid = keep,
    while n_valid counts every valid slot."""
    B, S, d = 8, 3, 2
    valid = torch.tensor([1, 1, 0, 1, 1, 1, 0, 1], dtype=torch.bool)
    keep = valid & torch.tensor([1, 0, 1, 1, 0, 1, 1, 0], dtype=torch.bool)
    accept = keep & torch.tensor([1, 0, 0, 1, 0, 0, 0, 0], dtype=torch.bool)
    res = {"theta": torch.zeros(4, d), "sumstats": torch.zeros(4, S),
           "distance": torch.zeros(4), "log_weight": torch.zeros(4),
           "slot": torch.full((4,), -1, dtype=torch.int32)}
    rec = {"sumstats": torch.zeros(16, S), "distance": torch.zeros(16),
           "accepted": torch.zeros(16, dtype=torch.bool),
           "valid": torch.zeros(16, dtype=torch.bool),
           "theta": torch.zeros(16, d), "logq": torch.zeros(16)}
    counters = torch.zeros(4, dtype=torch.int32)
    compact_round(accept, valid, torch.randn(B, d), torch.randn(B, S),
                  torch.randn(B), torch.randn(B), res, rec, counters,
                  logq=torch.randn(B), ring_valid=keep)
    assert torch.equal(rec["valid"][:B], keep)
    assert torch.equal(rec["accepted"][:B], accept)
    assert counters.tolist()[:3] == [2, 1, int(valid.sum())]
