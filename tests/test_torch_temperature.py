"""Port parity: K21b (the per-generation pdf-norm and temperature update
of noisy ABC, ``kernels/temperature_update.py``, plain PyTorch on the CPU)
against the JAX package's ``DeviceContext._stochastic_gen_update``, called
unbound (it reads nothing of ``self``), for each of the seven schemes,
ScaledPDFNorm, a finite and an absent ``pdf_max``, the final-generation
override and an empty ring; and its initial temperature against the JAX
package's host ``Temperature.initialize`` and
``StochasticAcceptor.initialize`` on a calibration sample. Tolerances: the
norm and the closed forms rel 1e-6 (float32 on both sides), a bisected
temperature rel 1e-4 (float32 sums in another order move the crossing of
the target by a few ulp of the rate; the host runs in float64).
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import pyabc_tpu as jpt  # noqa: E402
from pyabc_tpu.acceptor import pdf_norm as jpdf  # noqa: E402
from pyabc_tpu.epsilon import temperature as jtemp  # noqa: E402
from pyabc_tpu.inference.util import (  # noqa: E402
    DeviceContext as JaxContext)
from pyabc_tpu.transition import util as jutil  # noqa: E402
import pyabc_tpu_torch as pt  # noqa: E402
from pyabc_tpu_torch import convert  # noqa: E402
from pyabc_tpu_torch.core.sumstat_spec import SumStatSpec  # noqa: E402
from pyabc_tpu_torch.epsilon.temperature import (  # noqa: E402
    TempConfig, device_config)
from pyabc_tpu_torch.kernels import temperature_update  # noqa: E402
from pyabc_tpu_torch.kernels.mvn_logpdf import (  # noqa: E402
    mvn_mixture_logpdf_plain)
from pyabc_tpu_torch.kernels.temperature_update import (  # noqa: E402
    scheme_tables)

torch.set_num_threads(1)

N_CAP, N_KEEP, REC, D = 64, 50, 256, 2
AR = ("acceptance_rate", 0.3)


def _state(seed=0, empty_ring=False, lin=False, flat_w=False):
    rng = np.random.default_rng(seed)
    theta = rng.normal(0.5, 0.2, (N_CAP, D)).astype(np.float32)
    k_mask = np.arange(N_CAP) < N_KEEP
    w = np.where(k_mask, 1.0 if flat_w else rng.random(N_CAP), 0.0)
    w = (w / w.sum()).astype(np.float32)
    v = rng.normal(-40.0, 6.0, N_CAP).astype(np.float32)
    rv = rng.normal(-45.0, 9.0, REC).astype(np.float32)
    if lin:
        v, rv = np.exp(v / 10).astype(np.float32), np.exp(rv / 10).astype(
            np.float32)
    rec = {"theta": rng.normal(0.5, 0.3, (REC, D)).astype(np.float32),
           "logq": rng.normal(0.0, 1.0, REC).astype(np.float32),
           "distance": rv,
           "valid": (np.zeros(REC, bool) if empty_ring
                     else np.arange(REC) < REC - 30)}
    fit = jax.tree.map(np.asarray, jpt.MultivariateNormalTransition
                       .device_fit(jnp.asarray(theta), jnp.asarray(w),
                                   dim=D, scaling=1.0,
                                   bandwidth_selector=jutil
                                   .silverman_rule_of_thumb))
    return dict(theta=theta, k_mask=k_mask, w=w, v=v, rec=rec, fit=fit)


def _both(st, schemes, *, t_next=3, max_np=8, pdf_max=None, lin=False,
          pdf_scaled=None, pdf_norm=-30.0, max_found=-32.0, daly_k=20.0,
          temp=50.0, acc_rate=0.1):
    """(port, JAX) outputs: (temp_next, pdf_norm_next, max_found_next,
    daly_k_next) as floats."""
    f32 = np.float32
    res_j = {"distance": jnp.asarray(st["v"])}
    rec_j = {k: jnp.asarray(v) for k, v in st["rec"].items()}
    out_j = JaxContext._stochastic_gen_update(
        None, (tuple(schemes), max_np, pdf_max, lin, pdf_scaled),
        jpt.MultivariateNormalTransition, (st["fit"],), rec_j, res_j,
        jnp.asarray(st["k_mask"]), jnp.asarray(st["w"]),
        jnp.float32(pdf_norm), jnp.float32(max_found), jnp.float32(daly_k),
        jnp.float32(temp), jnp.float32(acc_rate), jnp.int32(t_next - 1))
    temp_j, (pdf_j, mf_j, dk_j), _extra = out_j
    cfg = TempConfig(schemes=tuple(schemes), max_np=max_np, pdf_max=pdf_max,
                     lin=lin, pdf_scaled=pdf_scaled,
                     initial=("constant", 1.0))
    params = convert.transition_params(st["fit"], device="cpu")
    rec = {k: torch.from_numpy(v) for k, v in st["rec"].items()}
    logq_new = (mvn_mixture_logpdf_plain(rec["theta"], params)
                if cfg.needs_logq_new else None)
    out = temperature_update.update(
        rec=rec, logq_new=logq_new, res_distance=torch.from_numpy(st["v"]),
        k_mask=torch.from_numpy(st["k_mask"]),
        w_norm=torch.from_numpy(st["w"]),
        pdf_norm=torch.tensor(f32(pdf_norm)),
        max_found=torch.tensor(f32(max_found)),
        daly_k=torch.tensor(f32(daly_k)), temp=torch.tensor(f32(temp)),
        acc_rate=torch.tensor(f32(acc_rate)),
        tables=scheme_tables(cfg.schemes, "cpu"), t_next=t_next, config=cfg)
    return ([float(x) for x in out],
            [float(temp_j), float(pdf_j), float(mf_j), float(dk_j)])


def _check(port, ref, bisected: bool):
    assert port[0] == pytest.approx(ref[0], rel=1e-4 if bisected else 1e-6)
    assert port[1:] == pytest.approx(ref[1:], rel=1e-6)


@pytest.mark.parametrize("schemes,kw,bisected", [
    ([AR], {}, True),
    ([AR], {"temp": 3.0}, True),
    ([("exp_decay_fixed_iter",)], {}, False),
    ([("poly_decay_fixed_iter", 3.0)], {}, False),
    ([("exp_decay_fixed_ratio", 0.5, 1e-4, 0.5)], {"acc_rate": 1e-5}, False),
    ([("exp_decay_fixed_ratio", 0.5, 1e-4, 0.5)], {"acc_rate": 0.1}, False),
    ([("exp_decay_fixed_ratio", 0.5, 1e-4, 0.5)], {"acc_rate": 0.7}, False),
    ([("friel_pettitt",)], {"temp": 100.0}, False),
    ([("daly", 0.5, 1e-4)], {"acc_rate": 1e-5}, False),
    ([("daly", 0.5, 1e-4)], {"acc_rate": 0.1}, False),
    ([("ess", 0.8)], {}, True),
    ([("ess", 0.5)], {"temp": 4.0}, True),
    ([AR, ("exp_decay_fixed_iter",)], {}, True),
], ids=["acceptance_rate", "acceptance_rate_low_T", "exp_decay_fixed_iter",
        "poly_decay", "fixed_ratio_collapse", "fixed_ratio",
        "fixed_ratio_high", "friel_pettitt", "daly_collapse", "daly", "ess",
        "ess_low_T",
        "default_pair"])
def test_schemes_match_jax(schemes, kw, bisected):
    # equal weights give the ESS scheme room below the previous T
    port, ref = _both(_state(flat_w=schemes[0][0] == "ess"), schemes, **kw)
    _check(port, ref, bisected)
    assert 1.0 <= port[0] <= kw.get("temp", 50.0)


@pytest.mark.parametrize("pdf_max", [None, -33.5])
@pytest.mark.parametrize("scaled", [None, (10.0, 0.5), (2.0, 0.13)])
def test_pdf_norm_and_scaled_norm_match_jax(pdf_max, scaled):
    port, ref = _both(_state(1), [AR], pdf_max=pdf_max, pdf_scaled=scaled)
    _check(port, ref, True)
    if pdf_max is not None and scaled is None:
        assert port[1] == np.float32(pdf_max)


def test_scale_lin_matches_jax():
    port, ref = _both(_state(2, lin=True), [AR, ("ess", 0.8)], lin=True,
                      pdf_norm=-30.0, max_found=-40.0)
    _check(port, ref, True)


@pytest.mark.parametrize("schemes", [[AR], [("friel_pettitt",)]])
def test_final_generation_is_exact(schemes):
    port, ref = _both(_state(), schemes, t_next=7, max_np=8)
    assert port[0] == ref[0] == 1.0


def test_empty_ring_and_no_horizon_match_jax():
    port, ref = _both(_state(3, empty_ring=True),
                      [AR, ("exp_decay_fixed_ratio", 0.5, 1e-4, 0.5)],
                      max_np=-1, t_next=12)
    _check(port, ref, True)


def test_ladder_updates_the_norm_only():
    port, ref = _both(_state(), [], temp=7.0)
    assert port[0] == ref[0] == 7.0 and port[3] == 20.0
    assert port[1:] == pytest.approx(ref[1:], rel=1e-6)


# ------------------------------------------------------ initial temperature
def _calibration(seed=4, n=300):
    rng = np.random.default_rng(seed)
    obs = {"x": np.zeros(15)}
    ss = rng.normal(0.0, 25.0, (n, 15))
    return obs, ss


@pytest.mark.parametrize("case", ["acceptance_rate", "scaled", "constant",
                                  "friel_pettitt", "final"])
def test_initial_temperature_matches_the_jax_host(case):
    obs, ss = _calibration()
    var = [100.0] * 15
    jkern = jpt.IndependentNormalKernel(var=var)
    jkern.initialize(0, None, obs)
    vals = np.array([jkern({"x": s}, obs) for s in ss])
    meth, pmeth = jpdf.pdf_norm_max_found, pt.pdf_norm_max_found
    if case == "scaled":
        meth, pmeth = jpdf.ScaledPDFNorm(), pt.ScaledPDFNorm()
    init, pinit = None, None
    if case == "constant":
        init, pinit = 64.0, 64.0
    elif case == "friel_pettitt":
        init = jtemp.FrielPettittScheme()
        pinit = pt.FrielPettittScheme()
    max_np = 1 if case == "final" else 8
    jacc = jpt.StochasticAcceptor(meth)
    jacc.initialize(0, lambda: pd.DataFrame({"distance": vals}), jkern)
    jeps = jtemp.Temperature(initial_temperature=init)
    jeps.initialize(
        0, get_weighted_distances=lambda: pd.DataFrame(
            {"distance": vals, "w": np.full(len(vals), 1 / len(vals))}),
        get_all_records=lambda: pd.DataFrame(
            {"distance": vals, "accepted": np.ones(len(vals), bool)}),
        max_nr_populations=max_np,
        acceptor_config=jacc.get_epsilon_config(0))

    kern = pt.IndependentNormalKernel(var=var)
    kern.initialize(SumStatSpec(obs))
    eps = pt.Temperature(initial_temperature=pinit)
    eps._max_nr_populations = max_np
    cfg = device_config(eps, kern, pt.StochasticAcceptor(pmeth))
    n_cap = 512
    v = torch.zeros(n_cap)
    v[:len(vals)] = torch.from_numpy(vals.astype(np.float32))
    k_mask = torch.arange(n_cap) < len(vals)
    temp0, pdf0, mf0 = temperature_update.initial(
        res_distance=v, k_mask=k_mask,
        tables=scheme_tables((cfg.initial,), "cpu"), config=cfg)
    assert float(temp0) == pytest.approx(jeps.temperatures[0], rel=1e-4)
    assert float(pdf0) == pytest.approx(jacc.pdf_norms[0], rel=1e-6)
    assert float(mf0) == pytest.approx(jacc._max_found, rel=1e-6)
    if case == "final":
        assert float(temp0) == 1.0
    elif case == "acceptance_rate":
        assert 1.0 < float(temp0) < 1e4


# ------------------------------------------------------- capability rules
def test_device_config_follows_the_fused_capability_rules():
    kern = pt.IndependentNormalKernel(var=[1.0])
    kern.initialize(SumStatSpec({"x": 0.0}))
    acc = pt.StochasticAcceptor()
    eps = pt.Temperature()
    cfg = device_config(eps, kern, acc)
    # no horizon: the default pair is acceptance rate + fixed ratio
    assert [s[0] for s in cfg.schemes] == ["acceptance_rate",
                                           "exp_decay_fixed_ratio"]
    assert cfg.max_np == -1 and cfg.initial == AR and cfg.needs_logq_new
    eps._max_nr_populations = 8
    assert [s[0] for s in device_config(eps, kern, acc).schemes] == [
        "acceptance_rate", "exp_decay_fixed_iter"]
    ladder = device_config(pt.ListTemperature([5.0, 1.0]), kern, acc)
    assert ladder.fixed and ladder.initial == ("constant", 5.0)
    refused = [
        (pt.Temperature(aggregate_fun=max), acc),
        (pt.Temperature(enforce_less_equal_prev=False), acc),
        (pt.Temperature(log_file="t.json"), acc),
        (pt.Temperature(schemes=[]), acc),
        (pt.Temperature(schemes=[pt.ExpDecayFixedIterScheme()]), acc),
        (pt.Temperature(initial_temperature=pt.EssScheme()), acc),
        (pt.Temperature(), pt.StochasticAcceptor(pt.pdf_norm_from_kernel)),
        (pt.Temperature(), pt.StochasticAcceptor(log_file="n.json")),
        (pt.MedianEpsilon(), acc),
    ]
    for e, a in refused:
        with pytest.raises(NotImplementedError, match="item 11"):
            device_config(e, kern, a)
