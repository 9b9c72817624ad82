"""Tau leaping (BASELINE config 3): the port's K19 plain versions against
the JAX package on the CPU.

Inputs come from numpy seeds. The Poisson sampler is held to
``jax.random.poisson`` in law and, fed the port's own uniforms, to a numpy
transcription of JAX's Knuth / PTRS formula count for count (the method of
``test_torch_propose.py``: the bits of the two generators differ, a
declared difference). Then the tau-leap trajectory law at a fixed theta
(midpoint variant and stochastic LV included), the grid checks, the
overflow corner of the stochastic LV and the birth-death posterior against
the JAX package's over a few seeds.
"""
import math
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import pyabc_tpu as jpt  # noqa: E402
from pyabc_tpu.models import gillespie as jg  # noqa: E402
import pyabc_tpu_torch as tpt  # noqa: E402
from pyabc_tpu_torch.kernels import philox  # noqa: E402
from pyabc_tpu_torch.kernels.pnorm_accept import (  # noqa: E402
    pnorm_accept_weight)
from pyabc_tpu_torch.kernels.tau_leap import tau_leap  # noqa: E402
from pyabc_tpu_torch.models import gillespie as tg  # noqa: E402

torch.set_num_threads(1)

N_DRAWS = 1 << 16
N_LANES = 4096
SMALL = dict(n_leaps=100, n_obs=20)


def _stream(seed=3, gen=2, rounds=5, tag=philox.SIM_NOISE):
    ctr = torch.zeros(4, dtype=torch.int32)
    ctr[philox.ROUND] = rounds
    return philox.PhiloxStream(seed, gen, tag, 16, ctr)


# ------------------------------------------------------------ Poisson
@pytest.mark.parametrize("lam", [0.0, 0.3, 3.0, 9.99, 10.0, 50.0, 1e3])
def test_poisson_law_matches_jax(lam):
    """Mean and variance of 2^16 draws agree with jax.random.poisson's
    within 4 standard errors of their difference."""
    ours = philox.poisson_plain(
        _stream(), torch.arange(N_DRAWS), torch.tensor(7),
        torch.full((N_DRAWS,), lam)).numpy().astype(np.float64)
    theirs = np.asarray(jax.random.poisson(
        jax.random.key(11), lam, (N_DRAWS,)), np.float64)
    if lam == 0.0:
        assert (ours == 0).all() and (theirs == 0).all()
        return
    se_mean = math.sqrt(2 * lam / N_DRAWS)
    se_var = math.sqrt(2 * (lam + 2 * lam * lam) / N_DRAWS)
    assert abs(ours.mean() - theirs.mean()) < 4 * se_mean
    assert abs(ours.var() - theirs.var()) < 4 * se_var
    assert (ours >= 0).all() and (ours == np.floor(ours)).all()


def _jax_formula(lam: np.float32, u: np.ndarray) -> float:
    """jax/_src/random.py::_poisson (Knuth below 10, PTRS from 10 up) in
    float32 numpy, consuming the given uniforms in order: Knuth takes one
    an iteration, PTRS two an attempt."""
    f = np.float32
    lam = f(lam)
    if lam == 0:
        return 0.0
    if np.isnan(lam) or lam < 10:
        k, log_prod, i = 0, f(0), 0
        while log_prod > -lam:
            k += 1
            log_prod = f(log_prod + np.log(u[i]))
            i += 1
        return float(k - 1)
    log_lam = np.log(lam)
    b = f(f(0.931) + f(f(2.53) * np.sqrt(lam)))
    a = f(f(-0.059) + f(f(0.02483) * b))
    inv_alpha = f(f(1.1239) + f(f(1.1328) / f(b - f(3.4))))
    v_r = f(f(0.9277) - f(f(3.6224) / f(b - f(2))))
    for j in range(len(u) // 2):
        uu = f(u[2 * j] - f(0.5))
        v = u[2 * j + 1]
        us = f(f(0.5) - abs(uu))
        k = np.floor(f(f(f(f(f(f(2) * a) / us) + b) * uu) + lam) + f(0.43))
        s = np.log(f(f(v * inv_alpha) / f(f(a / f(us * us)) + b)))
        lg = (math.inf if k + 1 <= 0 and float(k).is_integer()
              else math.lgamma(float(k) + 1.0))  # lgamma's poles: +inf
        t = f(f(-lam + f(k * log_lam)) - f(lg))
        accept1 = (us >= 0.07) and (v <= v_r)
        reject = (k < 0) or ((us < 0.013) and (v > us))
        if accept1 or (not reject and s <= t):
            return float(k)
    return -1.0


@pytest.mark.parametrize("lam", [0.3, 3.0, 9.99, 10.0, 50.0, 1e3])
def test_poisson_counts_follow_jax_formula_on_shared_uniforms(lam):
    """The port's uniforms fed to JAX's formula give the port's counts
    (lgamma in double there: a draw whose PTRS test lies within rounding
    of its bound may part; none does in these draws)."""
    n = 512
    lanes = torch.arange(n)
    draws = torch.full((n,), 3)
    st = _stream(seed=9)
    ours = philox.poisson_plain(st, lanes, draws,
                                torch.full((n,), lam)).numpy()
    uni = philox.poisson_uniforms(st, lanes, draws, 0, 16).numpy()
    ref = np.asarray([_jax_formula(np.float32(lam), uni[i])
                      for i in range(n)])
    np.testing.assert_array_equal(ours, ref)


def test_poisson_nan_and_inf_rates():
    """NaN takes JAX's Knuth branch and returns -1; an infinite rate ends
    (PTRS accepts inf or NaN) with a non-finite count."""
    lam = torch.tensor([float("nan"), float("inf"), 0.0])
    out = philox.poisson_plain(_stream(), torch.arange(3), torch.tensor(0),
                               lam)
    assert out[0] == -1.0 and not math.isfinite(out[1]) and out[2] == 0.0
    jout = np.asarray(jax.random.poisson(jax.random.key(0),
                                         jnp.asarray([jnp.nan, 0.0]), (2,)))
    assert jout[0] == -1 and jout[1] == 0


# --------------------------------------------------- trajectory law
@pytest.fixture(scope="module")
def jax_trajectories():
    """X at every observation of N_LANES lanes of the JAX simulators."""
    out = {}
    for name, mk, theta in [
            ("bd", lambda: jg.make_birth_death_model(**SMALL), [0.8, -0.7]),
            ("bd_midpoint", lambda: jg.make_birth_death_model(
                midpoint=True, **SMALL), [0.8, -0.7]),
            ("lv", lambda: jg.make_stochastic_lv_model(**SMALL),
             [0.2, -1.9, 0.1])]:
        model = mk()
        keys = jax.random.split(jax.random.key(5), N_LANES)
        th = jnp.asarray(theta, jnp.float32)
        sims = jax.jit(jax.vmap(lambda k: model.sim(k, th)))(keys)
        out[name] = ({k: np.asarray(v, np.float64) for k, v in sims.items()},
                     theta)
    return out


@pytest.mark.parametrize("name", ["bd", "bd_midpoint", "lv"])
def test_tau_leap_trajectory_law_matches_jax(jax_trajectories, name):
    """Mean and sd of every species at every observation over 4096 lanes
    agree with the JAX simulator's within 4 standard errors."""
    theirs, theta = jax_trajectories[name]
    mk = {"bd": lambda: tg.make_birth_death_model(**SMALL),
          "bd_midpoint": lambda: tg.make_birth_death_model(
              midpoint=True, **SMALL),
          "lv": lambda: tg.make_stochastic_lv_model(**SMALL)}[name]
    gen = torch.Generator()
    gen.manual_seed(1)
    ours = mk().sim(torch.tensor([theta]).expand(N_LANES, len(theta))
                    .contiguous(), gen)
    for k, ref in theirs.items():
        got = ours[k].numpy().astype(np.float64)
        assert got.shape == ref.shape
        sd1, sd2 = got.std(0), ref.std(0)
        se_mean = np.sqrt((sd1 ** 2 + sd2 ** 2) / N_LANES) + 1e-9

        def var_of_sd(x, sd):
            # the sd's sampling variance, (m4 - sd^4) / (4 sd^2 N): the
            # populations are skewed, so no normal-theory shortcut
            m4 = ((x - x.mean(0)) ** 4).mean(0)
            return (m4 - sd ** 4) / (4 * sd ** 2 * N_LANES + 1e-300)

        se_sd = np.sqrt(var_of_sd(got, sd1) + var_of_sd(ref, sd2)) + 1e-9
        assert (np.abs(got.mean(0) - ref.mean(0)) < 4 * se_mean).all(), k
        assert (np.abs(sd1 - sd2) < 4 * se_sd).all(), k


def test_generic_tau_leap_equals_the_built_in_chain():
    """``gillespie.tau_leap`` with the birth-death propensities draws what
    the built-in model's chain (K19's plain version) draws: one stream,
    keyed by lane, leap and channel."""
    B = 64
    theta = torch.tensor([[0.5, -1.0]]).expand(B, 2).contiguous()
    st = _stream(seed=4)
    model = tg.make_birth_death_model(**SMALL)
    out, _x = tau_leap(model.chain.kernel[1], theta, st)
    rates = torch.pow(torch.tensor(10.0), theta)
    traj = tg.tau_leap(st, torch.full((B, 1), 40.0), ((1.0,), (-1.0,)),
                       lambda x: [rates[:, 0], rates[:, 1] * x[:, 0]],
                       10.0, 100, save_every=5)
    assert traj.shape == (B, 20, 1)
    assert torch.equal(traj[:, :, 0], out)


# --------------------------------------------------------------- grid
@pytest.mark.parametrize("n_leaps,n_obs,segments", [
    (100, 30, None), (100, 20, 0), (100, 20, 3), (90, 30, 6), (100, 20, 5)])
def test_check_obs_grid_errors_match(n_leaps, n_obs, segments):
    def outcome(fn):
        try:
            return ("ok", fn(n_leaps, n_obs, segments))
        except ValueError as exc:
            return ("ValueError", str(exc))

    assert outcome(tg._check_obs_grid) == outcome(jg._check_obs_grid)


@pytest.mark.parametrize("save_every", [0, 3])
def test_tau_leap_save_every_errors_match(save_every):
    with pytest.raises(ValueError) as ours:
        tg.tau_leap(_stream(), torch.full((2, 1), 40.0), ((1.0,), (-1.0,)),
                    lambda x: [x[:, 0], x[:, 0]], 10.0, 100,
                    save_every=save_every)
    with pytest.raises(ValueError) as theirs:
        jg.tau_leap(jax.random.key(0), jnp.asarray([40.0]),
                    jnp.asarray([[1.0], [-1.0]]),
                    lambda x: jnp.stack([x[0], x[0]]), 10.0, 100,
                    save_every=save_every)
    assert str(ours.value) == str(theirs.value)


# ------------------------------------------------------ overflow corner
def test_stochastic_lv_overflow_ends_non_finite_and_rejected():
    """No corner of the stochastic LV prior overflows float32 (log_r1 =
    0.5, log_r3 = -1, log_r2 at either end stay finite), so the step is fed
    an overflowing state: the lane ends with non-finite statistics, the
    accept test rejects it, and nothing hangs."""
    model = tg.make_stochastic_lv_model(segments=10)
    spec = model.chain.kernel[1]
    gen = torch.Generator()
    gen.manual_seed(0)
    for r2 in (-3.0, -1.5):
        th = torch.tensor([[0.5, r2, -1.0]]).expand(32, 3).contiguous()
        for v in model.sim(th, gen).values():
            assert torch.isfinite(v).all()
    B = 16
    theta = torch.tensor([[0.5, -1.5, -1.0]]).expand(B, 3).contiguous()
    state = torch.full((B, 2), 1e30)
    out, x = tau_leap(spec, theta, _stream(), state=state, seg_from=3,
                      seg_to=10)
    assert (~torch.isfinite(out)).any(dim=1).all()
    x0 = torch.zeros(out.shape[1])
    eps = torch.tensor(1e30)
    _d, accept, _lw = pnorm_accept_weight(
        out, x0, torch.ones_like(x0), eps, torch.ones(B, dtype=torch.bool),
        p=2.0)
    assert not accept.any()


# ------------------------------------------------------ posterior band
POST_SEEDS = (0, 1, 2)


def test_birth_death_posterior_means_match_jax():
    """Posterior means of (log b, log d) after 4 generations of pop 128, on
    the JAX observation, averaged over three seeds: the port's and the JAX
    package's agree within 0.25 (one run's mean spreads by about 0.1 at
    this size; the prior is 2 wide)."""
    jobs = {k: np.asarray(v) for k, v in jg.observed_birth_death(
        n_leaps=100, n_obs=20, segments=5).items()}
    ours, theirs, jctx = [], [], None
    for seed in POST_SEEDS:
        abc = tpt.ABCSMC(tg.make_birth_death_model(segments=5, **SMALL),
                         tg.birth_death_prior(), tpt.PNormDistance(p=2),
                         population_size=128, eps=tpt.MedianEpsilon(),
                         seed=seed, fused_generations=4, device="cpu")
        abc.new("sqlite://", jobs)
        h = abc.run(max_nr_populations=4)
        df, w = h.get_distribution(m=0, t=h.max_t)
        ours.append([float(np.average(df[c], weights=w))
                     for c in ("log_b", "log_d")])
        # the JAX runs share one device context (one compile) and take the
        # classic kernel, whose populations equal its early-reject ones
        jabc = jpt.ABCSMC(jg.make_birth_death_model(segments=5, **SMALL),
                          jg.birth_death_prior(), jpt.PNormDistance(p=2),
                          population_size=128, eps=jpt.MedianEpsilon(),
                          seed=seed, fused_generations=4,
                          early_reject=False)
        jabc.new("sqlite://", jobs)
        if jctx is not None:
            jabc._device_ctx = jctx
        jh = jabc.run(max_nr_populations=4)
        jctx = jabc._device_ctx
        jdf, jw = jh.get_distribution(m=0, t=jh.max_t)
        theirs.append([float(np.average(jdf[c], weights=jw))
                       for c in ("log_b", "log_d")])
    gap = np.abs(np.mean(ours, axis=0) - np.mean(theirs, axis=0))
    assert (gap < 0.25).all(), (ours, theirs)
