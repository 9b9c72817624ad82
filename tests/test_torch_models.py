"""Port parity: K4 (the Lotka-Volterra RK4 simulator), K20 (the SIR RK4
simulator) and the Gaussian simulators, on the same numpy parameters and
noise as the JAX package."""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from pyabc_tpu.models import gaussian as jgauss  # noqa: E402
from pyabc_tpu.models import lotka_volterra as jlv  # noqa: E402
from pyabc_tpu.models import sir as jsir  # noqa: E402
from pyabc_tpu.models.ode import rk4_at_times as jrk4  # noqa: E402
from pyabc_tpu_torch.core.sumstat_spec import SumStatSpec  # noqa: E402
from pyabc_tpu_torch.kernels import lv_simulate, philox  # noqa: E402
from pyabc_tpu_torch.kernels.sir_simulate import (  # noqa: E402
    sir_simulate_plain)
from pyabc_tpu_torch.models import gaussian, lotka_volterra, sir  # noqa: E402

torch.set_num_threads(1)

N_OBS, T1, N_SUB, NOISE_SD = 20, 15.0, 10, 0.5


def _jax_lv(theta, noise, log_parameters=False):
    """make_lv_model's simulator with the noise given instead of drawn:
    rk4_at_times(_lv_rhs) -> clip [0, 1e6] -> + noise_sd * noise, flattened
    in SumStatSpec's sorted order (pred | prey)."""
    ts = np.linspace(0.0, T1, N_OBS)

    def one(th, nz):
        if log_parameters:
            th = 10.0 ** th
        traj = jrk4(jlv._lv_rhs, jnp.asarray(jlv.Y0), ts, N_SUB,
                    args=(th[0], th[1], th[2], th[3]))
        traj = jnp.clip(traj, 0.0, 1e6)
        prey = traj[:, 0] + NOISE_SD * nz[0]
        pred = traj[:, 1] + NOISE_SD * nz[1]
        return jnp.concatenate([pred, prey])

    return np.asarray(jax.vmap(one)(jnp.asarray(theta), jnp.asarray(noise)))


def _lanes():
    rng = np.random.default_rng(0)
    theta = np.stack([rng.uniform(0, 3, 12), rng.uniform(0, 0.5, 12),
                      rng.uniform(0, 3, 12), rng.uniform(0, 0.3, 12)], 1)
    extra = np.array([
        [1.0, 0.1, 1.5, 0.075],    # the true parameters
        [3.0, 0.0, 0.1, 0.0],      # prey grows past 1e6: clipped
        [40.0, 0.0, 1.0, 0.5],     # overflows to inf, then NaN
        [np.nan, 0.1, 1.5, 0.075],  # NaN in, NaN out
    ])
    theta = np.concatenate([theta, extra]).astype(np.float32)
    noise = rng.standard_normal((len(theta), 2, N_OBS)).astype(np.float32)
    return theta, noise


@pytest.mark.parametrize("log_parameters", [False, True])
def test_lv_plain_matches_jax(log_parameters):
    theta, noise = _lanes()
    if log_parameters:
        theta = np.where(np.isfinite(theta), np.log10(
            np.maximum(theta, 1e-3)), theta).astype(np.float32)
    ref = _jax_lv(theta, noise, log_parameters)
    model = lotka_volterra.make_lv_model(log_parameters=log_parameters)
    got = model.simulate_with_noise(torch.from_numpy(theta),
                                    torch.from_numpy(noise)).numpy()
    assert got.shape == (len(theta), 2 * N_OBS)
    # blown-up lanes stay NaN (jnp.clip keeps NaN) and clip at 1e6
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    # (row 0 of each trajectory is y0 itself, finite for every lane)
    assert np.isnan(got[-1, 1:N_OBS]).all()
    if not log_parameters:
        assert np.nanmax(got[-3]) > 1e6 - 10
    # same float32 RK4 operation order; 190 steps, so allow the rounding
    # of XLA's CPU code generation: |err| <= 1e-3 + 1e-5 |ref|
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-3)


def test_lv_row_zero_is_y0_and_layout_is_sorted():
    theta, noise = _lanes()
    noise[:] = 0.0
    got = lv_simulate(torch.from_numpy(theta), torch.from_numpy(noise),
                      n_obs=N_OBS, n_substeps=N_SUB,
                      dt=lotka_volterra.make_lv_model().dt, y0=jlv.Y0,
                      noise_sd=NOISE_SD, log_parameters=False).numpy()
    assert got[0, 0] == jlv.Y0[1] and got[0, N_OBS] == jlv.Y0[0]
    assert SumStatSpec({"prey": np.zeros(N_OBS),
                        "pred": np.zeros(N_OBS)}).names == ("pred", "prey")


def test_lv_dt_is_float32_step():
    ts32 = np.linspace(0.0, T1, N_OBS).astype(np.float32)
    want = (ts32[1] - ts32[0]) / np.float32(N_SUB)
    assert lotka_volterra.make_lv_model().dt == float(want)


def test_lv_observed_data_is_deterministic():
    a = lotka_volterra.observed_data(seed=0)
    b = lotka_volterra.observed_data(seed=0)
    assert set(a) == {"prey", "pred"}
    np.testing.assert_array_equal(a["prey"], b["prey"])
    # noise-free reference trajectory of the JAX package at TRUE_PARS
    ts = np.linspace(0.0, T1, N_OBS)
    traj = np.asarray(jrk4(jlv._lv_rhs, jnp.asarray(jlv.Y0), ts, N_SUB,
                           args=tuple(jlv.TRUE_PARS.values())))
    # noise is N(0, 0.5^2): 20 draws stay within 5 sd of the ODE
    assert np.abs(a["prey"] - traj[:, 0]).max() < 2.5


def test_gaussian_models_match_jax():
    key = jax.random.key(3)
    theta = np.array([[0.3, -0.8]], np.float32)
    ref = jgauss.make_gaussian_model().sim(key, jnp.asarray(theta[0]))
    z = np.asarray(jax.random.normal(key, (jgauss.NOISE_N,)))
    got = gaussian.gaussian_sim(torch.from_numpy(theta),
                                torch.from_numpy(z[None]))
    for k in ("mean", "std"):
        np.testing.assert_allclose(got[k].numpy()[0], np.asarray(ref[k]),
                                   rtol=1e-6, atol=1e-6)
    ref1 = jgauss.make_mean_only_model(0.5).sim(key, jnp.asarray([0.7]))
    z1 = np.asarray(jax.random.normal(key))
    got1 = gaussian.mean_only_sim(torch.tensor([[0.7]]),
                                  torch.tensor([float(z1)]), 0.5)
    np.testing.assert_allclose(got1["x"].numpy()[0], np.asarray(ref1["x"]),
                               rtol=1e-6)
    assert gaussian.conjugate_posterior(1.0) == jgauss.conjugate_posterior(
        1.0)


# ------------------------------------------------------------------- K20
def _sir_thetas(n=64):
    """64 thetas: prior draws, the prior's four corners and edge midpoints,
    and the true parameters."""
    rng = np.random.default_rng(4)
    edges = np.array([[0.05, 0.01], [0.05, 0.5], [1.0, 0.01], [1.0, 0.5],
                      [0.05, 0.2], [1.0, 0.2], [0.4, 0.01], [0.4, 0.5],
                      [0.4, 0.1]])
    draws = np.stack([rng.uniform(0.05, 1.0, n - len(edges)),
                      rng.uniform(0.01, 0.5, n - len(edges))], 1)
    return np.concatenate([draws, edges]).astype(np.float32)


def test_sir_plain_matches_jax():
    theta = _sir_thetas()
    jmodel = jsir.make_sir_model()
    ref = np.asarray(jax.vmap(lambda th: jmodel.sim(
        jax.random.key(0), th)["infected"])(jnp.asarray(theta)))
    model = sir.make_sir_model()
    got = model.simulate(torch.from_numpy(theta)).numpy()
    assert got.shape == (64, 15) and np.isfinite(got).all()
    np.testing.assert_array_equal(got[:, 0], np.float32(1.0))
    # same float32 RK4 operation order over 112 steps, values up to 1e3:
    # |err| <= 1e-3 + 1e-5 |ref| covers XLA's CPU code generation
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-3)
    # the round's flat rows are the same numbers (spec {"infected": 15})
    spec = SumStatSpec({"infected": np.zeros(15)})
    flat = model.simulate_flat(torch.from_numpy(theta), None, spec).numpy()
    np.testing.assert_array_equal(flat, got)


def test_sir_dt_prior_and_observation_match_jax():
    model = sir.make_sir_model()
    ts32 = np.linspace(0.0, 60.0, 15).astype(np.float32)
    assert model.dt == float((ts32[1] - ts32[0]) / np.float32(8))
    jprior, prior = jsir.default_prior(), sir.default_prior()
    assert list(prior.rv_map) == list(jprior.rv_map) == ["beta", "gamma"]
    for k, rv in prior.rv_map.items():
        assert (rv.name, (rv.loc, rv.scale)) == (
            jprior.rv_map[k].name, jprior.rv_map[k].args)
    assert sir.TRUE_PARS == jsir.TRUE_PARS and sir.Y0 == jsir.Y0
    # both packages add numpy's noise to their float32 ODE: equal up to
    # the RK4's rounding
    np.testing.assert_allclose(sir.observed_data(seed=11)["infected"],
                               jsir.observed_data(seed=11)["infected"],
                               rtol=1e-5, atol=1e-3)


def test_sir_noise_comes_from_the_philox_stream():
    theta = torch.from_numpy(_sir_thetas()[-8:])
    stream = philox.PhiloxStream(5, 2, philox.SIM_NOISE, 256,
                                 torch.tensor([0, 3, 0, 0],
                                              dtype=torch.int32))
    kw = dict(n_obs=15, n_substeps=8, dt=sir.make_sir_model().dt,
              n_pop=sir.N_POP)
    clean = sir_simulate_plain(theta, **kw)
    noisy = sir_simulate_plain(theta, noise_sd=10.0, stream=stream, **kw)
    z = philox.normals(stream, torch.arange(8), 0, 15)
    np.testing.assert_allclose((noisy - clean).numpy(), (10.0 * z).numpy(),
                               rtol=1e-5, atol=1e-4)
