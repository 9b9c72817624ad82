"""K4's Gaussian simulator (``kernels/gaussian_simulate.py``, plain
PyTorch on the CPU) against the JAX package's ``make_gaussian_model``, and
K4's mean-only simulator against ``make_mean_only_model``'s lane body.

JAX's threefry normals cannot be fed to the port, so the plain version's
own Philox normals go through the JAX model's formula (``mu + |sigma| z``,
``jnp.mean`` and ``jnp.std``): the rows agree within rel 1e-6 of the lane's
scale ``|mu| + |sigma|``. The model's rounds go through the kernel's
wrapper on every spec it can fill, the statistics in spec order. The
mean-only rows are the JAX lane body ``theta + noise_sd * z`` on the same
normals within one float32 rounding of ``|theta| + |noise_sd z|``.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from pyabc_tpu.models import gaussian as jgauss  # noqa: E402
from pyabc_tpu_torch.core.sumstat_spec import SumStatSpec  # noqa: E402
from pyabc_tpu_torch.kernels import philox  # noqa: E402
from pyabc_tpu_torch.kernels.gaussian_simulate import (  # noqa: E402
    gaussian_noise_plain, gaussian_simulate, gaussian_simulate_plain,
    mean_only_noise_plain, mean_only_simulate, mean_only_simulate_plain)
from pyabc_tpu_torch.models import gaussian  # noqa: E402
from pyabc_tpu_torch.models import model_selection as msel  # noqa: E402

torch.set_num_threads(1)


def _stream(round_idx=0, gen=3, seed=5, lane0=0):
    counters = torch.zeros(5, dtype=torch.int32)
    counters[philox.ROUND] = round_idx
    return philox.PhiloxStream(seed, gen, philox.SIM_NOISE, 256, counters,
                               lane0=lane0)


def _theta(B, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([rng.normal(0.0, 1.0, B),
                     rng.uniform(-1.5, 1.5, B)], 1).astype(np.float32)


def _jax_rows(theta, z):
    def one(th, zz):
        x = th[0] + jnp.abs(th[1]) * zz
        return jnp.stack([jnp.mean(x), jnp.std(x)])

    return np.asarray(jax.vmap(one)(jnp.asarray(theta), jnp.asarray(z)))


@pytest.mark.parametrize("n", [jgauss.NOISE_N, 1, 3, 7, 13])
def test_plain_matches_jax_formula_on_the_port_normals(n):
    B = 4096
    theta = _theta(B, n)
    stream = _stream()
    got = gaussian_simulate_plain(torch.from_numpy(theta), n=n,
                                  stream=stream).numpy()
    z = gaussian_noise_plain(stream, B, n).numpy()
    ref = _jax_rows(theta, z)
    scale = np.abs(theta[:, :1]) + np.abs(theta[:, 1:])
    assert got.shape == (B, 2)
    assert np.max(np.abs(got - ref) / scale) < 1e-6


def test_noise_is_the_lanes_philox_normals():
    """Normal number j of lane b: block j // 4 of the simulator-noise
    stream at the round's counter, as every in-kernel draw."""
    stream = _stream(round_idx=7)
    z = gaussian_noise_plain(stream, 64, 10)
    lanes = torch.arange(64, dtype=torch.int64)
    np.testing.assert_array_equal(z.numpy(),
                                  philox.normals(stream, lanes, 0, 10).numpy())
    other = gaussian_noise_plain(_stream(round_idx=8), 64, 10)
    assert not torch.equal(z, other)


def test_model_rounds_go_through_the_wrapper():
    """``simulate_flat`` is the kernel's wrapper on every spec the model
    can fill (its plain version on CPU tensors: no launch counted): the
    kernel writes the observed statistics in spec order, an observed mean
    or std alone being its one column; a statistic the model lacks raises
    as the generic path does."""
    model = gaussian.make_gaussian_model()
    spec = SumStatSpec({"mean": 0.4, "std": 1.1})
    theta = torch.from_numpy(_theta(256))
    stream = _stream()
    before = gaussian_simulate.launches
    rows = model.simulate_flat(theta, None, spec, stream=stream)
    assert gaussian_simulate.launches == before
    both = gaussian_simulate_plain(theta, n=10, stream=stream).numpy()
    np.testing.assert_array_equal(rows.numpy(), both)
    for obs, col in (({"mean": 0.4}, 0), ({"std": 1.1}, 1)):
        flat = model.simulate_flat(theta, None, SumStatSpec(obs),
                                   stream=stream)
        assert flat.shape == (256, 1)
        np.testing.assert_array_equal(flat.numpy()[:, 0], both[:, col])
    with pytest.raises(KeyError, match="lacks"):
        model.simulate_flat(theta, None, SumStatSpec({"mean": 0.4, "x": 1}),
                            stream=stream)
    # a user's call outside the rounds draws on the generator's stream
    gen = torch.Generator().manual_seed(0)
    out = model.sim(theta, gen)
    assert set(out) == {"mean", "std"} and torch.isfinite(out["std"]).all()


@pytest.mark.parametrize("columns", [(0, 1), (1, 0), (0, -1), (-1, 0)])
def test_plain_version_writes_the_columns_in_spec_order(columns):
    theta = torch.from_numpy(_theta(64))
    stream = _stream()
    both = gaussian_simulate_plain(theta, n=10, stream=stream)
    got = gaussian_simulate_plain(theta, n=10, stream=stream,
                                  columns=columns)
    assert got.shape == (64, sum(c >= 0 for c in columns))
    for src, c in enumerate(columns):
        if c >= 0:
            assert torch.equal(got[:, c], both[:, src])
    with pytest.raises(ValueError, match="must fill"):
        gaussian_simulate_plain(theta, n=10, stream=stream, columns=(0, 2))


def test_mean_only_observation_runs_through_the_kernel():
    """Config 1's model observed through its mean alone: the run's rounds
    are the kernel's (plain version on the CPU), one column a row."""
    import pyabc_tpu_torch as tpt

    abc = tpt.ABCSMC(gaussian.make_gaussian_model(), gaussian.default_prior(),
                     tpt.PNormDistance(p=2), population_size=200,
                     fused_generations=1, seed=1, device="cpu")
    abc.new("sqlite://", {"mean": 0.4})
    h = abc.run(max_nr_populations=3)
    assert h.max_t == 2
    df, w = h.get_distribution(0, h.max_t)
    # the posterior of mu given a mean near 0.4 sits near it
    assert abs(float(np.sum(df["mu"] * w)) - 0.4) < 0.3


def test_the_draws_keep_the_jax_law():
    """The kernel's draws follow jax.random's law: over 2e5 lanes at theta
    (0.3, -0.8) the means and stds of both packages agree in distribution
    (a declared difference of bits, not of law)."""
    from scipy import stats as sps

    B = 200_000
    theta = np.tile(np.float32([[0.3, -0.8]]), (B, 1))
    port = gaussian_simulate(torch.from_numpy(theta), n=10,
                             stream=_stream()).numpy()
    keys = jax.random.split(jax.random.key(0), B)
    sim = jgauss.make_gaussian_model().sim
    ref = jax.vmap(lambda k: sim(k, jnp.asarray([0.3, -0.8])))(keys)
    for col, name in enumerate(("mean", "std")):
        ks = sps.ks_2samp(port[:, col], np.asarray(ref[name]))
        assert ks.pvalue > 1e-3, (name, ks)


# ------------------------------------------------- K4's mean-only kernel
@pytest.mark.parametrize("noise_sd", [0.5, 0.6, 1.2])
def test_mean_only_plain_matches_the_jax_lane_body(noise_sd):
    """``make_mean_only_model``'s lane body (``theta[0] + noise_sd *
    jax.random.normal(key)``, ``pyabc_tpu/models/gaussian.py:44``) in jnp
    float32 on the port's normals: within one float32 rounding (2^-23) of
    the row's scale |theta| + |noise_sd z| (XLA may fuse the product and
    the sum where the port rounds each)."""
    B = 4096
    theta = _theta(B, 7)
    stream = _stream(round_idx=2)
    got = mean_only_simulate_plain(torch.from_numpy(theta),
                                   noise_sd=noise_sd, stream=stream).numpy()
    z = mean_only_noise_plain(stream, B).numpy()
    ref = np.asarray(jax.vmap(lambda th, zz: th[0] + noise_sd * zz)(
        jnp.asarray(theta), jnp.asarray(z)))
    scale = np.abs(theta[:, 0]) + np.abs(np.float32(noise_sd) * z)
    assert got.shape == (B, 1)
    assert np.max(np.abs(got[:, 0] - ref) / scale) <= 2.0 ** -23


def test_mean_only_noise_is_normal_0_of_the_lanes_stream():
    """Lane b's z is the cosine of the first Box-Muller pair of Philox
    block 0 of its global lane on the simulator-noise stream."""
    stream = _stream(round_idx=5, lane0=40)
    z = mean_only_noise_plain(stream, 24)
    lanes = torch.arange(40, 64, dtype=torch.int64)
    w = philox.lane_blocks(stream, lanes, torch.tensor(0))
    want = philox.box_muller(philox.uniform_of(w[0]),
                             philox.uniform_of(w[1]), False)
    np.testing.assert_array_equal(z.numpy(), want.numpy())
    np.testing.assert_array_equal(
        z.numpy(), philox.normals(stream, lanes, 0, 1)[:, 0].numpy())
    assert not torch.equal(z, mean_only_noise_plain(_stream(round_idx=6,
                                                            lane0=40), 24))


def test_mean_only_draws_keep_the_jax_law():
    """Over three seeds of 1e5 lanes at theta 0.3, the port's x and the JAX
    model's (``jax.random.normal`` through ``make_mean_only_model``) agree
    in distribution (a declared difference of bits, not of law)."""
    from scipy import stats as sps

    B = 100_000
    theta = torch.full((B, 1), 0.3)
    sim = jgauss.make_mean_only_model(noise_sd=0.5).sim
    for seed in range(3):
        port = mean_only_simulate(theta, noise_sd=0.5,
                                  stream=_stream(seed=seed))[:, 0].numpy()
        keys = jax.random.split(jax.random.key(seed), B)
        ref = np.asarray(jax.vmap(lambda k: sim(k, jnp.asarray([0.3])))(
            keys)["x"])
        ks = sps.ks_2samp(port, ref)
        assert ks.pvalue > 1e-3, (seed, ks)


def test_mean_only_rounds_go_through_the_wrapper():
    """The toy's and each pair model's ``simulate_flat`` is the kernel's
    wrapper (its plain version on CPU tensors: no launch counted); a user's
    call draws on the generator's stream; a statistic the model lacks
    raises as the generic path does."""
    theta = torch.from_numpy(_theta(256)[:, :1]).contiguous()
    stream = _stream()
    spec = SumStatSpec({"x": 1.0})
    models = [gaussian.make_mean_only_model(0.5)] + msel.tractable_pair()[0]
    for model, sd in zip(models, (0.5, 0.6, 1.2)):
        assert isinstance(model, gaussian.MeanOnlyGaussianModel)
        before = mean_only_simulate.launches
        rows = model.simulate_flat(theta, None, spec, stream=stream)
        assert mean_only_simulate.launches == before
        np.testing.assert_array_equal(
            rows.numpy(), mean_only_simulate_plain(
                theta, noise_sd=sd, stream=stream).numpy())
        with pytest.raises(KeyError, match="lacks"):
            model.simulate_flat(theta, None, SumStatSpec({"x": 1.0, "y": 2}),
                                stream=stream)
        with pytest.raises(ValueError, match="scalar"):
            model.simulate_flat(theta, None,
                                SumStatSpec({"x": np.zeros(3)}),
                                stream=stream)
        out = model.sim(theta, torch.Generator().manual_seed(0))
        assert set(out) == {"x"} and out["x"].shape == (256,)
        assert torch.isfinite(out["x"]).all()


def test_mean_only_odd_shape_and_lane_base():
    """B 257 lanes of stride 2: one (B, 1) row a lane from theta's first
    column alone (the second changes nothing); the lanes [128, 257) with
    the lane base 128 are those rows of the whole round, bit for bit."""
    theta = torch.from_numpy(_theta(257, 3))
    full = mean_only_simulate_plain(theta, noise_sd=0.6, stream=_stream())
    assert full.shape == (257, 1)
    other = theta.clone()
    other[:, 1] += 1.0
    assert torch.equal(full, mean_only_simulate_plain(
        other, noise_sd=0.6, stream=_stream()))
    assert torch.equal(full, mean_only_simulate_plain(
        theta[:, :1].contiguous(), noise_sd=0.6, stream=_stream()))
    part = mean_only_simulate_plain(theta[128:], noise_sd=0.6,
                                    stream=_stream(lane0=128))
    assert torch.equal(part, full[128:])
