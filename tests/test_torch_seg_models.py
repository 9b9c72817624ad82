"""Segmented early reject over several models: the segmented ODE family's
step against the JAX package's, the family's chained segments against its
full trajectory, K18's K > 1 mode on and off (the family, two birth-death
models), and the zoo's model-selection leg against the JAX package on the
CPU.

The contract is the JAX engine's: each slot steps its own model's
segments, and with a fixed p-norm early reject skips only provably
rejected work, so the populations, the models and the epsilon trail are
bit-identical on and off.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import pyabc_tpu as jpt  # noqa: E402
from pyabc_tpu.models import model_selection as jmsel  # noqa: E402
import pyabc_tpu_torch as tpt  # noqa: E402
from pyabc_tpu_torch.kernels import philox  # noqa: E402
from pyabc_tpu_torch.kernels.ode_family import (  # noqa: E402
    ode_family_segments)
from pyabc_tpu_torch.models import gillespie as tg  # noqa: E402
from pyabc_tpu_torch.models import model_selection as tmsel  # noqa: E402
from pyabc_tpu_torch.utils import pick_batch  # noqa: E402

torch.set_num_threads(1)

K = 3
DIMS = (1, 2, 2)
SMALL = dict(n_leaps=100, n_obs=20)
#: the zoo's model-selection leg on the CPU (bench.py:1189-1194): pop 192
#: (the bench's CPU size), 3 generations, G 3
ZOO_POP, ZOO_GENS = 192, 3
#: band on seed-mean model probabilities: the JAX package's own runs at
#: seeds 1 and 2 of this leg give P = (0.21, 0.66, 0.13) and (0.12, 0.71,
#: 0.18), a per-seed spread of about 0.06, so a 2-seed mean carries about
#: 0.04 of Monte Carlo error and the port's 4-seed mean about 0.03; 0.1 is
#: about two standard errors of their difference
PROB_ATOL = 0.1


def _theta(B: int, seed: int):
    rng = np.random.default_rng(seed)
    theta = np.stack([rng.uniform(0.05, 1.05, B), rng.uniform(1.0, 10.0, B)],
                     axis=1).astype(np.float32)
    m = rng.integers(0, K, B).astype(np.int32)
    theta[m == 0, 1] = 0.0
    return theta, m


def _stream(seed: int = 4) -> philox.PhiloxStream:
    return philox.PhiloxStream(seed, 1, philox.SIM_NOISE, 8,
                               torch.zeros(4, dtype=torch.int32))


# ------------------------------------------------------------ the step
@pytest.mark.parametrize("k", range(K))
def test_family_step_matches_jax(k):
    """Model k's segments against the JAX package's segmented family step
    on the same theta, noise off (the streams differ by design): the same
    float32 RK4 in the same operation order, within 1e-5 relative."""
    B = 64
    theta, _m = _theta(B, seed=k)
    jseg = jmsel.ode_family(segments=4, noise_sd=0.0)[0][k].segmented
    keys = jax.random.split(jax.random.key(3), B)
    th = jnp.asarray(theta[:, :DIMS[k]])

    def lane(key, t):
        carry = jseg.init(key, t)
        out = []
        for seg in range(4):
            carry, ys = jseg.step(carry, seg)
            out.append(ys)
        return jnp.concatenate(out)

    ref = np.asarray(jax.vmap(lane)(keys, th))
    spec = tmsel.ode_family(segments=4, noise_sd=0.0)[0][k].family.specs[k]
    got = ode_family_segments(spec, torch.from_numpy(theta[:, :DIMS[k]]),
                              _stream())[0].numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    ts = jmsel.ode_family(segments=4)[2]
    np.testing.assert_array_equal(tmsel.ode_family(segments=4)[2], ts)


def test_chained_segments_equal_the_full_trajectory():
    """Segments run one range at a time from the carried state give the
    full trajectory's bits, noise on, every lane its own model."""
    B = 96
    theta, m = _theta(B, seed=7)
    specs = tmsel.ode_family(segments=4)[0][0].family.specs
    th, mm, st = torch.from_numpy(theta), torch.from_numpy(m), _stream(9)
    full, y_end = ode_family_segments(specs, th, st, m=mm,
                                      return_state=True)
    parts, state = [], None
    for seg in range(4):
        out, state = ode_family_segments(specs, th, st, m=mm, state=state,
                                         seg_from=seg, seg_to=seg + 1,
                                         return_state=True)
        parts.append(out)
    assert torch.equal(torch.cat(parts, dim=1), full)
    assert torch.equal(state, y_end)
    # each lane's row is its own model's chain
    for k in range(K):
        own = ode_family_segments(specs[k], th, st)[0]
        assert torch.equal(full[mm == k], own[mm == k])


def test_observed_segmented_family_is_the_chain_plus_numpy_noise():
    obs = tmsel.observed_ode_family(seed=0, true_model=1, segments=4)["y"]
    clean = tmsel.observed_ode_family(seed=0, true_model=1, segments=4,
                                      noise_sd=0.0)["y"]
    noise = np.random.default_rng(0).standard_normal(12).astype(np.float32)
    np.testing.assert_allclose(obs, clean + np.float32(0.3) * noise,
                               atol=1e-6)
    ref = np.asarray(jmsel.ode_family(segments=4, noise_sd=0.0)[0][1]
                     .sim(jax.random.key(0), jnp.asarray([0.4, 0.5]))["y"])
    np.testing.assert_allclose(clean, ref, rtol=1e-5)


# ------------------------------------------------- K > 1 on and off
def _run(models, priors, obs, early, *, pop, gens, seed):
    abc = tpt.ABCSMC(models, priors, tpt.PNormDistance(p=2),
                     population_size=pop, eps=tpt.MedianEpsilon(),
                     seed=seed, early_reject=early, fused_generations=gens,
                     device="cpu")
    abc.new("sqlite://", obs)
    return abc, abc.run(max_nr_populations=gens)


def _assert_identical(h_on, h_off, K_: int, B: int):
    assert h_on.max_t == h_off.max_t
    np.testing.assert_array_equal(h_on.get_all_populations()["epsilon"],
                                  h_off.get_all_populations()["epsilon"])
    retired = 0
    for t in range(h_on.max_t + 1):
        p_on = h_on.get_model_probabilities(t)["p"]
        p_off = h_off.get_model_probabilities(t)["p"]
        np.testing.assert_array_equal(p_on.to_numpy(), p_off.to_numpy())
        assert p_on.sum() == pytest.approx(1.0)
        for m in range(K_):
            if float(p_on.get(m, 0.0)) == 0.0:
                continue
            a, wa = h_on.get_distribution(m=m, t=t)
            b, wb = h_off.get_distribution(m=m, t=t)
            assert np.array_equal(a.to_numpy(), b.to_numpy())
            assert np.array_equal(wa, wb)
        d_on = h_on.get_weighted_distances(t)["distance"].to_numpy()
        d_off = h_off.get_weighted_distances(t)["distance"].to_numpy()
        assert np.array_equal(d_on, d_off)
        tel_on, tel_off = h_on.get_telemetry(t), h_off.get_telemetry(t)
        assert tel_on["rounds"] == tel_off["rounds"]
        assert tel_on["n_evaluations"] == tel_off["n_evaluations"]
        assert tel_on["seg_resolved"] == tel_on["rounds"] * B
        assert 0.0 < tel_on["segment_occupancy"] <= 1.0
        retired += tel_on["retired_early"]
    assert retired > 0


def test_family_on_off_bit_identical():
    obs = {k: np.asarray(v) for k, v in
           jmsel.observed_ode_family(seed=0, segments=4).items()}
    hs = []
    for early in ("auto", False):
        models, priors, _ts = tmsel.ode_family(segments=4)
        hs.append(_run(models, priors, obs, early, pop=128, gens=3,
                       seed=5)[1])
    _assert_identical(*hs, K, pick_batch(128))


def test_two_birth_death_models_on_off_bit_identical():
    """Two built-in birth-death models (initial counts 40 and 25) in one
    segmented round, each slot stepping its own model's descriptor."""
    obs = tg.observed_birth_death(segments=5, **SMALL)
    hs = []
    for early in ("auto", False):
        models = [tg.make_birth_death_model(segments=5, **SMALL),
                  tg.make_birth_death_model(x0=25.0, segments=5, name="bd25",
                                            **SMALL)]
        priors = [tg.birth_death_prior(), tg.birth_death_prior()]
        hs.append(_run(models, priors, obs, early, pop=64, gens=3,
                       seed=2)[1])
    _assert_identical(*hs, 2, pick_batch(64))


def test_one_family_model_alone_runs_early_reject():
    obs = tmsel.observed_ode_family(seed=1, true_model=2, segments=4)
    models, priors, _ts = tmsel.ode_family(segments=4)
    _abc, h = _run(models[2], priors[2], obs, True, pop=64, gens=2, seed=1)
    assert h.max_t == 1
    assert sum(h.get_telemetry(t)["retired_early"] for t in range(2)) > 0


# ------------------------------------------------- the zoo's leg
def test_model_probabilities_match_jax():
    """The zoo's model-selection leg (ode_family(segments=4), the JAX
    observation observed_ode_family(seed=0, segments=4), PNormDistance,
    MedianEpsilon, early reject on): the port's 4-seed mean model
    probabilities against the JAX package's 2-seed mean, within
    PROB_ATOL."""
    obs = {k: np.asarray(v) for k, v in
           jmsel.observed_ode_family(seed=0, segments=4).items()}
    ours = []
    for seed in (1, 2, 3, 4):
        models, priors, _ts = tmsel.ode_family(segments=4)
        abc, h = _run(models, priors, obs, "auto", pop=ZOO_POP,
                      gens=ZOO_GENS, seed=seed)
        assert h.max_t == ZOO_GENS - 1
        p = h.get_model_probabilities(h.max_t)["p"]
        assert p.sum() == pytest.approx(1.0)
        ours.append([float(p.get(k, 0.0)) for k in range(K)])
    theirs = []
    jctx = None
    for seed in (1, 2):
        jmodels, jpriors, _ts = jmsel.ode_family(segments=4)
        jabc = jpt.ABCSMC(jmodels, jpriors, jpt.PNormDistance(p=2),
                          population_size=ZOO_POP, eps=jpt.MedianEpsilon(),
                          seed=seed, early_reject="auto",
                          fused_generations=ZOO_GENS)
        jabc.new("sqlite://", obs)
        if jctx is not None:
            jabc._device_ctx = jctx
        jh = jabc.run(max_nr_populations=ZOO_GENS)
        jctx = jabc._device_ctx
        jp = jh.get_model_probabilities(jh.max_t)["p"]
        theirs.append([float(jp.get(k, 0.0)) for k in range(K)])
    gap = np.abs(np.mean(ours, axis=0) - np.mean(theirs, axis=0))
    assert (gap < PROB_ATOL).all(), (ours, theirs)
