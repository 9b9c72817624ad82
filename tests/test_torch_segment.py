"""Segmented early reject: the port's protocol, bound, network SIR step,
segmented round (K18's plain version) and driver against the JAX package
on the CPU.

The contract under test is the JAX engine's: with early reject on, the
accepted populations are bit-identical with the classic run (only provably
rejected work is skipped), candidates retire only where the p-norm's prefix
bound is sound, and configurations the engine cannot serve take the
classic path or raise with the JAX package's reason; those the port does
not serve yet raise ``not_ported``.
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
from pyabc_tpu.models import sir as jsir  # noqa: E402
from pyabc_tpu.ops import segment as jseg  # noqa: E402
import pyabc_tpu_torch as tpt  # noqa: E402
from pyabc_tpu_torch.core.sumstat_spec import SumStatSpec  # noqa: E402
from pyabc_tpu_torch.distance.scale import standard_deviation  # noqa: E402
from pyabc_tpu_torch.epsilon import ExpDecayFixedIterScheme  # noqa: E402
from pyabc_tpu_torch.kernels import philox  # noqa: E402
from pyabc_tpu_torch.kernels.segment_round import (  # noqa: E402
    LANE_SLOTS, RESOLVED, RETIRED, SEG_STEPS, segment_round)
from pyabc_tpu_torch.models import gillespie as tg  # noqa: E402
from pyabc_tpu_torch.models import lotka_volterra as tlv  # noqa: E402
from pyabc_tpu_torch.models import sir as tsir  # noqa: E402
from pyabc_tpu_torch.ops import segment as tseg  # noqa: E402

torch.set_num_threads(1)

SMALL = dict(n_leaps=100, n_obs=20)


def _models(name):
    if name == "bd":
        return (tg.make_birth_death_model(segments=5, **SMALL),
                jg.make_birth_death_model(segments=5, **SMALL))
    if name == "lv":
        return (tg.make_stochastic_lv_model(segments=4, **SMALL),
                jg.make_stochastic_lv_model(segments=4, **SMALL))
    return tsir.make_network_sir_model(), jsir.make_network_sir_model()


# ------------------------------------------------------------ protocol
@pytest.mark.parametrize("name", ["bd", "lv", "network_sir"])
def test_index_map_equals_jax(name):
    ours, theirs = _models(name)
    jspec = theirs.sumstat_spec()
    spec = SumStatSpec({k: np.zeros(jspec.shapes[k]) for k in jspec.names})
    got = tseg.index_map_for(ours.segmented, spec)
    ref = jseg.index_map_for(theirs.segmented, jspec)
    assert got.dtype == ref.dtype and np.array_equal(got, ref)
    assert ours.segmented.layout == theirs.segmented.layout
    # every flat position is emitted exactly once
    assert sorted(got.reshape(-1).tolist()) == list(range(spec.total_size))


def test_protocol_reasons_match_jax():
    lv_t = tlv.make_lv_model()
    from pyabc_tpu.models import lotka_volterra as jlv
    lv_j = jlv.make_lv_model()
    ours = tseg.uniform_protocol_reason([lv_t])
    theirs = jseg.uniform_protocol_reason([lv_j])
    assert ours.replace("TorchModel", "JaxModel") == theirs
    assert tseg.uniform_protocol_reason([_models("bd")[0]]) is None
    two = [tg.make_birth_death_model(segments=5, **SMALL),
           tg.make_birth_death_model(segments=4, **SMALL)]
    assert "differ" in tseg.uniform_protocol_reason(two)


def test_segment_chain_equals_the_classic_simulator():
    """The segmented round's plain version, run at eps = inf, returns for
    every slot the statistics the classic path computes for it (one range
    launch of K19's plain version), bit for bit."""
    model = tg.make_stochastic_lv_model(segments=4, **SMALL)
    spec = SumStatSpec({"pred": np.zeros(20), "prey": np.zeros(20)})
    B = 64
    gen = torch.Generator()
    gen.manual_seed(3)
    theta = tg.stochastic_lv_prior().rvs_array(B, gen, torch.device("cpu"))
    ctr = torch.zeros(4, dtype=torch.int32)
    st = philox.PhiloxStream(7, 3, philox.SIM_NOISE, 8, ctr)
    classic = model.simulate_flat(theta, gen, spec, stream=st)
    seg_ctr = torch.zeros(4, dtype=torch.int64)
    ss, keep = segment_round(
        model.segmented, theta, torch.ones(B, dtype=torch.bool), st,
        imap=model.index_map(spec, "cpu"), x0=torch.zeros(40),
        w=torch.ones(40), p=2.0, eps=torch.tensor(math.inf), width=40,
        seg_ctr=seg_ctr)
    assert keep.all() and torch.equal(ss, classic)
    assert seg_ctr.tolist() == [0, 4 * B, B, 4 * B]


# ---------------------------------------------------------------- bound
@pytest.mark.parametrize("p", [1.0, 2.0, math.inf])
def test_pnorm_bound_matches_jax(p):
    """The port's prefix bound folds the same prefixes to JAX's values
    within float32 rounding, is sound (never exceeds the full distance) and
    decides exceeds alike away from the threshold."""
    rng = np.random.default_rng(0)
    S, B = 24, 16
    w = rng.uniform(0.1, 2.0, S).astype(np.float32)
    x = rng.normal(size=(B, S)).astype(np.float32)
    x0 = rng.normal(size=S).astype(np.float32)
    jbound = jpt.PNormDistance(p=p).device_bound_fn(None)
    tbound = tpt.PNormDistance(p=p).device_bound_fn(None)
    jfull = jax.vmap(lambda r: jpt.PNormDistance(p=p).device_fn(None)(
        r, jnp.asarray(x0), jnp.asarray(w)))(jnp.asarray(x))
    jacc = jnp.broadcast_to(jbound["init"](), (B,))
    tacc = tbound["init"](B)
    for lo in range(0, S, 6):
        idx = np.arange(lo, lo + 6)
        jacc = jax.vmap(lambda a, v: jbound["step"](
            a, v, jnp.asarray(idx), jnp.asarray(x0), jnp.asarray(w)))(
            jacc, jnp.asarray(x[:, idx]))
        tacc = tbound["step"](tacc, torch.from_numpy(x[:, idx]), idx,
                              torch.from_numpy(x0), torch.from_numpy(w))
        np.testing.assert_allclose(tacc.numpy(), np.asarray(jacc),
                                   rtol=2e-6)
        for scale in (1.0, 1.5):
            thr = np.asarray(jfull) * scale
            tex = tbound["exceeds"](tacc, torch.from_numpy(thr))
            jex = jax.vmap(lambda a, t: jbound["exceeds"](
                a, t, jnp.asarray(w)))(jacc, jnp.asarray(thr))
            assert np.array_equal(tex.numpy(), np.asarray(jex))
            assert not tex.any()  # sound at and above the distance
    low = torch.from_numpy(np.asarray(jfull) * 0.9)
    assert tbound["exceeds"](tacc, low).all()


# ---------------------------------------------------------- network SIR
def test_network_sir_step_matches_jax():
    """All 128 statistics of the network SIR (noise_sd = 0) agree with the
    JAX simulator within 1e-4 relative, and the segment chain emits them
    in the JAX step's order."""
    ours, theirs = _models("network_sir")
    rng = np.random.default_rng(4)
    B = 64
    theta = np.stack([rng.uniform(0.05, 1.0, B), rng.uniform(0.01, 0.5, B)],
                     axis=1).astype(np.float32)
    ref = np.asarray(jax.vmap(lambda th: theirs.sim(jax.random.key(0), th)[
        "infected"])(jnp.asarray(theta)))
    gen = torch.Generator()
    got = ours.sim(torch.from_numpy(theta), gen)["infected"].numpy()
    assert got.shape == ref.shape == (B, 128)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    # the JAX protocol's own step, one segment at a time, emits the same
    jcarry = theirs.segmented.init(jax.random.key(0), jnp.asarray(theta[0]))
    carry = ours.segmented.init(torch.from_numpy(theta[:1]))
    for j in range(4):
        jcarry, jvals = theirs.segmented.step(jcarry, j)
        carry, vals = ours.segmented.step(carry, j, None)
        np.testing.assert_allclose(vals[0].numpy(), np.asarray(jvals),
                                   rtol=1e-4, atol=1e-4)


def test_network_sir_noise_is_keyed_by_slot_and_segment():
    model = tsir.make_network_sir_model(noise_sd=5.0)
    det = tsir.make_network_sir_model()
    theta = torch.tensor([[0.4, 0.1]] * 8)
    st = philox.PhiloxStream(3, 1, philox.SIM_NOISE, 4,
                             torch.zeros(4, dtype=torch.int32))
    spec = SumStatSpec({"infected": np.zeros(128)})
    noisy = model.simulate_flat(theta, None, spec, stream=st)
    clean = det.simulate_flat(theta, None, spec, stream=st)
    z = philox.normals(st, torch.arange(8), 0, 128)
    torch.testing.assert_close(noisy, clean + 5.0 * z, rtol=0, atol=1e-4)


# ------------------------------------------------------------ ON / OFF
def _run(make, prior, obs, early, *, pop=64, gens=3, seed=11):
    abc = tpt.ABCSMC(make(), prior, tpt.PNormDistance(p=2),
                     population_size=pop, eps=tpt.MedianEpsilon(), seed=seed,
                     early_reject=early, fused_generations=gens,
                     device="cpu")
    abc.new("sqlite://", obs)
    return abc, abc.run(max_nr_populations=gens)


@pytest.mark.parametrize("name", ["bd", "lv"])
def test_early_reject_populations_bit_identical(name):
    """ON vs OFF: theta, weights, distances and the epsilon trail are
    bit-identical in every generation, with the same rounds and
    evaluations; lanes did retire, and the telemetry counts add up."""
    if name == "bd":
        make = lambda: tg.make_birth_death_model(segments=5, **SMALL)  # noqa
        prior = tg.birth_death_prior()
        obs = jg.observed_birth_death(segments=5, **SMALL)
    else:
        make = lambda: tg.make_stochastic_lv_model(segments=4, **SMALL)  # noqa
        prior = tg.stochastic_lv_prior()
        obs = jg.observed_stochastic_lv(segments=4, **SMALL)
    obs = {k: np.asarray(v) for k, v in obs.items()}
    _a_on, h_on = _run(make, prior, obs, "auto")
    _a_off, h_off = _run(make, prior, obs, False)
    assert h_on.max_t == h_off.max_t == 2
    np.testing.assert_array_equal(h_on.get_all_populations()["epsilon"],
                                  h_off.get_all_populations()["epsilon"])
    retired = 0
    for t in range(h_on.max_t + 1):
        df1, w1 = h_on.get_distribution(m=0, t=t)
        df2, w2 = h_off.get_distribution(m=0, t=t)
        assert np.array_equal(df1.to_numpy(), df2.to_numpy())
        assert np.array_equal(w1, w2)
        d1 = h_on.get_weighted_distances(t)["distance"].to_numpy()
        d2 = h_off.get_weighted_distances(t)["distance"].to_numpy()
        assert np.array_equal(d1, d2)
        tel_on, tel_off = h_on.get_telemetry(t), h_off.get_telemetry(t)
        assert tel_on["rounds"] == tel_off["rounds"]
        assert tel_on["n_evaluations"] == tel_off["n_evaluations"]
        assert "retired_early" not in tel_off
        assert tel_on["seg_resolved"] == tel_on["rounds"] * 256
        assert 0.0 < tel_on["segment_occupancy"] <= 1.0
        assert tel_on["seg_steps"] <= tel_on["seg_resolved"] * (
            5 if name == "bd" else 4)
        retired += tel_on["retired_early"]
    assert retired > 0


def test_retired_slots_are_provably_rejected():
    """Every slot the plain segmented round retires would have been
    rejected by the full accept test, and every kept slot's statistics are
    the classic ones."""
    model = tg.make_birth_death_model(segments=5, **SMALL)
    spec = SumStatSpec({"x": np.zeros(20)})
    B = 256
    gen = torch.Generator()
    gen.manual_seed(5)
    theta = tg.birth_death_prior().rvs_array(B, gen, torch.device("cpu"))
    valid = torch.rand(B, generator=gen) > 0.1
    st = philox.PhiloxStream(2, 4, philox.SIM_NOISE, 8,
                             torch.zeros(4, dtype=torch.int32))
    x0 = torch.tensor(np.asarray(jg.observed_birth_death(
        segments=5, **SMALL)["x"], np.float32))
    w = torch.ones(20)
    full = model.simulate_flat(theta, gen, spec, stream=st)
    d = tpt.PNormDistance(p=2).rows(full, x0, w)
    eps = torch.quantile(d, 0.3)
    seg_ctr = torch.zeros(4, dtype=torch.int64)
    ss, keep = segment_round(model.segmented, theta, valid, st,
                             imap=model.index_map(spec, "cpu"), x0=x0, w=w,
                             p=2.0, eps=eps, width=20, seg_ctr=seg_ctr)
    retired = ~keep & valid
    assert retired.any() and not (d[retired] <= eps).any()
    assert torch.equal(ss[keep], full[keep])
    assert seg_ctr[RETIRED] == int((~keep).sum())
    assert seg_ctr[RESOLVED] == B and seg_ctr[LANE_SLOTS] == 5 * B
    assert seg_ctr[SEG_STEPS] < 5 * B


# --------------------------------------------------------------- gates
def _bd_abc(**kw):
    obs = {k: np.asarray(v) for k, v in jg.observed_birth_death(
        segments=5, **SMALL).items()}
    dist = kw.pop("distance", tpt.PNormDistance(p=2))
    abc = tpt.ABCSMC(kw.pop("models", tg.make_birth_death_model(
        segments=5, **SMALL)), kw.pop("priors", tg.birth_death_prior()),
        dist, population_size=32, device="cpu", **kw)
    abc.new("sqlite://", obs)
    return abc


def test_required_early_reject_raises_the_jax_error_on_lv_config2():
    from pyabc_tpu.models import lotka_volterra as jlv

    abc = tpt.ABCSMC(tlv.make_lv_model(), tlv.default_prior(),
                     tpt.PNormDistance(p=2), population_size=32,
                     early_reject=True, device="cpu")
    abc.new("sqlite://", tlv.observed_data(seed=123))
    with pytest.raises(ValueError, match="early_reject=True unavailable") \
            as ours:
        abc.run(max_nr_populations=2)
    jabc = jpt.ABCSMC(jlv.make_lv_model(), jlv.default_prior(),
                      jpt.PNormDistance(p=2), population_size=32,
                      early_reject=True, fused_generations=4)
    jabc.new("sqlite://", jlv.observed_data(seed=123))
    with pytest.raises(ValueError, match="early_reject=True unavailable") \
            as theirs:
        jabc.run(max_nr_populations=2)
    assert str(ours.value).replace("TorchModel", "JaxModel") == \
        str(theirs.value)


def test_auto_on_a_plain_model_takes_the_classic_path():
    abc = tpt.ABCSMC(tlv.make_lv_model(), tlv.default_prior(),
                     tpt.PNormDistance(p=2), population_size=32,
                     device="cpu")
    abc.new("sqlite://", tlv.observed_data(seed=123))
    h = abc.run(max_nr_populations=2)
    assert h.max_t == 1 and "retired_early" not in h.get_telemetry(1)


def test_adaptive_mad_follows_the_jax_reason():
    """The default MAD scale is not moment-decomposable: the JAX engine
    refuses it, so "auto" runs classic and True raises its reason."""
    abc = _bd_abc(distance=tpt.AdaptivePNormDistance(p=2))
    h = abc.run(max_nr_populations=2)
    assert "retired_early" not in h.get_telemetry(1)
    abc = _bd_abc(distance=tpt.AdaptivePNormDistance(p=2),
                  early_reject=True)
    with pytest.raises(ValueError, match="moment-decomposable"):
        abc.run(max_nr_populations=2)


@pytest.mark.parametrize("mode", ["adaptive", "noisy", "models"])
def test_unserved_modes_raise_not_ported(mode):
    """Noisy ABC, which the JAX engine serves and the port does not yet,
    raises not_ported; the two modes K22 and K18's K > 1 mode lifted (a
    moment scale refit, several segmented models) now run with early
    reject on and retire candidates."""
    if mode == "noisy":
        abc = _bd_abc(distance=tpt.IndependentNormalKernel(var=[4.0] * 20),
                      eps=tpt.Temperature(
                          schemes=[ExpDecayFixedIterScheme()]),
                      acceptor=tpt.StochasticAcceptor())
        with pytest.raises(NotImplementedError, match="item 13"):
            abc.run(max_nr_populations=2)
        return
    if mode == "adaptive":
        abc = _bd_abc(distance=tpt.AdaptivePNormDistance(
            p=2, scale_function=standard_deviation), early_reject=True)
    else:
        abc = _bd_abc(models=[tg.make_birth_death_model(segments=5, **SMALL),
                              tg.make_birth_death_model(segments=5, **SMALL)],
                      priors=[tg.birth_death_prior(),
                              tg.birth_death_prior()], early_reject=True)
    h = abc.run(max_nr_populations=2)
    assert h.max_t == 1
    assert sum(h.get_telemetry(t)["retired_early"] for t in range(2)) > 0


def test_sharded_segmented_raises_not_ported():
    with pytest.raises(NotImplementedError, match="item 13"):
        tpt.ABCSMC(tg.make_birth_death_model(segments=5, **SMALL),
                   tg.birth_death_prior(), sharded=2, device="cpu")
    from pyabc_tpu_torch.models import model_selection as tmsel

    # the segmented ODE family builds now; sharding it is still to port
    models, priors, _ts = tmsel.ode_family(segments=4)
    with pytest.raises(NotImplementedError, match="item 13"):
        tpt.ABCSMC(models, priors, sharded=2, device="cpu")
