"""Aggregated distances (K25) and per-generation weight schedules: the
port's modules against the JAX package on the CPU.

The same numpy inputs go through the JAX package's ``AggregatedDistance``
/ ``AdaptiveAggregatedDistance`` device twins and the port's plain
versions of K25 (accept, values, refit) and of K18's aggregate bound; the
schedules' ``device_params(t)`` tables are compared entry for entry; and
each configuration the port refuses is shown beside the JAX package's own
verdict on it.
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
from pyabc_tpu.distance import scale as jscale  # noqa: E402
from pyabc_tpu.models import gillespie as jg  # noqa: E402
from pyabc_tpu.models import lotka_volterra as jlv  # noqa: E402
from pyabc_tpu.sumstat.base import IdentitySumstat  # noqa: E402
import pyabc_tpu_torch as tpt  # noqa: E402
from pyabc_tpu_torch import convert  # noqa: E402
from pyabc_tpu_torch.core.sumstat_spec import SumStatSpec  # noqa: E402
from pyabc_tpu_torch.distance import scale as tscale  # noqa: E402
from pyabc_tpu_torch.kernels import philox  # noqa: E402
from pyabc_tpu_torch.kernels.aggregate import (  # noqa: E402
    aggregate_accept_weight, aggregate_refit, aggregate_rows_plain)
from pyabc_tpu_torch.kernels.segment_round import (  # noqa: E402
    RESOLVED, RETIRED, segment_round)
from pyabc_tpu_torch.models import gillespie as tg  # noqa: E402
from pyabc_tpu_torch.models import lotka_volterra as tlv  # noqa: E402

torch.set_num_threads(1)

B, S = 96, 12
#: K25's distances against the JAX package's: sums of S terms (and the
#: sub-distances' weighted sum) in another float32 order
D_RTOL = 1e-5
#: the refit's scales and weights: sums over the ring in another order
#: (medians are order statistics, equal up to the values' rounding)
SCALE_RTOL = 1e-5
#: the prefix bound's accumulators: a few float32 additions per segment
BOUND_RTOL = 2e-6

#: (sub-distance p's, top-level weights, top-level factors)
CASES = {
    "two": ((2.0, math.inf), [0.7, 1.3], None),
    "three": ((1.0, 2.0, 3.0), [1.0, 0.5, 2.0], [2.0, 1.0, 0.25]),
    "four": ((1.0, 2.0, math.inf, 3.0), [0.3, 1.0, 1.7, 0.9],
             [1.0, 1.5, 0.5, 1.0]),
}


def _subs(pkg, ps, rng):
    """Sub-distances with random weights and factors (the same numbers for
    both packages)."""
    out = []
    for p in ps:
        w = rng.uniform(0.2, 2.0, S)
        f = rng.uniform(0.5, 1.5, S)
        out.append(pkg.PNormDistance(p=p, weights=w, factors=f))
    return out


def _pair(case, seed=0):
    """The same aggregated distance in both packages, initialized on one
    S-vector statistic -> (jax distance, port distance, jax spec)."""
    ps, W, F = CASES[case]
    dists = []
    for pkg in (jpt, tpt):
        rng = np.random.default_rng(seed)
        dists.append(pkg.AggregatedDistance(_subs(pkg, ps, rng), weights=W,
                                            factors=F))
    obs = {"s": np.zeros(S)}
    dists[0].initialize(0, x_0=obs)
    dists[1].initialize(SumStatSpec(obs))
    return dists[0], dists[1], jpt.SumStatSpec(obs)


def _round(seed):
    rng = np.random.default_rng(seed)
    ss = rng.normal(0, 2, size=(B, S)).astype(np.float32)
    ss[5] = np.nan  # a blown-up lane
    x0 = rng.normal(0, 1, size=S).astype(np.float32)
    valid = rng.random(B) > 0.1
    logpri = rng.normal(-3, 1, size=B).astype(np.float32)
    logpri[~valid] = -np.inf
    logq = rng.normal(-2, 1, size=B).astype(np.float32)
    return ss, x0, valid, logpri, logq


# --------------------------------------------------------- K25 accept
@pytest.mark.parametrize("case", sorted(CASES))
def test_device_fn_and_accept_match_jax(case):
    jd, td, spec = _pair(case)
    ss, x0, valid, logpri, logq = _round(len(CASES[case][0]))
    jparams = jd.device_params(None)
    params = td.device_params(None)
    # the flat params are the JAX package's, entry for entry
    assert torch.equal(params,
                       convert.aggregated_params(jd, None, device="cpu"))
    fn = jpt.UniformAcceptor().device_fn(jd.device_fn(spec))
    d_all = np.asarray(jax.vmap(lambda x: jd.device_fn(spec)(
        x, jnp.asarray(x0), jparams))(jnp.asarray(ss)))
    eps = float(np.nanmedian(d_all))

    def lane(x, v, lp, lq):
        d, a, log_acc_w = fn(None, x, jnp.asarray(x0), jnp.float32(eps),
                             jparams, ())
        log_w = 0.0 + lp + log_acc_w - 0.0 - lq
        return d, a & v, jnp.where(v, log_w, -jnp.inf)

    ref_d, ref_a, ref_lw = (np.asarray(o) for o in jax.vmap(lane)(
        jnp.asarray(ss), jnp.asarray(valid), jnp.asarray(logpri),
        jnp.asarray(logq)))
    t = torch.from_numpy
    d, a, lw = aggregate_accept_weight(
        t(ss), t(x0), params, torch.tensor(eps, dtype=torch.float32),
        t(valid), ps=td.ps, logpri=t(logpri), logq=t(logq))
    d, a, lw = d.numpy(), a.numpy(), lw.numpy()
    np.testing.assert_allclose(d, ref_d, rtol=D_RTOL, atol=0,
                               equal_nan=True)
    far = np.abs(ref_d - eps) > D_RTOL * eps
    np.testing.assert_array_equal(a[far], ref_a[far])
    np.testing.assert_array_equal(lw, ref_lw)
    # the values mode: each sub-distance against the JAX sub-distance's
    vals = aggregate_accept_weight.values(t(ss), t(x0), params,
                                          ps=td.ps).numpy()
    for k, sub in enumerate(jd.distances):
        ref = np.asarray(jax.vmap(lambda x, s=sub: s.device_fn(spec)(
            x, jnp.asarray(x0), s.device_params(None)))(jnp.asarray(ss)))
        np.testing.assert_allclose(vals[:, k], ref, rtol=D_RTOL,
                                   equal_nan=True)


def test_accept_with_model_terms_and_history():
    """K > 1's model terms and use_complete_history's minimum go through
    K5's epilogue unchanged."""
    jd, td, spec = _pair("three")
    ss, x0, valid, logpri, logq = _round(4)
    t = torch.from_numpy
    params = td.device_params(None)
    m = torch.from_numpy((np.arange(B) % 3).astype(np.int32))
    logits = torch.tensor([-1.0, -0.5, -2.0])
    factor = torch.tensor([-0.3, -0.1, -0.7])
    d_all = aggregate_rows_plain(t(ss), t(x0), params, td.ps)
    eps = torch.nanquantile(d_all, 0.6)
    hist = torch.nanquantile(d_all, 0.3)
    d, a, lw = aggregate_accept_weight(
        t(ss), t(x0), params, eps, t(valid), ps=td.ps, hist_min=hist,
        logpri=t(logpri), logq=t(logq), m=m, model_logits=logits,
        log_model_factor=factor)
    assert torch.equal(a, t(valid) & (d <= hist))
    want = (logits[m.long()] + t(logpri) - factor[m.long()]) - t(logq)
    assert torch.equal(lw, torch.where(t(valid), want,
                                       torch.full_like(want, -math.inf)))


# ---------------------------------------------------------- K25 refit
REFIT_SCALES = {"span": (None, None),
                "standard_deviation": (jscale.standard_deviation,
                                       tscale.standard_deviation),
                "median_absolute_deviation": (
                    jscale.median_absolute_deviation,
                    tscale.median_absolute_deviation)}


@pytest.mark.parametrize("name", sorted(REFIT_SCALES))
def test_record_reduce_and_weight_update_match_jax(name):
    """The scale of each sub-distance's values over the valid ring rows
    (invalid rows hold garbage), W = factors / scale, and the reservoir's
    distances under the new W, against the JAX twins."""
    jfn, tfn = REFIT_SCALES[name]
    rng = np.random.default_rng(7)
    ps = (2.0, 1.0, math.inf)
    jd = jpt.AdaptiveAggregatedDistance(_subs(jpt, ps, rng),
                                        scale_function=jfn)
    rng = np.random.default_rng(7)
    td = tpt.AdaptiveAggregatedDistance(_subs(tpt, ps, rng),
                                        scale_function=tfn)
    factors = np.array([1.0, 2.5, 0.5])
    jd.factors, td.factors = factors, factors
    obs = {"s": np.zeros(S)}
    jd.initialize(0, x_0=obs)
    td.initialize(SumStatSpec(obs))
    spec = jpt.SumStatSpec(obs)
    n = 200
    ring = rng.normal(0, 3, size=(n, S)).astype(np.float32)
    valid = rng.random(n) > 0.2
    ring[~valid] = 1e6  # garbage the scale must not see
    x0 = rng.normal(size=S).astype(np.float32)
    rows = rng.normal(0, 2, size=(64, S)).astype(np.float32)
    scale_ref = jd.device_record_reduce(spec)(
        jnp.asarray(ring), jnp.asarray(valid), jnp.asarray(x0))
    W_ref, subs_ref = jd.device_weight_update()(scale_ref)
    d_ref = jax.vmap(lambda r: jd.device_fn(spec)(
        r, jnp.asarray(x0), (W_ref, subs_ref)))(jnp.asarray(rows))
    t = torch.from_numpy
    params = td.device_params(0)
    scale, new, d = aggregate_refit(
        t(ring), t(valid), t(x0), params, ps=td.ps,
        factors=tuple(td.factors), scale_name=td.device_scale_impl(),
        rows=t(rows))
    np.testing.assert_allclose(scale.numpy(), np.asarray(scale_ref),
                               rtol=SCALE_RTOL)
    np.testing.assert_allclose(new[:3].numpy(), np.asarray(W_ref),
                               rtol=SCALE_RTOL)
    # the sub weights ride along unchanged
    assert torch.equal(new[3:], params[3:])
    np.testing.assert_allclose(new[3:].numpy(), np.concatenate(
        [np.asarray(s) for s in subs_ref]), rtol=0)
    np.testing.assert_allclose(d.numpy(), np.asarray(d_ref), rtol=D_RTOL)
    # the host mirror drops the factors, as the JAX package's
    np.testing.assert_allclose(td.host_weights(new.numpy()),
                               np.asarray(W_ref) / factors, rtol=1e-6)


def test_refit_zero_scale_gives_zero_weight():
    """A constant sub-distance column (scale 0) and an all-invalid ring
    give W = 0 (no clip, no normalization), as device_weight_update."""
    td = tpt.AdaptiveAggregatedDistance([tpt.PNormDistance(p=2),
                                         tpt.PNormDistance(p=1)])
    td.initialize(SumStatSpec({"s": np.zeros(S)}))
    ring = torch.ones(32, S)
    x0 = torch.zeros(S)
    scale, new, _d = aggregate_refit(
        ring, torch.ones(32, dtype=torch.bool), x0, td.device_params(0),
        ps=td.ps, factors=(1.0, 1.0), scale_name="span")
    assert scale.tolist() == [0.0, 0.0] and new[:2].tolist() == [0.0, 0.0]
    scale, new, _d = aggregate_refit(
        ring, torch.zeros(32, dtype=torch.bool), x0, td.device_params(0),
        ps=td.ps, factors=(1.0, 1.0), scale_name="standard_deviation")
    assert new[:2].tolist() == [0.0, 0.0]


# ------------------------------------------------------- K18's bound
def test_bound_matches_jax_and_is_sound():
    """test_segment.py:114's pair and inputs, over B lanes: the port's
    per-sub prefix accumulators equal the JAX bound's within float32
    rounding, exceeds decides alike, never at or above the full distance,
    and always below 0.9 of it after the whole prefix."""
    S16, lanes = 16, 32
    rng = np.random.default_rng(1)
    jd = jpt.AggregatedDistance(
        [jpt.PNormDistance(p=2), jpt.PNormDistance(p=np.inf)],
        weights=[0.7, 1.3])
    td = tpt.AggregatedDistance(
        [tpt.PNormDistance(p=2), tpt.PNormDistance(p=np.inf)],
        weights=[0.7, 1.3])
    obs = {"y": np.zeros(S16)}
    jd.initialize(0, x_0=obs)
    td.initialize(SumStatSpec(obs))
    jb, tb = jd.device_bound_fn(None), td.device_bound_fn(None)
    jparams, params = jd.device_params(None), td.device_params(None)
    x = rng.normal(size=(lanes, S16)).astype(np.float32)
    x0 = rng.normal(size=S16).astype(np.float32)
    full = np.asarray(jax.vmap(lambda r: jd.device_fn(None)(
        r, jnp.asarray(x0), jparams))(jnp.asarray(x)))
    jacc = jnp.broadcast_to(jb["init"](), (lanes, 2))
    tacc = tb["init"](lanes)
    for lo in range(0, S16, 4):
        idx = np.arange(lo, lo + 4)
        jacc = jax.vmap(lambda a, v: jb["step"](
            a, v, jnp.asarray(idx), jnp.asarray(x0), jparams))(
            jacc, jnp.asarray(x[:, idx]))
        tacc = tb["step"](tacc, torch.from_numpy(x[:, idx]), idx,
                          torch.from_numpy(x0), params)
        np.testing.assert_allclose(tacc.numpy(), np.asarray(jacc),
                                   rtol=BOUND_RTOL)
        for scale in (1.0, 1.5):
            thr = full * scale
            tex = tb["exceeds"](tacc, torch.from_numpy(thr), params)
            jex = jax.vmap(lambda a, th: jb["exceeds"](a, th, jparams))(
                jacc, jnp.asarray(thr))
            assert np.array_equal(tex.numpy(), np.asarray(jex))
            assert not tex.any()  # sound at and above the distance
    low = torch.from_numpy(full * 0.9)
    assert tb["exceeds"](tacc, low, params).all()
    # the JAX test's own lane
    rng = np.random.default_rng(1)
    x1 = rng.normal(size=S16).astype(np.float32)
    x01 = rng.normal(size=S16).astype(np.float32)
    f1 = float(jd.device_fn(None)(jnp.asarray(x1), jnp.asarray(x01),
                                  jparams))
    acc = tb["init"](1)
    for lo in range(0, S16, 4):
        idx = np.arange(lo, lo + 4)
        acc = tb["step"](acc, torch.from_numpy(x1[None, idx]), idx,
                         torch.from_numpy(x01), params)
        assert not bool(tb["exceeds"](acc, torch.tensor([f1]), params))
    assert bool(tb["exceeds"](acc, torch.tensor([f1 * 0.9]), params))


def test_segment_round_aggregate_retires_only_rejected_slots():
    """K18's plain aggregate mode on the birth-death round: every retired
    slot's full aggregated distance exceeds eps, every kept slot's
    statistics are the classic simulator's."""
    small = dict(n_leaps=100, n_obs=20)
    model = tg.make_birth_death_model(segments=5, **small)
    spec = SumStatSpec({"x": np.zeros(20)})
    td = tpt.AggregatedDistance([tpt.PNormDistance(p=2),
                                 tpt.PNormDistance(p=np.inf)],
                                weights=[0.7, 1.3])
    td.initialize(spec)
    params = td.device_params(0)
    n = 256
    gen = torch.Generator()
    gen.manual_seed(5)
    theta = tg.birth_death_prior().rvs_array(n, gen, torch.device("cpu"))
    valid = torch.rand(n, generator=gen) > 0.1
    st = philox.PhiloxStream(2, 4, philox.SIM_NOISE, 8,
                             torch.zeros(4, dtype=torch.int32))
    x0 = torch.tensor(np.asarray(jg.observed_birth_death(
        segments=5, **small)["x"], np.float32))
    full = model.simulate_flat(theta, gen, spec, stream=st)
    d = aggregate_rows_plain(full, x0, params, td.ps)
    eps = torch.quantile(d, 0.3)
    seg_ctr = torch.zeros(4, dtype=torch.int64)
    ss, keep = segment_round(model.segmented, theta, valid, st,
                             imap=model.index_map(spec, "cpu"), x0=x0,
                             w=params, p=2.0, eps=eps, width=20,
                             seg_ctr=seg_ctr, agg=td.ps)
    retired = ~keep & valid
    assert retired.any() and not (d[retired] <= eps).any()
    assert torch.equal(ss[keep], full[keep])
    assert seg_ctr[RETIRED] == int((~keep).sum()) and seg_ctr[RESOLVED] == n


# ----------------------------------------------------------- schedules
SCHED = {0: {"a": 1.0, "b": 1.0}, 2: {"a": 3.0, "b": 0.25},
         4: {"a": 0.5, "b": 2.0}}


@pytest.mark.parametrize("t", range(7))
def test_schedules_device_params_match_jax(t):
    """PNormDistance(weights={t: ...}, factors=...) and the aggregated
    table (a top-level and a sub-distance schedule) give the JAX package's
    device_params(t) at every generation."""
    obs = {"a": 1.0, "b": 2.0}
    jp = jpt.PNormDistance(p=2, weights=SCHED, factors=[1.0, 0.5])
    tp = tpt.PNormDistance(p=2, weights=SCHED, factors=[1.0, 0.5])
    jp.initialize(0, x_0=obs)
    tp.initialize(SumStatSpec(obs))
    np.testing.assert_array_equal(
        tp.device_params(t).numpy(),
        np.asarray(jp.device_params(t), np.float32))

    def agg(pkg):
        return pkg.AggregatedDistance(
            [pkg.PNormDistance(p=2, weights={0: {"a": 1.0, "b": 0.0},
                                             3: {"a": 2.0, "b": 0.0}}),
             pkg.PNormDistance(p=1)],
            weights={0: [1.0, 1.0], 2: [4.0, 0.1]}, factors=[1.0, 2.0])

    ja, ta = agg(jpt), agg(tpt)
    ja.initialize(0, x_0=obs)
    ta.initialize(SumStatSpec(obs))
    assert torch.equal(ta.device_params(t),
                       convert.aggregated_params(ja, t, device="cpu"))
    assert ta.schedule() and tp.schedule()


def test_schedule_gate_matches_jax():
    """_weight_schedule_fused: a schedule at either level, not a fixed
    vector; the JAX package's verdict on the same distances."""
    obs = {"a": 1.0, "b": 2.0}
    for pkg_args in ((dict(weights=SCHED), True),
                     (dict(weights={"a": 2.0}), False)):
        kw, want = pkg_args
        dists = [pkg.PNormDistance(p=2, **kw) for pkg in (jpt, tpt)]
        dists[0].initialize(0, x_0=obs)
        dists[1].initialize(SumStatSpec(obs))
        assert any(k >= 0 for k in dists[0].weights) is want
        assert dists[1].schedule() is want


# ------------------------------------------------------------ refusals
def _jax_lv_abc(dist, **kw):
    abc = jpt.ABCSMC(jlv.make_lv_model(), jlv.default_prior(), dist,
                     population_size=64, eps=jpt.MedianEpsilon(), **kw)
    abc.new("sqlite://", jlv.observed_data(seed=0))
    # the schedules resolve at initialize, as they do when a run starts
    dist.initialize(0, x_0=abc.x_0)
    return abc


def _custom_scale(values, x_0=None):
    return float(np.std(values))


#: what the port refuses at construction, each beside the JAX package's
#: verdict (its fused capability gate, ``smc.py:1716-1737``)
REFUSED = {
    "custom scale": (
        lambda pkg: pkg.AdaptiveAggregatedDistance(
            [pkg.PNormDistance(p=2), pkg.PNormDistance(p=1)],
            scale_function=_custom_scale), "16"),
    "two-argument scale": (
        lambda pkg: pkg.AdaptiveAggregatedDistance(
            [pkg.PNormDistance(p=2), pkg.PNormDistance(p=1)],
            scale_function=(jscale if pkg is jpt else tscale).bias), "16"),
    "log_file": (
        lambda pkg: pkg.AdaptiveAggregatedDistance(
            [pkg.PNormDistance(p=2), pkg.PNormDistance(p=1)],
            log_file="scales.json"), "17"),
    "adaptive sub-distance": (
        lambda pkg: pkg.AggregatedDistance(
            [pkg.AdaptivePNormDistance(p=2), pkg.PNormDistance(p=1)]), "12"),
    "sub-schedule under an adaptive aggregate": (
        lambda pkg: pkg.AdaptiveAggregatedDistance(
            [pkg.PNormDistance(p=2, weights={0: [1.0] * 40,
                                             2: [2.0] * 40}),
             pkg.PNormDistance(p=1)]), "16"),
}


@pytest.mark.parametrize("what", sorted(REFUSED))
def test_refusals_match_jax_verdict(what):
    make, item = REFUSED[what]
    assert not _jax_lv_abc(make(jpt))._fused_chunk_capable()
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        make(tpt)


def test_learned_statistic_sub_distance_refused():
    jd = jpt.AggregatedDistance([jpt.PNormDistance(
        p=2, sumstat=IdentitySumstat()), jpt.PNormDistance(p=1)])
    assert not _jax_lv_abc(jd)._fused_chunk_capable()
    with pytest.raises(NotImplementedError, match="item 14"):
        tpt.AggregatedDistance([tpt.PNormDistance(p=2, sumstat=object()),
                                tpt.PNormDistance(p=1)])


def test_more_than_eight_sub_distances_refused():
    """The JAX package fuses nine sub-distances; K25 holds at most eight
    in registers, so the port refuses them at construction."""
    jd = jpt.AggregatedDistance([jpt.PNormDistance(p=2)] * 9)
    assert _jax_lv_abc(jd)._fused_chunk_capable()
    with pytest.raises(NotImplementedError, match="item 12"):
        tpt.AggregatedDistance([tpt.PNormDistance(p=2) for _ in range(9)])


def test_measure_list_distances_refused():
    """The JAX package's DistanceWithMeasureList family runs on its host
    loop only; the port's ABCSMC refuses it before launch."""
    from pyabc_tpu.distance.aggregate import ZScoreDistance

    assert not _jax_lv_abc(ZScoreDistance())._fused_chunk_capable()
    with pytest.raises(NotImplementedError, match="item 16"):
        tpt.ABCSMC(tlv.make_lv_model(), tlv.default_prior(),
                   ZScoreDistance(), population_size=64, device="cpu")


def test_sharded_refused():
    """A fixed aggregate now shards; an adaptive one whose scale has no
    moment form is refused with the JAX package's ValueError."""
    d = tpt.AggregatedDistance([tpt.PNormDistance(p=2),
                                tpt.PNormDistance(p=1)])
    abc = tpt.ABCSMC(tlv.make_lv_model(), tlv.default_prior(), d,
                     population_size=64, sharded=4, device="cpu")
    assert abc.sharded_n == 4
    ad = tpt.AdaptiveAggregatedDistance(
        [tpt.PNormDistance(p=2), tpt.PNormDistance(p=1)],
        scale_function=tscale.median_absolute_deviation)
    with pytest.raises(ValueError, match="moment-decomposable"):
        tpt.ABCSMC(tlv.make_lv_model(), tlv.default_prior(), ad,
                   population_size=64, sharded=4, device="cpu")


SMALL = dict(n_leaps=100, n_obs=20)


def _bd_pair(make_dist, early):
    obs = {k: np.asarray(v) for k, v in jg.observed_birth_death(
        segments=5, **SMALL).items()}
    jabc = jpt.ABCSMC(jg.make_birth_death_model(segments=5, **SMALL),
                      jg.birth_death_prior(), make_dist(jpt),
                      population_size=32, eps=jpt.MedianEpsilon(),
                      early_reject=early)
    jabc.new("sqlite://", obs)
    tabc = tpt.ABCSMC(tg.make_birth_death_model(segments=5, **SMALL),
                      tg.birth_death_prior(), make_dist(tpt),
                      population_size=32, eps=tpt.MedianEpsilon(),
                      early_reject=early, device="cpu")
    tabc.new("sqlite://", obs)
    return jabc, tabc


#: early-reject gates an aggregate meets, in the JAX package's words
ER_GATES = {
    "adaptive aggregate (span)": (lambda pkg: pkg.AdaptiveAggregatedDistance(
        [pkg.PNormDistance(p=2), pkg.PNormDistance(p=1)]), True),
    "adaptive aggregate (median_absolute_deviation)": (
        lambda pkg: pkg.AdaptiveAggregatedDistance(
            [pkg.PNormDistance(p=2), pkg.PNormDistance(p=1)],
            scale_function=(jscale if pkg is jpt
                            else tscale).median_absolute_deviation), True),
    "negative top-level weight": (lambda pkg: pkg.AggregatedDistance(
        [pkg.PNormDistance(p=2), pkg.PNormDistance(p=1)],
        weights=[1.0, -0.5]), False),
    "negative factor": (lambda pkg: pkg.AggregatedDistance(
        [pkg.PNormDistance(p=2), pkg.PNormDistance(p=1)],
        factors=[1.0, -1.0]), False),
    "negative sub-weight": (lambda pkg: pkg.AggregatedDistance(
        [pkg.PNormDistance(p=2, weights=[-1.0] + [1.0] * 19),
         pkg.PNormDistance(p=1)]), False),
}


@pytest.mark.parametrize("what", sorted(ER_GATES))
def test_early_reject_gates_are_the_jax_package_s(what):
    """The reason text is the JAX package's, word for word; under True the
    run raises its ValueError before any generation."""
    make, adaptive = ER_GATES[what]
    jabc, tabc = _bd_pair(make, True)
    jabc.distance_function.initialize(0, x_0=jabc.x_0)
    tabc.distance_function.initialize(tabc.spec)
    want = jabc._early_reject_incapable_reason(
        adaptive=adaptive, stochastic=False, sumstat_mode=False,
        sharded_n=None)
    assert want is not None
    assert tabc._early_reject_incapable_reason(
        adaptive=adaptive, stochastic=False) == want
    with pytest.raises(ValueError) as err:
        tabc.run(max_nr_populations=2)
    assert str(err.value) == f"early_reject=True unavailable: {want}"
    assert tabc.history.max_t < 0


def test_fixed_aggregate_is_served_by_both_early_reject_engines():
    jabc, tabc = _bd_pair(lambda pkg: pkg.AggregatedDistance(
        [pkg.PNormDistance(p=2), pkg.PNormDistance(p=np.inf)],
        weights=[0.7, 1.3]), "auto")
    jabc.distance_function.initialize(0, x_0=jabc.x_0)
    tabc.distance_function.initialize(tabc.spec)
    assert jabc._early_reject_incapable_reason(
        adaptive=False, stochastic=False, sumstat_mode=False,
        sharded_n=None) is None
    assert tabc._early_reject_incapable_reason(
        adaptive=False, stochastic=False) is None
