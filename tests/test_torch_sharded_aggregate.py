"""Sharded sampling under aggregated distances and user weight schedules
(``ABCSMC(..., sharded=8)`` without a mesh): the port against the JAX
package's virtual-shard functions and runs on the CPU.

Operation level, at 8 shards, B 512, S 6 and 2 and 4 sub-distances of
mixed p: K25's value rows against ``device_sharded_reduce``'s ``cols``
(and bit-equal to its values mode, the accept unchanged), K24d's fold on
them against ``accumulate_moments`` per shard (counts and extrema equal,
sums rel 1e-5), K25's sharded finish against ``combine_moments``,
``scale_from_moments``, ``device_weight_update`` and
``device_sharded_dfeat``'s ``combine`` for every moment scale (W and
distances rel 1e-5), and a whole sharded generation, K24a's given-rows
mode included, against the JAX package's per-shard ``_generation_while``.

Whole runs: ``tests/test_sharded.py:498-520``'s configuration (gauss2,
``AdaptiveAggregatedDistance([p 2, p 1])``, pop 128, G 3, 4 generations,
8 shards) in both packages and unsharded; a fixed aggregate under
``tests/test_fused.py:324-345``'s schedule; ``PNormDistance(p=2,
weights={0: [1, 2], 2: [2, 1]})`` (``test_sharded.py:738-740``); the
tractable pair under the adaptive aggregate. The two packages draw other
random numbers, so whole runs agree in law: each refit is held to the JAX
package's functions on the run's own moment blocks within 1e-3, the
weights and trails to the JAX package's runs at the JAX suite's
statistical rules.
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
from pyabc_tpu.inference.util import DeviceContext as JaxContext  # noqa: E402
from pyabc_tpu.models import model_selection as jmsel  # noqa: E402
from pyabc_tpu.ops import scale_reduce as jsr  # noqa: E402
from pyabc_tpu.ops import shard as jshard  # noqa: E402
import pyabc_tpu_torch as tpt  # noqa: E402
from pyabc_tpu_torch.core.sumstat_spec import SumStatSpec  # noqa: E402
from pyabc_tpu_torch.distance import aggregate as tagg  # noqa: E402
from pyabc_tpu_torch.distance import scale as tscale  # noqa: E402
from pyabc_tpu_torch.inference.context import DeviceContext  # noqa: E402
from pyabc_tpu_torch.kernels import (aggregate_accept_weight,  # noqa: E402
                                     aggregate_finish, moment_fold)
from pyabc_tpu_torch.kernels.aggregate import (  # noqa: E402
    aggregate_finish_shards_plain, sub_distances_plain)
from pyabc_tpu_torch.models import model_selection as tmsel  # noqa: E402
from pyabc_tpu_torch.ops.scale_reduce import (  # noqa: E402
    SHARDED_SCALE_NAMES, init_moments)

torch.set_num_threads(1)

N_SH, B, S = 8, 512, 6
B_LOC = B // N_SH
#: the sub-distances' p's: two, and four of mixed p
SUBS = {"2 subs": (2.0, 1.0), "4 subs": (1.0, 2.0, math.inf, 3.0)}
OBS = {"s": np.zeros(S)}


def _dists(ps, factors=None, seed=0):
    """The same aggregate in both packages: random sub weights, optional
    top-level factors -> (JAX distance, its spec, port distance, params)."""
    rng = np.random.default_rng(seed)
    ws = [rng.uniform(0.2, 1.5, S) for _ in ps]
    jd = jpt.AdaptiveAggregatedDistance(
        [jpt.PNormDistance(p=p, weights=w) for p, w in zip(ps, ws)])
    td = tpt.AdaptiveAggregatedDistance(
        [tpt.PNormDistance(p=p, weights=w) for p, w in zip(ps, ws)])
    if factors is not None:
        jd.factors = np.asarray(factors, np.float64)
        td.factors = np.asarray(factors, np.float64)
    jspec = jpt.SumStatSpec(OBS)
    jd.initialize(0, None, OBS)
    td.initialize(SumStatSpec(OBS))
    return jd, jspec, td, td.device_params(0)


def _rows(rng, n):
    return (rng.normal(1.0, 2.0, size=(n, S)).astype(np.float32),
            rng.normal(size=S).astype(np.float32))


# ------------------------------------------------ K25's value rows
@pytest.mark.parametrize("subs", sorted(SUBS))
def test_value_rows_equal_the_jax_cols(subs):
    """K25's value-rows mode: the sub-distances within rel 1e-5 of
    ``device_sharded_reduce``'s ``cols`` and ``device_sharded_dfeat``'s
    ``row``, bit-equal to its values mode, and the accept's distance,
    flags and log weights those of the plain accept (the JAX
    ``device_fn``'s distance within rel 1e-5)."""
    rng = np.random.default_rng(1)
    jd, jspec, td, params = _dists(SUBS[subs])
    ss, x0 = _rows(rng, B)
    ss_t, x0_t = torch.from_numpy(ss), torch.from_numpy(x0)
    valid = torch.from_numpy(rng.random(B) < 0.9)
    eps = torch.tensor(float(np.median(
        sub_distances_plain(ss_t, x0_t, params, td.ps).sum(1))))
    d, acc, lw, vals = aggregate_accept_weight.value_rows(
        ss_t, x0_t, params, eps, valid, ps=td.ps)
    cols = jd.device_sharded_reduce(jspec)["cols"](jnp.asarray(ss),
                                                   jnp.asarray(x0))
    row = jd.device_sharded_dfeat(jspec)["row"]
    rows = jax.vmap(lambda r: row(r, jnp.asarray(x0)))(jnp.asarray(ss))
    np.testing.assert_allclose(vals.numpy(), np.asarray(cols), rtol=1e-5)
    np.testing.assert_allclose(vals.numpy(), np.asarray(rows), rtol=1e-5)
    assert torch.equal(vals, aggregate_accept_weight.values(
        ss_t, x0_t, params, ps=td.ps))
    d0, acc0, lw0 = aggregate_accept_weight(ss_t, x0_t, params, eps, valid,
                                            ps=td.ps)
    assert torch.equal(d, d0) and torch.equal(acc, acc0)
    assert torch.equal(lw, lw0)
    fn = jd.device_fn(jspec)
    jparams = jd.device_params(0)
    jdist = jax.vmap(lambda r: fn(r, jnp.asarray(x0), jparams))(
        jnp.asarray(ss))
    np.testing.assert_allclose(d.numpy(), np.asarray(jdist), rtol=1e-5)


# ------------------------------------------- K24d's fold on the values
@pytest.mark.parametrize("subs", sorted(SUBS))
def test_fold_on_value_columns_equals_accumulate_moments(subs):
    """K24d's fold with F = n_sub and a zero observation, per shard
    against ``accumulate_moments`` over the running shard's ring-eligible
    lanes (``util.py:620-625``): counts and extrema equal, sums within rel
    1e-5; a finished shard (quota met, or its rounds spent) untouched."""
    rng = np.random.default_rng(2)
    _jd, _js, td, params = _dists(SUBS[subs])
    ss, x0 = _rows(rng, B)
    vals = sub_distances_plain(torch.from_numpy(ss), torch.from_numpy(x0),
                               params, td.ps)
    n = vals.shape[1]
    valid = torch.from_numpy(rng.random(B) < 0.85)
    n_target, rec_cap, max_rounds = 300, 150, 6
    counters = torch.tensor([0, 0, 0, 0, n_target], dtype=torch.int32)
    # shard 0 met its quota, shard 1 spent its rounds, the window cuts
    # shards 2 (round 2: slots 128-191 against 150) and 3 (round 3: none)
    table = torch.tensor([[38, 1, 0, 0], [5, 6, 0, 0], [10, 2, 0, 0],
                          [3, 3, 0, 0], [0, 0, 0, 0], [12, 1, 0, 0],
                          [20, 1, 0, 0], [0, 0, 0, 0]], dtype=torch.int32)
    mom0 = init_moments(n).expand(N_SH, -1, -1).contiguous()
    got = moment_fold.shards(mom0.clone(), vals, valid, torch.zeros(n),
                             counters, table, n_shards=N_SH,
                             rec_cap=rec_cap, max_rounds=max_rounds)
    quota = jshard.shard_quota_host(n_target, N_SH)
    for s in range(N_SH):
        lanes = slice(s * B_LOC, (s + 1) * B_LOC)
        ref = jsr.init_moments(n)
        if int(table[s, 0]) < quota[s] and int(table[s, 1]) < max_rounds:
            slot = int(table[s, 1]) * B_LOC + np.arange(B_LOC)
            take = valid[lanes].numpy() & (slot < rec_cap)
            ref = jsr.accumulate_moments(
                ref, jnp.asarray(vals[lanes].numpy()), jnp.asarray(take),
                jnp.zeros(n, jnp.float32))
        ref = np.asarray(ref)
        np.testing.assert_array_equal(got[s, 3:].numpy(), ref[3:],
                                      err_msg=f"shard {s}")
        np.testing.assert_allclose(got[s, :3].numpy(), ref[:3], rtol=1e-5,
                                   err_msg=f"shard {s}")
    assert torch.equal(got[0], mom0[0]) and torch.equal(got[1], mom0[1])
    assert torch.equal(got[3], mom0[3])


# ------------------------------------------- K25's sharded finish
@pytest.mark.parametrize("name", sorted(SHARDED_SCALE_NAMES))
@pytest.mark.parametrize("subs", sorted(SUBS))
def test_sharded_finish_equals_the_jax_functions(subs, name):
    """K25's sharded finish against the JAX package's ``combine_moments``,
    ``scale_from_moments(name)`` at the zero observation,
    ``device_weight_update`` (factors 1, 0.5, ...) and
    ``device_sharded_dfeat``'s ``combine`` on the same blocks and value
    rows: the scale, W and the distances within rel 1e-5, the sub weights
    copied bit for bit."""
    rng = np.random.default_rng(3)
    ps = SUBS[subs]
    n = len(ps)
    factors = [1.0 / (1 + k) for k in range(n)]
    jd, jspec, td, params = _dists(ps, factors=factors)
    zeros = jnp.zeros(n, jnp.float32)
    parts = np.stack([np.asarray(jsr.accumulate_moments(
        jsr.init_moments(n),
        jnp.asarray(np.abs(rng.normal(3.0, 2.0, (40, n))).astype(
            np.float32)),
        jnp.asarray(rng.random(40) < 0.8), zeros)) for _ in range(N_SH)])
    feat = np.abs(rng.normal(3.0, 2.0, (200, n))).astype(np.float32)
    mom = jsr.combine_moments(jnp.asarray(parts))
    scale = jsr.scale_from_moments(name)(mom, zeros)
    post = jd.device_weight_update()(scale)
    comb = jd.device_sharded_dfeat(jspec)["combine"]
    d = jax.vmap(lambda f: comb(f, post))(jnp.asarray(feat))
    t_scale, new, t_d = aggregate_finish.shards(
        torch.from_numpy(parts), torch.from_numpy(feat), params,
        factors=tuple(td.factors), scale_name=name)
    np.testing.assert_allclose(t_scale.numpy(), np.asarray(scale),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(new[:n].numpy(), np.asarray(post[0]),
                               rtol=1e-5)
    assert torch.equal(new[n:], params[n:])
    np.testing.assert_allclose(t_d.numpy(), np.asarray(d), rtol=1e-5)


def test_sharded_finish_sums_as_the_accept():
    """Each recomputed distance equals K25's accept distance of that row
    under the new W, bit for bit (the same rounded sum in the order k =
    0..n-1); a scale <= 0 gives W 0."""
    rng = np.random.default_rng(4)
    _jd, _js, td, params = _dists(SUBS["4 subs"])
    ss, x0 = _rows(rng, 300)
    ss_t, x0_t = torch.from_numpy(ss), torch.from_numpy(x0)
    vals = sub_distances_plain(ss_t, x0_t, params, td.ps)
    mom = init_moments(4)
    mom[4] = torch.tensor([5.0, 2.0, 1.0, 3.0])
    mom[5] = torch.tensor([1.0, 2.0, 0.5, 1.0])   # span of column 1: 0
    scale, new, d = aggregate_finish_shards_plain(
        mom[None].expand(N_SH, -1, -1).contiguous(), vals, params,
        factors=(1.0, 1.0, 1.0, 1.0), scale_name="span")
    assert float(new[1]) == 0.0 and float(scale[1]) == 0.0
    d_acc, _a, _w = aggregate_accept_weight(
        ss_t, x0_t, new, torch.tensor(math.inf), torch.ones(300, dtype=bool),
        ps=td.ps)
    assert torch.equal(d, d_acc)


# --------------------------------- a whole sharded generation (K24a)
def _jax_ctx(jd):
    spec = jpt.SumStatSpec(OBS)
    model = jpt.JaxModel(lambda key, th: {"s": jnp.zeros(S)}, ["a", "b"])
    prior = jpt.Distribution(a=jpt.RV("norm", 0, 1), b=jpt.RV("norm", 0, 1))
    return JaxContext(models=[model], parameter_priors=[prior],
                      model_prior_logits=np.zeros(1), distance=jd,
                      acceptor=jpt.UniformAcceptor(), spec=spec,
                      x_0_flat=np.zeros(S, np.float32),
                      transition_cls=jpt.MultivariateNormalTransition)


def _run_lanes(key, dyn):
    k = jax.random.split(key, 6)
    return {
        "m": jnp.zeros((B,), jnp.int32),
        "theta": jax.random.normal(k[0], (B, 2)),
        "sumstats": jax.random.normal(k[1], (B, S)),
        "distance": jax.random.uniform(k[2], (B,)),
        "accepted": jax.random.uniform(k[3], (B,)) < 0.3,
        "valid": jax.random.uniform(k[4], (B,)) < 0.85,
        "log_weight": jax.random.normal(k[5], (B,)),
    }


@pytest.mark.parametrize("subs", sorted(SUBS))
@pytest.mark.parametrize("n_target,cap_loc,rec_loc,max_rounds", [
    (300, 64, 100, 10),  # uneven quotas (38, 38, 38, 38, 37, ...)
    (120, 16, 256, 2),   # quota 15 of 16 rows; the round budget ends
])
def test_generation_equals_the_jax_per_shard_loop(subs, n_target, cap_loc,
                                                  rec_loc, max_rounds):
    """One sharded generation under the adaptive aggregate (K24a's
    given-rows mode, K24d's fold on the value columns) against the JAX
    package's ``_generation_while`` run once per shard with the
    aggregate's ``moment_cfg`` (its ``cols``, a zero centre) and
    ``dfeat_cfg`` (its ``row``) on the same rounds: each shard's
    reservoir block and counters equal, its feature rows within rel 1e-5
    of the JAX rows and bit-equal to the value rows of its accepted lanes,
    its moments' counts equal and sums and extrema within rel 1e-5."""
    ps = SUBS[subs]
    n = len(ps)
    jd, jspec, td, params = _dists(ps)
    key = jax.random.key(19)
    x0 = np.random.default_rng(5).normal(size=S).astype(np.float32)
    red = jd.device_sharded_reduce(jspec)
    row = jd.device_sharded_dfeat(jspec)["row"]
    jctx = _jax_ctx(jd)
    quota = jshard.shard_quota_host(n_target, N_SH)
    ref = []
    for s in range(N_SH):
        def lanes_s(k, dyn, s=s):
            return {kk: v[s * B_LOC:(s + 1) * B_LOC]
                    for kk, v in _run_lanes(k, dyn).items()}

        ref.append(jctx._generation_while(
            key, None, jnp.int32(int(quota[s])), B=B_LOC, n_cap=cap_loc,
            rec_cap=rec_loc, max_rounds=max_rounds, run_lanes=lanes_s,
            moment_cfg=(n, red["cols"], jnp.asarray(x0), red["x0_cols"]),
            dfeat_cfg=(n, row, jnp.asarray(x0))))
    x0_t = torch.from_numpy(x0)
    rounds_vals = []

    def lanes(r=iter(range(100))):
        out = _run_lanes(jax.random.fold_in(key, next(r)), None)
        out = {k: torch.from_numpy(np.array(v)) for k, v in out.items()}
        out["vals"] = sub_distances_plain(out["sumstats"], x0_t, params,
                                          td.ps)
        rounds_vals.append(out["vals"])
        return out

    ctx = DeviceContext(
        model=None, prior=tpt.Distribution(a=tpt.RV("norm", 0, 1),
                                           b=tpt.RV("norm", 0, 1)),
        distance=td, acceptor=None, transition=None,
        spec=SumStatSpec(OBS), x0=x0_t, device=torch.device("cpu"),
        generator=None, B=B, n_cap=N_SH * cap_loc, rec_cap=rec_loc,
        max_rounds=max_rounds, n_shards=N_SH)
    run = ctx.generation_while_sharded(lanes, n_target, adaptive=True)
    assert not ctx.value_rows
    assert run.res["dfeat"].shape == (N_SH * cap_loc, n)
    assert run.mom.shape == (N_SH, 6, n)
    for s, (n_acc, _r, _v, res, _rec, mom) in enumerate(ref):
        blk = slice(s * cap_loc, (s + 1) * cap_loc)
        for k in ("theta", "sumstats", "distance", "log_weight", "slot"):
            np.testing.assert_array_equal(run.res[k][blk].numpy(),
                                          np.asarray(res[k]),
                                          err_msg=f"shard {s} {k}")
        np.testing.assert_allclose(run.res["dfeat"][blk].numpy(),
                                   np.asarray(res["dfeat"]), rtol=1e-5,
                                   err_msg=f"shard {s} dfeat")
        kept = min(int(n_acc), cap_loc)
        for i in range(kept):
            slot = int(run.res["slot"][blk][i])
            lane = s * B_LOC + slot % B_LOC
            assert torch.equal(run.res["dfeat"][blk][i],
                               rounds_vals[slot // B_LOC][lane])
        got, mom = run.mom[s].numpy(), np.asarray(mom)
        np.testing.assert_array_equal(got[3], mom[3], err_msg=f"shard {s}")
        np.testing.assert_allclose(got[[0, 1, 2, 4, 5]],
                                   mom[[0, 1, 2, 4, 5]], rtol=1e-5,
                                   err_msg=f"shard {s}")


# ------------------------------------------------------- whole runs
POP, G, GENS = 128, 3, 4
SEEDS = (141, 142)
X_OBS = 1.0
#: tests/test_sharded.py's rule for a sharded run against another:
#: posterior means within 0.2; the JAX suite's statistical rules for the
#: two packages' adaptive aggregates (test_torch_aggregate_runs.py): the
#: seeds' mean weights within 0.35 and mean epsilon trail within 0.25
#: relative (the span of 512 records moves by a third from seed to seed)
POST_RULE, W_RTOL, EPS_RTOL = 0.2, 0.35, 0.25


def _sim2(theta, g):
    z = torch.randn(theta.shape[0], generator=g, device=theta.device)
    return {"x": theta[:, 0] + 0.5 * z, "y": 10.0 * theta[:, 0] + z}


def _jax_gauss2():
    @jpt.JaxModel.from_function(["theta"], name="gauss2_adaptive")
    def model(key, theta):
        z = jax.random.normal(key)
        return {"x": theta[0] + 0.5 * z, "y": 10.0 * theta[0] + z}

    return model


def _make(pkg, dist, seed, sharded=8, pop=POP, model=None, prior=None,
          obs=None, **kw):
    if pkg == "jax":
        abc = jpt.ABCSMC(model or _jax_gauss2(),
                         prior or jpt.Distribution(
                             theta=jpt.RV("norm", 0.0, 1.0)),
                         dist, population_size=pop, eps=jpt.MedianEpsilon(),
                         seed=seed, sharded=sharded, fused_generations=G,
                         **kw)
    else:
        abc = tpt.ABCSMC(model or tpt.TorchModel(_sim2, ["theta"],
                                                 name="gauss2_adaptive"),
                         prior or tpt.Distribution(
                             theta=tpt.RV("norm", 0.0, 1.0)),
                         dist, population_size=pop, eps=tpt.MedianEpsilon(),
                         seed=seed, sharded=sharded, fused_generations=G,
                         device="cpu", **kw)
    abc.new("sqlite://", obs or {"x": X_OBS, "y": 10.0 * X_OBS})
    return abc


def _adaptive(pkg):
    mod = jpt if pkg == "jax" else tpt
    return mod.AdaptiveAggregatedDistance([mod.PNormDistance(p=2),
                                           mod.PNormDistance(p=1)])


class _Recorder:
    """Wraps K25's sharded finish and keeps each call's inputs and
    outputs."""

    def __init__(self, kernel):
        self.kernel, self.calls = kernel, []

    def shards(self, mom, feat, params, **kw):
        out = self.kernel.shards(mom, feat, params, **kw)
        self.calls.append((mom.clone(), kw["scale_name"], out))
        return out


@pytest.fixture(scope="module")
def runs():
    """{(pkg, seed, sharded): (abc, History, finish calls)} of the
    adaptive aggregate, 4 generations in chunks of 3."""
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        for seed in SEEDS:
            for pkg, sharded in (("port", 8), ("jax", 8), ("port", None)):
                rec = _Recorder(aggregate_finish)
                mp.setattr(tagg, "aggregate_finish", rec)
                abc = _make(pkg, _adaptive(pkg), seed, sharded=sharded)
                h = abc.run(max_nr_populations=GENS)
                out[pkg, seed, sharded] = (abc, h, rec.calls)
    finally:
        mp.undo()
    return out


def _weights(abc):
    return {t: np.asarray(w, float)
            for t, w in abc.distance_function.weights.items() if t >= 0}


def _mean(h):
    df, w = h.get_distribution(0, h.max_t)
    return float(np.sum(df["theta"] * w))


def _refits(h):
    return [bool(h.get_telemetry(t).get("refit"))
            for t in range(h.max_t + 1)]


@pytest.mark.parametrize("seed", SEEDS)
def test_refit_every_generation_on_the_shards(runs, seed):
    """The weights refit every generation from the shards' blocks (one
    K25 sharded finish a generation), the calibration's first, the keys
    those of the JAX package's run; every generation keeps its 128
    particles."""
    abc, h, calls = runs["port", seed, 8]
    w, wj = _weights(abc), _weights(runs["jax", seed, 8][0])
    assert sorted(w) == sorted(wj) == list(range(GENS + 1))
    assert len(calls) == GENS
    for t in range(1, GENS + 1):
        assert not np.array_equal(w[t], w[t - 1]), t
        assert np.all(w[t] > 0)
    assert list(h.get_nr_particles_per_population()[1:]) == [POP] * GENS


@pytest.mark.parametrize("seed", SEEDS)
def test_each_refit_holds_to_the_jax_functions(runs, seed):
    """Every generation's weights within 1e-3 (relative) of the JAX
    package's ``combine_moments``, ``scale_from_moments`` and
    ``device_weight_update`` applied to the run's own shard blocks, and
    the host mirror W without the factors."""
    abc, _h, calls = runs["port", seed, 8]
    jd = _adaptive("jax")
    jd.initialize(0, None, {"x": X_OBS, "y": 10.0 * X_OBS})
    w = _weights(abc)
    for t, (mom, name, (_scale, new, _d)) in enumerate(calls, start=1):
        assert name == "span"
        ref = jd.device_weight_update()(jsr.scale_from_moments(name)(
            jsr.combine_moments(jnp.asarray(mom.numpy())),
            jnp.zeros(2, jnp.float32)))[0]
        np.testing.assert_allclose(new[:2].numpy(), np.asarray(ref),
                                   rtol=1e-3, err_msg=str(t))
        np.testing.assert_allclose(w[t], np.asarray(ref), rtol=1e-3)


def test_weights_and_trail_follow_the_jax_package(runs):
    """The two seeds' mean weights every generation within 0.35 and mean
    epsilon trail from generation 1 within 0.25 (relative) of the JAX
    package's sharded runs."""
    def mean_w(pkg):
        return {t: np.mean([_weights(runs[pkg, s, 8][0])[t]
                            for s in SEEDS], 0) for t in range(GENS + 1)}

    def trail(pkg):
        return np.mean([runs[pkg, s, 8][1].get_all_populations().query(
            "t >= 1")["epsilon"].to_numpy() for s in SEEDS], 0)

    w, wj = mean_w("port"), mean_w("jax")
    for t in w:
        np.testing.assert_allclose(w[t], wj[t], rtol=W_RTOL, err_msg=str(t))
    np.testing.assert_allclose(trail("port"), trail("jax"), rtol=EPS_RTOL)


@pytest.mark.parametrize("seed", SEEDS)
def test_posterior_follows_the_jax_package_and_the_unsharded_run(runs,
                                                                 seed):
    """``test_sharded.py``'s rule: the sharded posterior mean within 0.2
    of the JAX package's sharded run and of the port's unsharded run, all
    near theta = 1 (x = 1 and y = 10 pin it)."""
    mu = _mean(runs["port", seed, 8][1])
    assert mu == pytest.approx(_mean(runs["jax", seed, 8][1]),
                               abs=POST_RULE)
    assert mu == pytest.approx(_mean(runs["port", seed, None][1]),
                               abs=POST_RULE)
    assert mu == pytest.approx(1.0, abs=POST_RULE)


def test_refit_flags_equal_the_jax_packages(runs):
    """The MVN refit at the chunk cadence: the flags of the JAX package's
    telemetry, generation 0 and 3."""
    for seed in SEEDS:
        flags = _refits(runs["port", seed, 8][1])
        assert flags == _refits(runs["jax", seed, 8][1])
        assert flags == [True, False, False, True]


def test_sync_budget(runs):
    """One counter read a round (the shards' table in it), one fetch a
    chunk, and the host calibration's round, collect and the one read of
    its K25 refit's W: no ring, nothing else."""
    abc = runs["port", SEEDS[0], 8][0]
    rounds = sum(g["rounds"] for g in abc.generation_log)
    report = abc.sync_ledger.budget_report(rounds=rounds, chunks=2, slack=3)
    assert report["ok"], report
    assert report["by_kind"] == {"round_counters": rounds + 1,
                                 "generation_collect": 1, "scale_fetch": 1,
                                 "chunk_fetch": 2}
    assert all(g["syncs"] == g["rounds"] for g in abc.generation_log)


def test_calibration_weights_come_from_k25s_refit():
    """Generation 0's W: K25's refit over the calibration sample (the
    span of each sub-distance over its rows, W = 1 / span), the same
    weights the port's unsharded in-kernel calibration finds on the same
    prior draws."""
    ws = {}
    for sharded in (8, None):
        abc = _make("port", _adaptive("port"), 141, sharded=sharded)
        abc.run(max_nr_populations=1)
        ws[sharded] = abc.distance_function.weights[0]
    np.testing.assert_allclose(ws[8], ws[None], rtol=1e-6)


# ------------------------------------- fixed aggregates and schedules
def _two_stat(pkg):
    if pkg == "jax":
        @jpt.JaxModel.from_function(["theta"], name="gauss2")
        def model(key, theta):
            k1, k2 = jax.random.split(key)
            return {"a": theta[0] + 0.5 * jax.random.normal(k1),
                    "b": 2.0 * theta[0] + 1.0 * jax.random.normal(k2)}

        return model

    def sim(theta, gen):
        z = torch.randn(2, theta.shape[0], generator=gen,
                        device=theta.device)
        return {"a": theta[:, 0] + 0.5 * z[0],
                "b": 2.0 * theta[:, 0] + 1.0 * z[1]}

    return tpt.TorchModel(sim, ["theta"], name="gauss2")


SCHEDULES = {
    "aggregated": (lambda mod: mod.AggregatedDistance(
        [mod.PNormDistance(p=2, weights={0: {"a": 1.0, "b": 0.0},
                                         3: {"a": 2.0, "b": 0.0}}),
         mod.PNormDistance(p=1)],
        weights={0: [1.0, 1.0], 2: [4.0, 0.1]}), {"a": 1.0, "b": 2.0}),
    "pnorm": (lambda mod: mod.PNormDistance(
        p=2, weights={0: [1.0, 2.0], 2: [2.0, 1.0]}), None),
}


@pytest.mark.parametrize("kind", sorted(SCHEDULES))
def test_schedule_rides_the_sharded_chunks(kind):
    """A user schedule on 8 shards: the stored distances recompute under
    each generation's weights of the JAX package's distance (the chunk's
    table row a generation), the trail within 0.2 (relative) and the
    posterior within 0.2 of the JAX package's sharded run, one read a
    round and one fetch a chunk (the calibration's round and collect)."""
    make, obs = SCHEDULES[kind]
    hs = {}
    for pkg in ("port", "jax"):
        mod = jpt if pkg == "jax" else tpt
        kw = dict(fetch_dtype="float32") if pkg == "port" else {}
        model = _two_stat(pkg) if obs is not None else None
        abc = _make(pkg, make(mod), 17, pop=300, model=model, obs=obs, **kw)
        hs[pkg] = abc.run(max_nr_populations=6)
        if pkg == "port":
            assert abc.sharded_n == 8 and abc._weight_schedule_fused()
            port = abc
    h, jh = hs["port"], hs["jax"]
    assert h.n_populations == jh.n_populations == 6
    obs = obs or {"x": X_OBS, "y": 10.0 * X_OBS}
    ref = make(jpt)
    ref.initialize(0, x_0=obs)
    names = list(obs)
    for t in range(h.max_t + 1):
        wd = np.sort(h.get_weighted_distances(t)["distance"].to_numpy())
        _w, stats = h.get_weighted_sum_stats(t)
        again = np.sort([ref({k: float(v) for k, v in zip(names, s)}, obs,
                             t) for s in stats])
        np.testing.assert_allclose(wd, again, rtol=2e-3, atol=1e-5)
    eps = [x.get_all_populations().query("t >= 1")["epsilon"].to_numpy()
           for x in (h, jh)]
    np.testing.assert_allclose(eps[0], eps[1], rtol=0.2)
    assert _mean(h) == pytest.approx(_mean(jh), abs=POST_RULE)
    rounds = sum(g["rounds"] for g in port.generation_log)
    by_kind = port.sync_ledger.summary()["by_kind"]
    assert by_kind == {"round_counters": rounds + 1,
                       "generation_collect": 1, "chunk_fetch": 2}


def test_tractable_pair_under_the_adaptive_aggregate():
    """K = 2 under an adaptive aggregate on 8 shards (the unsharded port
    serves it with K > 1): the model column and the value rows ride the
    shards; model probabilities within 0.2 of the analytic answer and of
    the JAX package's sharded run."""
    models, priors, analytic = tmsel.tractable_pair()
    abc = _make("port", _adaptive("port"), 22, pop=600, model=models,
                prior=priors, obs={"x": X_OBS})
    h = abc.run(max_nr_populations=4)
    jm, jp, _ja = jmsel.tractable_pair()
    jh = _make("jax", _adaptive("jax"), 22, pop=600, model=jm, prior=jp,
               obs={"x": X_OBS}).run(max_nr_populations=4)
    expected = analytic(X_OBS)
    probs = h.get_model_probabilities(h.max_t)
    jprobs = jh.get_model_probabilities(jh.max_t)
    for m in range(2):
        p = float(probs["p"].get(m, 0.0))
        assert p == pytest.approx(expected[m], abs=0.2), (m, p)
        assert p == pytest.approx(float(jprobs["p"].get(m, 0.0)), abs=0.2)
    w = _weights(abc)
    assert sorted(w) == list(range(h.max_t + 2))
    assert all(not np.array_equal(w[t], w[t - 1]) for t in w if t > 0)


# --------------------------------------------------------- the gate
@pytest.mark.parametrize("scale", ["median", "median_absolute_deviation",
                                   "mean_absolute_deviation"])
def test_scale_without_moment_form_is_the_jax_packages_refusal(scale):
    """A median-based or two-pass scale: the JAX package's ValueError,
    word for word."""
    jabc = jpt.ABCSMC(_jax_gauss2(),
                      jpt.Distribution(theta=jpt.RV("norm", 0.0, 1.0)),
                      jpt.AdaptiveAggregatedDistance(
                          [jpt.PNormDistance(p=2), jpt.PNormDistance(p=1)],
                          scale_function=getattr(jscale, scale)),
                      population_size=64, sharded=8, fused_generations=3)
    jabc.new("sqlite://", {"x": X_OBS, "y": 10.0 * X_OBS})
    with pytest.raises(ValueError) as jax_err:
        jabc._sharded_n()
    with pytest.raises(ValueError) as port_err:
        tpt.ABCSMC(tpt.TorchModel(_sim2, ["theta"], name="g"),
                   tpt.Distribution(theta=tpt.RV("norm", 0.0, 1.0)),
                   tpt.AdaptiveAggregatedDistance(
                       [tpt.PNormDistance(p=2), tpt.PNormDistance(p=1)],
                       scale_function=getattr(tscale, scale)),
                   population_size=64, sharded=8, fused_generations=3,
                   device="cpu")
    assert str(port_err.value) == str(jax_err.value)
    assert "moment-decomposable" in str(port_err.value)


@pytest.mark.parametrize("scale", [None, "mean", "standard_deviation",
                                   "median", "median_absolute_deviation",
                                   "mean_absolute_deviation"])
def test_gate_admits_what_the_jax_gate_admits(scale):
    """The port's ``sharded_scale_capable`` (with its constructor's
    refusals of a custom or two-argument scale and of a sub-distance
    schedule) admits exactly what the JAX package's admits."""
    kw = [{} if scale is None else
          {"scale_function": getattr(mod, scale)} for mod in (jscale,
                                                              tscale)]
    jd = jpt.AdaptiveAggregatedDistance(
        [jpt.PNormDistance(p=2), jpt.PNormDistance(p=1)], **kw[0])
    jd.initialize(0, None, {"x": 1.0})
    td = tpt.AdaptiveAggregatedDistance(
        [tpt.PNormDistance(p=2), tpt.PNormDistance(p=1)], **kw[1])
    assert td.sharded_scale_capable() == jd.sharded_scale_capable()
    assert td.sharded_scale_capable() == (scale in (None, "mean",
                                                    "standard_deviation"))
