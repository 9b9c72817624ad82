"""Port parity: the shard math of sharded fused sampling (K24a-d's plain
versions) against the JAX package's ``ops/shard.py``, its per-shard
``_generation_while`` and its sharded refit and fetch on the CPU.

The quotas and the merge index are host integers and must be equal; the
compaction moves values, so each shard's reservoir block, its counters,
its feature rows and its mask must equal the JAX package's per-shard loop
fed the same rounds; the moment blocks' counts and extrema are equal and
their sums within float32 summation-order rounding; the fetch's merge is a
gather (bit-equal).
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import pyabc_tpu as jpt  # noqa: E402
from pyabc_tpu.inference.util import DeviceContext as JaxContext  # noqa: E402
from pyabc_tpu.ops import pack as jpack  # noqa: E402
from pyabc_tpu.ops import scale_reduce as jsr  # noqa: E402
from pyabc_tpu.ops import shard as jshard  # noqa: E402
from pyabc_tpu_torch import RV, Distribution, PNormDistance  # noqa: E402
from pyabc_tpu_torch.core.sumstat_spec import SumStatSpec  # noqa: E402
from pyabc_tpu_torch.inference.context import DeviceContext  # noqa: E402
from pyabc_tpu_torch.kernels import compact_round, moment_finish  # noqa: E402
from pyabc_tpu_torch.kernels import shard_mask  # noqa: E402
from pyabc_tpu_torch.kernels.moments import SCALE_NAMES  # noqa: E402
from pyabc_tpu_torch.ops import pack as tpack  # noqa: E402
from pyabc_tpu_torch.ops import scale_reduce as tsr  # noqa: E402
from pyabc_tpu_torch.ops import shard as tshard  # noqa: E402

torch.set_num_threads(1)

N_SH, B_LOC, D, S = 4, 16, 2, 5
B = N_SH * B_LOC
LAYOUTS = [(300, 8, 64), (100, 8, 16), (16384, 8, 2048)]


@pytest.mark.parametrize("n_keep,n_shards,cap_loc", LAYOUTS)
def test_quota_and_merge_index_equal_the_jax_package(n_keep, n_shards,
                                                     cap_loc):
    q = tshard.shard_quota_host(n_keep, n_shards)
    np.testing.assert_array_equal(
        q, jshard.shard_quota_host(n_keep, n_shards))
    assert q.sum() == n_keep and q.max() - q.min() <= 1
    idx = tshard.merge_index(n_keep, n_shards, cap_loc)
    np.testing.assert_array_equal(
        idx, jshard.merge_index(n_keep, n_shards, cap_loc))
    assert idx.dtype == np.int32 and len(idx) == n_keep
    assert idx[0] == 0 and idx[q[0]] == cap_loc


@pytest.mark.parametrize("n_keep,n_shards,cap_loc", [(300, 8, 16),
                                                     (100, 8, 8)])
def test_merge_index_refuses_a_quota_above_the_shard(n_keep, n_shards,
                                                     cap_loc):
    for mod in (tshard, jshard):
        with pytest.raises(ValueError, match="exceeds per-shard"):
            mod.merge_index(n_keep, n_shards, cap_loc)


@pytest.mark.parametrize("n_target,n_shards,cap_loc", [
    (300, 8, 64), (100, 8, 16), (37, 8, 8), (5, 8, 4), (16384, 8, 2048)])
def test_shard_mask_and_quota_equal_the_traced_ones(n_target, n_shards,
                                                    cap_loc):
    """On the same counters: the tensor quotas and the mask equal the JAX
    package's traced ``shard_quota`` and ``shard_mask``; K24b's plain
    version gives them and the generation's totals."""
    rng = np.random.default_rng(n_target)
    nacc = rng.integers(0, 2 * cap_loc, n_shards).astype(np.int32)
    rounds = rng.integers(1, 9, n_shards).astype(np.int32)
    nvalid = rng.integers(0, 500, n_shards).astype(np.int32)
    jq = np.asarray(jshard.shard_quota(jnp.int32(n_target), n_shards))
    jm = np.asarray(jshard.shard_mask(jnp.asarray(nacc), jnp.asarray(jq),
                                      n_shards, cap_loc))
    q = tshard.shard_quota(n_target, n_shards)
    np.testing.assert_array_equal(q.numpy(), jq)
    np.testing.assert_array_equal(
        tshard.shard_mask(torch.from_numpy(nacc), q, n_shards,
                          cap_loc).numpy(), jm)
    counters = torch.tensor([0, 0, 0, 1, n_target], dtype=torch.int32)
    table = torch.from_numpy(np.stack(
        [nacc, rounds, nvalid, np.zeros_like(nacc)], 1).copy())
    quota, mask, summary = shard_mask(counters, table, n_shards=n_shards,
                                      cap_loc=cap_loc)
    np.testing.assert_array_equal(quota.numpy(), jq)
    np.testing.assert_array_equal(mask.numpy(), jm)
    ok = bool(np.all(nacc >= np.minimum(jq, cap_loc)))
    assert summary.tolist() == [int(nacc.sum()), int(rounds.max()),
                                int(nvalid.sum()), 1, n_target, int(ok)]


# ------------------------------------------------ K24a and K24d's fold
def _run_lanes(key, dyn):
    k = jax.random.split(key, 6)
    return {
        "m": jnp.zeros((B,), jnp.int32),
        "theta": jax.random.normal(k[0], (B, D)),
        "sumstats": jax.random.normal(k[1], (B, S)),
        "distance": jax.random.uniform(k[2], (B,)),
        "accepted": jax.random.uniform(k[3], (B,)) < 0.6,
        "valid": jax.random.uniform(k[4], (B,)) < 0.85,
        "log_weight": jax.random.normal(k[5], (B,)),
    }


def _jax_ctx():
    obs = {"s": np.zeros(S)}
    spec = jpt.SumStatSpec(obs)
    model = jpt.JaxModel(lambda key, th: {"s": jnp.zeros(S)}, ["a", "b"])
    prior = jpt.Distribution(a=jpt.RV("norm", 0, 1), b=jpt.RV("norm", 0, 1))
    dist = jpt.PNormDistance(p=2, sumstat_spec=spec)
    dist.initialize(0, None, obs)
    return JaxContext(models=[model], parameter_priors=[prior],
                      model_prior_logits=np.zeros(1), distance=dist,
                      acceptor=jpt.UniformAcceptor(), spec=spec,
                      x_0_flat=np.zeros(S, np.float32),
                      transition_cls=jpt.MultivariateNormalTransition)


def _port_ctx(cap_loc, rec_loc, max_rounds, x0):
    prior = Distribution(a=RV("norm", 0, 1), b=RV("norm", 0, 1))
    return DeviceContext(
        model=None, prior=prior, distance=PNormDistance(p=2),
        acceptor=None, transition=None,
        spec=SumStatSpec({"s": np.zeros(S)}), x0=torch.from_numpy(x0),
        device=torch.device("cpu"), generator=None, B=B,
        n_cap=N_SH * cap_loc, rec_cap=rec_loc, max_rounds=max_rounds,
        n_shards=N_SH)


@pytest.mark.parametrize("n_target,cap_loc,rec_loc,max_rounds", [
    (42, 16, 40, 10),   # uneven quotas (11, 11, 10, 10), the window cut
    (30, 8, 256, 10),   # quota 8 = a shard's rows: blocks overflow
    (64, 16, 24, 2),    # the round budget ends every shard
])
def test_shard_rounds_equal_the_jax_per_shard_loop(n_target, cap_loc,
                                                   rec_loc, max_rounds):
    """K24a and K24d's fold (plain) over a whole sharded generation
    against the JAX package's ``_generation_while`` run once per shard
    (``local_generation``, ``util.py:2404-2420``) on the same rounds, with
    the distance features and the moment block: every shard's reservoir
    block, feature rows, counters and moments, then K24b's mask."""
    key = jax.random.key(17)
    x0 = np.random.default_rng(3).normal(size=S).astype(np.float32)
    jctx = _jax_ctx()
    quota = jshard.shard_quota_host(n_target, N_SH)
    ref = []
    for s in range(N_SH):
        def lanes_s(k, dyn, s=s):
            return {kk: v[s * B_LOC:(s + 1) * B_LOC]
                    for kk, v in _run_lanes(k, dyn).items()}

        ref.append(jctx._generation_while(
            key, None, jnp.int32(int(quota[s])), B=B_LOC, n_cap=cap_loc,
            rec_cap=rec_loc, max_rounds=max_rounds, run_lanes=lanes_s,
            moment_cfg=(S, None, jnp.asarray(x0), jnp.asarray(x0)),
            dfeat_cfg=(S, lambda ss, xo: jnp.abs(ss - xo) ** 2.0,
                       jnp.asarray(x0))))

    def lanes(r=iter(range(100))):
        out = _run_lanes(jax.random.fold_in(key, next(r)), None)
        return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}

    run = _port_ctx(cap_loc, rec_loc, max_rounds, x0)\
        .generation_while_sharded(lanes, n_target, adaptive=True)
    nacc = np.array([int(r[0]) for r in ref], np.int32)
    assert run.n_acc == nacc.sum()
    assert run.rounds == max(int(r[1]) for r in ref)
    assert run.n_valid == sum(int(r[2]) for r in ref)
    for s, (n_acc, rounds, n_valid, res, _rec, mom) in enumerate(ref):
        blk = slice(s * cap_loc, (s + 1) * cap_loc)
        for k in ("theta", "sumstats", "distance", "log_weight", "slot"):
            np.testing.assert_array_equal(run.res[k][blk].numpy(),
                                          np.asarray(res[k]),
                                          err_msg=f"shard {s} {k}")
        # the features: one multiply against XLA's CPU pow(x, 2.0) (exp
        # and log), a few ulps apart, more near 0
        np.testing.assert_allclose(run.res["dfeat"][blk].numpy(),
                                   np.asarray(res["dfeat"]), rtol=1e-5,
                                   atol=1e-8, err_msg=f"shard {s} dfeat")
        got = run.mom[s].numpy()
        mom = np.asarray(mom)
        np.testing.assert_array_equal(got[3:], mom[3:],
                                      err_msg=f"shard {s} counts/extrema")
        np.testing.assert_allclose(got[:3], mom[:3], rtol=1e-6, atol=1e-6,
                                   err_msg=f"shard {s} sums")
    jm = jshard.shard_mask(jnp.asarray(nacc), jnp.asarray(quota), N_SH,
                           cap_loc)
    np.testing.assert_array_equal(run.k_mask.numpy(), np.asarray(jm))
    assert run.gen_ok == bool(np.all(nacc >= np.minimum(quota, cap_loc)))
    assert run.counters.tolist()[:3] == [run.n_acc, run.rounds,
                                         run.n_valid]


def test_shard_keeps_its_first_accepted_lanes_and_freezes():
    """The reduction in numpy: shard s keeps the first quota_s accepted
    lanes of its block, round after round in slot order; once finished,
    a later round leaves its block and its row as they were."""
    rng = np.random.default_rng(5)
    cap_loc, n_target = 8, 26   # quotas 7, 7, 6, 6
    quota = tshard.shard_quota_host(n_target, N_SH)
    res = _port_ctx(cap_loc, 0, 10, np.zeros(S, np.float32)).new_reservoir()
    counters = torch.tensor([0, 0, 0, 0, n_target], dtype=torch.int32)
    table = torch.zeros(N_SH, 4, dtype=torch.int32)
    kept = [[] for _ in range(N_SH)]
    running = np.ones(N_SH, bool)
    for r in range(6):
        acc = rng.random(B) < 0.3
        valid = rng.random(B) < 0.9
        theta = rng.normal(size=(B, D)).astype(np.float32)
        before = {k: v.clone() for k, v in res.items()}
        row_before = table.clone()
        compact_round.shards(
            torch.from_numpy(acc), torch.from_numpy(valid),
            torch.from_numpy(theta), torch.zeros(B, S), torch.zeros(B),
            torch.zeros(B), res, counters, table, n_shards=N_SH,
            max_rounds=10)
        assert int(counters[1]) == r + 1
        for s in range(N_SH):
            blk = slice(s * cap_loc, (s + 1) * cap_loc)
            if not running[s]:
                for k in res:
                    assert torch.equal(res[k][blk], before[k][blk]), (r, s)
                assert torch.equal(table[s], row_before[s])
                continue
            lanes = np.arange(s * B_LOC, (s + 1) * B_LOC)
            kept[s] += [theta[i] for i in lanes if acc[i] and valid[i]]
            n = min(len(kept[s]), cap_loc)
            np.testing.assert_array_equal(res["theta"][blk][:n].numpy(),
                                          np.asarray(kept[s][:n]))
            assert int(table[s, 0]) == len(kept[s])
            running[s] = len(kept[s]) < quota[s]
    assert not running.any()


@pytest.mark.parametrize("name", SCALE_NAMES)
def test_sharded_finish_equals_the_jax_combine(name):
    """K24d's finish (plain): the shard blocks combined in shard order,
    the scale, the weights and the feature-row distances, against the JAX
    package's ``combine_moments``, ``scale_from_moments``, the adaptive
    distance's ``device_weight_update`` and ``device_sharded_dfeat``."""
    rng = np.random.default_rng(11)
    n, rows = 8, 50
    x = rng.normal(2.0, 1.5, size=(n, 40, S)).astype(np.float32)
    x0 = rng.normal(size=S).astype(np.float32)
    parts = np.stack([np.asarray(jsr.accumulate_moments(
        jsr.init_moments(S), jnp.asarray(x[s]),
        jnp.asarray(rng.random(40) < 0.8), jnp.asarray(x0)))
        for s in range(n)])
    feat = (np.abs(rng.normal(size=(rows, S))) ** 2).astype(np.float32)
    jd = jpt.AdaptivePNormDistance(
        p=2, scale_function=getattr(jpt.distance.scale, name))
    jd.initialize(0, None, {"s": np.zeros(S)})
    mom = jsr.combine_moments(jnp.asarray(parts))
    scale = jsr.scale_from_moments(name)(mom, jnp.asarray(x0))
    w = jd.device_weight_update()(scale)
    comb = jd.device_sharded_dfeat(jpt.SumStatSpec({"s": np.zeros(S)}))[
        "combine"]
    d = jax.vmap(lambda f: comb(f, w))(jnp.asarray(feat))
    t_scale, t_w, t_d = moment_finish.shards(
        torch.from_numpy(parts), torch.from_numpy(x0),
        torch.from_numpy(feat), scale_name=name)
    np.testing.assert_allclose(
        tsr.combine_moments(torch.from_numpy(parts)).numpy(),
        np.asarray(mom), rtol=1e-6)
    np.testing.assert_allclose(t_scale.numpy(), np.asarray(scale),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t_w.numpy(), np.asarray(w), rtol=1e-5)
    np.testing.assert_allclose(t_d.numpy(), np.asarray(d), rtol=1e-5)


# ------------------------------------------------------------ K24c
@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
@pytest.mark.parametrize("n_keep,cap_loc", [(300, 64), (100, 16), (61, 8)])
def test_merged_fetch_equals_pack_outs_merge_index(dtype, n_keep, cap_loc):
    """K24c (plain): the fetch of a constant n merged from the
    shard-blocked reservoir, bit-equal to the JAX package's
    ``pack_outs(merge_index=)``, model column and sum stats included."""
    rng = np.random.default_rng(n_keep)
    G, n = 3, 8
    n_cap = n * cap_loc
    outs = {"theta": rng.normal(size=(G, n_cap, D)),
            "distance": rng.random((G, n_cap)),
            "log_weight": rng.normal(size=(G, n_cap)),
            "sumstats": rng.normal(size=(G, n_cap, S)),
            "m": rng.integers(0, 3, (G, n_cap))}
    outs = {k: v.astype(np.int32 if k == "m" else np.float32)
            for k, v in outs.items()}
    ref = jpack.pack_outs(
        {k: jnp.asarray(v) for k, v in outs.items()}, n_keep=n_keep,
        dtype=getattr(jnp, dtype), keep_m=True, ss_gens="all",
        merge_index=jshard.merge_index(n_keep, n, cap_loc))
    t = {k: torch.from_numpy(v) for k, v in outs.items()}
    merge = ([n_keep] * G, n, cap_loc)
    tdt = getattr(torch, dtype)
    rows = tpack.pack_rows(t["theta"], t["distance"], t["log_weight"],
                           n_keep=n_keep, dtype=tdt, merge=merge)
    ss = tpack.pack_sumstats(list(t["sumstats"]), n_keep=n_keep, dtype=tdt,
                             merge=merge)
    ms = tpack.pack_models(list(t["m"]), n_keep=n_keep, merge=merge)
    for got, want in ((rows, ref["rows"]), (ss, ref["sumstats"])):
        np.testing.assert_array_equal(
            got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    np.testing.assert_array_equal(ms.numpy(), np.asarray(ref["m"]))


def test_merged_fetch_of_a_list_takes_each_generations_n():
    """Under a ListPopulationSize each generation merges with its own
    quotas (the JAX package re-indexes each generation on the host with
    its own ``merge_index``, ``smc.py:2824-2831``); its rows beyond its n
    are row i."""
    rng = np.random.default_rng(2)
    n, cap_loc, ns = 8, 16, [100, 72, 128]
    n_cap, n_keep = n * cap_loc, max(ns)
    theta = torch.from_numpy(rng.normal(size=(3, n_cap, D)).astype(
        np.float32))
    dist = torch.from_numpy(rng.random((3, n_cap)).astype(np.float32))
    logw = torch.from_numpy(rng.normal(size=(3, n_cap)).astype(np.float32))
    rows = tpack.pack_rows(theta, dist, logw, n_keep=n_keep,
                           dtype=torch.float32, merge=(ns, n, cap_loc))
    for g, ng in enumerate(ns):
        idx = jshard.merge_index(ng, n, cap_loc)
        np.testing.assert_array_equal(rows[g, :ng, :D].numpy(),
                                      theta[g].numpy()[idx])
        np.testing.assert_array_equal(rows[g, :ng, D].numpy(),
                                      dist[g].numpy()[idx])
        np.testing.assert_array_equal(rows[g, ng:, D + 1].numpy(),
                                      logw[g, ng:n_keep].numpy())
