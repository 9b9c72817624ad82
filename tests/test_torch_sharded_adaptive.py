"""Sharded sampling under an adaptive distance and a listed population
size (``tests/test_sharded.py::_make_adaptive``: ``AdaptivePNormDistance(p=2,
scale_function=standard_deviation)``, a ``ListPopulationSize``, two
statistics x = theta + 0.5 z, y = 10 theta + z): the port against the JAX
package's virtual-shard runs on the CPU.

The weights refit every generation from the shards' moment blocks (K24d),
each generation persists its listed n, and the weights, the epsilon trail
and the posterior follow the JAX package's over two seeds. On one
generation, the distances recomputed from the stored feature rows equal
the weighted p-norm of the kept rows under the new weights, and the
combined moments are those of every ring-eligible evaluation. The record
ring is never allocated and the round adds no host read.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import pyabc_tpu as jpt  # noqa: E402
from pyabc_tpu.distance.scale import standard_deviation as jstd  # noqa: E402
import pyabc_tpu_torch as tpt  # noqa: E402
from pyabc_tpu_torch.distance.scale import standard_deviation  # noqa: E402
from pyabc_tpu_torch.kernels.pnorm_accept import pnorm_rows  # noqa: E402
from pyabc_tpu_torch.ops.scale_reduce import (  # noqa: E402
    accumulate_moments, combine_moments, init_moments)

torch.set_num_threads(1)

POP = 128
SIZES = [POP, POP - 28, POP, POP - 60, POP, POP]
SEEDS = (121, 122)


def _sim(theta, g):
    z = torch.randn(theta.shape[0], generator=g, device=theta.device)
    return {"x": theta[:, 0] + 0.5 * z, "y": 10.0 * theta[:, 0] + z}


def _port(seed):
    abc = tpt.ABCSMC(
        tpt.TorchModel(_sim, ["theta"], name="gauss2_adaptive"),
        tpt.Distribution(theta=tpt.RV("norm", 0.0, 1.0)),
        tpt.AdaptivePNormDistance(p=2, scale_function=standard_deviation),
        population_size=tpt.ListPopulationSize(SIZES),
        eps=tpt.MedianEpsilon(), seed=seed, sharded=8, fused_generations=3,
        device="cpu")
    abc.new("sqlite://", {"x": 1.0, "y": 10.0})
    return abc, abc.run(max_nr_populations=6)


def _jax(seed):
    @jpt.JaxModel.from_function(["theta"], name="gauss2_adaptive")
    def model(key, theta):
        z = jax.random.normal(key)
        return {"x": theta[0] + 0.5 * z, "y": 10.0 * theta[0] + z}

    abc = jpt.ABCSMC(
        model, jpt.Distribution(theta=jpt.RV("norm", 0.0, 1.0)),
        jpt.AdaptivePNormDistance(p=2, scale_function=jstd),
        population_size=jpt.ListPopulationSize(SIZES),
        eps=jpt.MedianEpsilon(), seed=seed, sharded=8, fused_generations=3)
    abc.new("sqlite://", {"x": 1.0, "y": 10.0})
    return abc, abc.run(max_nr_populations=6)


@pytest.fixture(scope="module")
def runs():
    return {(pkg, seed): (_port if pkg == "port" else _jax)(seed)
            for pkg in ("port", "jax") for seed in SEEDS}


def _weights(abc):
    return {t: np.asarray(w, float)
            for t, w in abc.distance_function.weights.items()}


def _moments(h):
    df, w = h.get_distribution(0, h.max_t)
    mu = float(np.sum(df["theta"] * w))
    return mu, float(np.sqrt(np.sum(w * (df["theta"] - mu) ** 2)))


@pytest.mark.parametrize("seed", SEEDS)
def test_weights_refit_every_generation(runs, seed):
    """The scale state is live (``test_sharded.py``'s ``w[1] != w[2]``):
    every generation's weights differ from the last, stay positive with
    mean 1, and each generation holds its listed n with weights summing
    to 1."""
    abc, h = runs["port", seed]
    w = _weights(abc)
    assert sorted(w) == list(range(7))
    for t in range(1, 7):
        assert not np.array_equal(w[t], w[t - 1]), t
        assert np.all(w[t] > 0) and w[t].mean() == pytest.approx(1.0)
    counts = h.get_nr_particles_per_population()
    for t, n in enumerate(SIZES):
        assert counts[t] == n
        _df, wt = h.get_distribution(0, t)
        assert np.asarray(wt).sum() == pytest.approx(1.0)


@pytest.mark.parametrize("seed", SEEDS)
def test_weights_follow_the_jax_package(runs, seed):
    """Each generation's weights within 0.1 of the JAX package's sharded
    run (the same scale over other draws: the calibration's and the
    refits' samples differ)."""
    w, wj = _weights(runs["port", seed][0]), _weights(runs["jax", seed][0])
    assert sorted(w) == sorted(wj)
    for t in w:
        np.testing.assert_allclose(w[t], wj[t], atol=0.1, err_msg=str(t))


def test_trail_and_posterior_follow_the_jax_package(runs):
    """The two seeds' mean epsilon trail from generation 1 within 25 % of
    the JAX package's, each posterior mean within 0.05 of theta = 1 (the
    two statistics pin it) and of the JAX package's, sds within 0.15."""
    def trail(pkg):
        return np.mean([runs[pkg, s][1].get_all_populations().query(
            "t >= 1")["epsilon"].to_numpy() for s in SEEDS], axis=0)

    np.testing.assert_allclose(trail("port"), trail("jax"), rtol=0.25)
    for s in SEEDS:
        mu, sd = _moments(runs["port", s][1])
        mu_j, sd_j = _moments(runs["jax", s][1])
        assert mu == pytest.approx(1.0, abs=0.05)
        assert mu == pytest.approx(mu_j, abs=0.05)
        assert sd == pytest.approx(sd_j, abs=0.15)


def test_no_ring_and_no_extra_read(runs):
    """The adaptive run reads what the plain sharded run reads: one
    counter copy a round, the calibration's round and collect, one fetch
    a chunk."""
    abc, _h = runs["port", SEEDS[0]]
    rounds = sum(g["rounds"] for g in abc.generation_log)
    report = abc.sync_ledger.budget_report(rounds=rounds, chunks=2, slack=2)
    assert report["ok"], report
    assert report["by_kind"] == {"round_counters": rounds + 1,
                                 "generation_collect": 1, "chunk_fetch": 2}


@pytest.mark.parametrize("p", [2.0, 1.0])
def test_generation_refit_from_shard_moments(p):
    """One sharded generation through the context: no record ring; the
    combined moment blocks are those of every valid evaluation in each
    running shard's window; the weights are the moment finish of them;
    the recomputed distances equal the weighted p-norm of the rows under
    the new weights (the declared (sum w^p f)^(1/p) form, rtol 1e-5)."""
    abc = tpt.ABCSMC(
        tpt.TorchModel(_sim, ["theta"], name="gauss2_adaptive"),
        tpt.Distribution(theta=tpt.RV("norm", 0.0, 1.0)),
        tpt.AdaptivePNormDistance(p=p, scale_function=standard_deviation),
        population_size=300, eps=tpt.MedianEpsilon(), seed=4, sharded=8,
        fused_generations=3, device="cpu")
    abc.new("sqlite://", {"x": 1.0, "y": 10.0})
    ctx = abc._build_context(300, 0.0)
    d = abc.distance_function
    seen = []

    def lanes():
        out = ctx.lanes_prior(torch.tensor(float("inf")), torch.ones(2),
                              t=0)
        seen.append({k: out[k].clone() for k in ("sumstats", "valid")})
        return out

    run = ctx.generation_while_sharded(lanes, 300, adaptive=True)
    assert run.rec is None and run.mom.shape == (8, 6, 2)
    # at eps = inf one round fills every shard (quotas 38 of 128 lanes);
    # each shard's window is rec_cap slots
    assert run.rounds == 1 and run.gen_ok
    B_loc = ctx.B // 8
    mom = init_moments(2)
    ss, valid = seen[0]["sumstats"], seen[0]["valid"]
    take = valid & (torch.arange(ctx.B) % B_loc < ctx.rec_cap)
    mom = accumulate_moments(mom, ss, take, ctx.x0)
    np.testing.assert_allclose(combine_moments(run.mom).numpy(),
                               mom.numpy(), rtol=1e-5)
    w, d_new = d.refit_sharded(run.mom, ctx.x0, run.res["dfeat"])
    w_ref, _d = d.refit_from_moments(combine_moments(run.mom), ctx.x0,
                                     run.res["sumstats"])
    np.testing.assert_allclose(w.numpy(), w_ref.numpy(), rtol=1e-6)
    direct = pnorm_rows(run.res["sumstats"], ctx.x0, w, p)
    np.testing.assert_allclose(d_new[run.k_mask].numpy(),
                               direct[run.k_mask].numpy(), rtol=1e-5)
