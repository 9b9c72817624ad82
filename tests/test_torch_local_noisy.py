"""LocalTransition under a StochasticAcceptor (noisy ABC) on the CPU.

The JAX suite's noisy configuration (``tests/test_fused_noisy.py``,
``_noisy_abc``: x = theta, N(0, 1) prior, IndependentNormalKernel(var
0.09), Temperature(), pop 400, chunks of 4) with ``LocalTransition()`` at a
constant n runs in both packages over three seeds. The rules are those of
``tests/test_torch_stochastic.py``: the temperature trail falls to exactly
1, the posterior mean and sd within 0.05 of the exact N(0.7339, 0.2874^2)
(a pop-400 run's mean moves by about 0.017), one counter read a round and
one fetch a chunk; the two packages' 3-seed means within 0.05.

The record ring's pass under the refit transition (the AcceptanceRateScheme
reweighting, ``inference/util.py::_stochastic_gen_update``) is K14 over
every ring row: its densities within 1e-4 + 1e-5 relative of the JAX
package's ``device_logpdf`` on the same ring and params, and in a run under
the refit cadence each ring row's ``logq`` is K14's density under the
params it was proposed from. The JAX gate's cell
(``test_fused_noisy.py:413-421``) is mirrored: a list of sizes raises.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import pyabc_tpu as jpt  # noqa: E402
from pyabc_tpu.transition.local_transition import (  # noqa: E402
    LocalTransition as JLocal)
import pyabc_tpu_torch as tpt  # noqa: E402
from pyabc_tpu_torch import convert  # noqa: E402
from pyabc_tpu_torch.inference import context as context_mod  # noqa: E402
from pyabc_tpu_torch.inference.context import DeviceContext  # noqa: E402
from pyabc_tpu_torch.kernels.local_logpdf import local_logpdf  # noqa: E402

torch.set_num_threads(1)

NOISE_SD, X_OBS = 0.3, 0.8
POST_VAR = 1.0 / (1.0 + 1.0 / NOISE_SD ** 2)
POST_MU, POST_SD = POST_VAR * X_OBS / NOISE_SD ** 2, POST_VAR ** 0.5
SEEDS = (21, 22, 23)


def _noisy(pkg, seed, pop=400, population_size=None, eps=None, **kw):
    mod = jpt if pkg == "jax" else tpt
    args = dict(population_size=population_size or pop,
                eps=eps or mod.Temperature(),
                acceptor=mod.StochasticAcceptor(),
                seed=seed, fused_generations=4,
                transitions=mod.LocalTransition(), **kw)
    prior = mod.Distribution(theta=mod.RV("norm", 0.0, 1.0))
    kernel = mod.IndependentNormalKernel(var=[NOISE_SD ** 2])
    if pkg == "jax":
        @jpt.JaxModel.from_function(["theta"], name="det")
        def model(key, theta):
            return {"x": theta[0]}

        return jpt.ABCSMC(model, prior, kernel, **args)
    model = tpt.TorchModel(lambda theta, gen: {"x": theta[:, 0]}, ["theta"],
                           name="det")
    return tpt.ABCSMC(model, prior, kernel, device="cpu", **args)


def _moments(h):
    df, w = h.get_distribution()
    x = np.asarray(df["theta"])
    mu = float(np.sum(w * x))
    return mu, float(np.sqrt(np.sum(w * (x - mu) ** 2)))


def _temps(h):
    return [float(x) for x in h.get_all_populations()["epsilon"][1:]]


@pytest.fixture(scope="module")
def runs():
    out = {"port": [], "jax": [], "abc": []}
    for seed in SEEDS:
        for pkg in ("port", "jax"):
            abc = _noisy(pkg, seed)
            abc.new("sqlite://", {"x": X_OBS})
            if pkg == "jax":
                abc._initialize_components(8)
                assert abc._fused_chunk_capable()
            else:
                out["abc"].append(abc)
            out[pkg].append(abc.run(max_nr_populations=7))
    return out


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_runs_meet_the_noisy_rules(runs, pkg):
    for h in runs[pkg]:
        temps = _temps(h)
        assert temps[-1] == 1.0 and temps[0] > 1.0
        assert all(b <= a for a, b in zip(temps, temps[1:]))
        mu, sd = _moments(h)
        assert abs(mu - POST_MU) < 0.05 and abs(sd - POST_SD) < 0.05


def test_port_agrees_with_jax_and_reads_once_a_round(runs):
    port = np.mean([_moments(h)[0] for h in runs["port"]])
    ref = np.mean([_moments(h)[0] for h in runs["jax"]])
    assert port == pytest.approx(ref, abs=0.05)
    for abc in runs["abc"]:
        kinds = abc.sync_ledger.summary()["by_kind"]
        chunks = -(-len(abc.generation_log) // 4)
        assert set(kinds) == {"round_counters", "chunk_fetch"}
        assert kinds["chunk_fetch"] == chunks
        assert kinds["round_counters"] > sum(
            g["rounds"] for g in abc.generation_log)


def test_ring_densities_match_jax():
    """K14 over a record ring of 8 n_cap rows (40 % unwritten zeros) under
    a JAX LocalTransition fit carried across: within 1e-4 + 1e-5
    relative."""
    rng = np.random.default_rng(3)
    n = 64
    X = rng.normal(POST_MU, POST_SD, size=(n, 1)).astype(np.float32)
    w = rng.uniform(0.5, 1.0, n).astype(np.float32)
    w /= w.sum()
    jp = JLocal.device_fit(jnp.asarray(X), jnp.asarray(w), dim=1,
                           scaling=1.0, k=20)
    ring = rng.normal(0.0, 1.0, size=(8 * n, 1)).astype(np.float32)
    ring[int(0.6 * len(ring)):] = 0.0
    ref = np.asarray(jax.vmap(lambda th: JLocal.device_logpdf(th, jp))(
        jnp.asarray(ring)))
    params = convert.local_transition_params(jax.tree.map(np.asarray, jp),
                                             device="cpu")
    got = local_logpdf(torch.from_numpy(ring), params).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-5)


def test_ring_logq_is_k14_at_proposal_time_under_the_cadence(monkeypatch):
    """Under the refit cadence (every 3 generations; a fixed-iteration
    decay from T 64 with the acceptance-rate scheme) each valid ring row's
    ``logq`` is K14's density under the params it was proposed from, and
    the reweighting reads K14 under the params after the step: equal to
    ``logq`` where the cadence kept the fit."""
    seen = []
    step = DeviceContext.generation_step

    def spy_step(self, carry, run, **kw):
        seen.append({"params": carry.trans_params, "rec": run.rec,
                     "t": kw.get("t")})
        return step(self, carry, run, **kw)

    update = context_mod.temperature_update

    class SpyUpdate:
        def __getattr__(self, name):
            return getattr(update, name)

        def update(self, **kw):
            seen[-1]["logq_new"] = kw["logq_new"]
            return update.update(**kw)

    monkeypatch.setattr(DeviceContext, "generation_step", spy_step)
    monkeypatch.setattr(context_mod, "temperature_update", SpyUpdate())
    # the acceptance-rate scheme (which reweights the ring) beside a
    # fixed-iteration decay from 64 that sets the pace: six generations
    abc = _noisy("port", 5, pop=200, refit_every=3, eps=tpt.Temperature(
        schemes=[tpt.AcceptanceRateScheme(target_rate=0.9),
                 tpt.ExpDecayFixedIterScheme()], initial_temperature=64.0))
    abc.new("sqlite://", {"x": X_OBS})
    h = abc.run(max_nr_populations=6)
    refits = [e[1] for e in abc.refit_events]
    assert not all(refits), refits
    checked = 0
    for g, rec in enumerate(seen):
        if g == 0:
            continue  # generation 0 proposes from the prior
        valid = rec["rec"]["valid"]
        theta = rec["rec"]["theta"][valid]
        want = local_logpdf(theta.contiguous(), rec["params"])
        # the same plain K14 on another batch of rows: a few ulps at most
        torch.testing.assert_close(rec["rec"]["logq"][valid], want,
                                   rtol=1e-6, atol=1e-6)
        if g < h.max_t and not refits[g]:
            torch.testing.assert_close(rec["logq_new"][valid], want,
                                       rtol=1e-6, atol=1e-6)
        checked += 1
    assert checked >= 4


def test_list_size_is_refused_as_the_jax_gate_refuses_it():
    """``test_stochastic_local_transition_needs_constant_population``."""
    jabc = _noisy("jax", 21)
    jabc.population_strategy = jpt.ListPopulationSize([400] * 8)
    jabc.new("sqlite://", {"x": X_OBS})
    jabc._initialize_components(8)
    assert not jabc._fused_chunk_capable()
    with pytest.raises(NotImplementedError,
                       match="constant population size.*item 16"):
        _noisy("port", 21, population_size=tpt.ListPopulationSize([400] * 8))
