"""Whole runs with MLP learned summary statistics: the port against the JAX
package's own fused runs on the CPU.

The Fearnhead-Prangle Gaussian model of ``tests/test_torch_sumstat_runs.py``
under ``PNormDistance`` and ``AdaptivePNormDistance`` with a
``PredictorSumstat(MLPPredictor(hidden=(16, 16), n_steps=60))``: the seed
mean of the posterior means against the JAX package's over the same seeds
(not against the analytic mean: the MLP statistic carries less of it in
both packages), and the generations the predictor was fitted at (the seed
fit after generation 0, then each chunk's boundary) equal to the JAX
package's. Then the network SIR at the small shape (2 patches, 8
observations: S 16 in 4 segments) under ``MLPPredictor(hidden=(8, 8),
n_steps=100)``: the epsilon trails' seed means within 0.2 of the JAX
package's, early reject auto off with the JAX package's reason and
bit-identical to off, History rows S wide at generation 0 and C' wide
after, the db read back by the JAX package's ``History``.

Each JAX run compiles its own kernels (a shared device context would carry
the first run's learned transform into the next): about ten seconds each.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import pyabc_tpu as jpt  # noqa: E402
from pyabc_tpu.models import sir as jsir  # noqa: E402
from pyabc_tpu.storage.history import History as JHistory  # noqa: E402
import pyabc_tpu_torch as tpt  # noqa: E402
from pyabc_tpu_torch.models import sir as tsir  # noqa: E402

from test_torch_sumstat_runs import (EPS_RTOL, MU_PAIR, SIR_SEEDS,  # noqa
                                     SIR_SHAPE, _arrays, _eps, _fits,
                                     _fp_run)

torch.set_num_threads(1)

FP_SEEDS = (31, 32)


def _fp_mlp(pkg):
    return pkg.PredictorSumstat(pkg.MLPPredictor(hidden=(16, 16),
                                                 n_steps=60))


@pytest.mark.parametrize("kind", ["PNormDistance", "AdaptivePNormDistance"])
def test_fearnhead_prangle_mlp_matches_jax(kind, monkeypatch):
    means = {jpt: [], tpt: []}
    for seed in FP_SEEDS:
        fits = {}
        for pkg in (jpt, tpt):
            seen = _fits(monkeypatch, pkg)
            dist = getattr(pkg, kind)(p=2, sumstat=_fp_mlp(pkg))
            h, mu = _fp_run(pkg, dist, seed=seed)
            assert h.n_populations == 8
            assert np.isfinite(mu)
            means[pkg].append(mu)
            fits[pkg] = ([1] + seen, dist.sumstat._last_fit_t)
            monkeypatch.undo()
        assert fits[tpt] == fits[jpt]
        assert fits[tpt][1] == fits[tpt][0][-1]
    assert abs(np.mean(means[tpt]) - np.mean(means[jpt])) < MU_PAIR


def _sir_mlp_run(pkg, seed, early="auto", db="sqlite://"):
    mod = jsir if pkg is jpt else tsir
    extra = {} if pkg is jpt else {"device": "cpu"}
    dist = pkg.PNormDistance(p=2, sumstat=pkg.PredictorSumstat(
        pkg.MLPPredictor(hidden=(8, 8), n_steps=100, seed=seed)))
    abc = pkg.ABCSMC(mod.make_network_sir_model(**SIR_SHAPE),
                     mod.network_sir_prior(), dist, population_size=256,
                     eps=pkg.MedianEpsilon(), seed=seed,
                     fused_generations=2, early_reject=early, **extra)
    abc.new(db, mod.observed_network_sir(**SIR_SHAPE))
    return abc, abc.run(max_nr_populations=4)


def test_network_sir_mlp_trails_match_jax():
    trails, ref = [], []
    for seed in SIR_SEEDS:
        _a, h = _sir_mlp_run(tpt, seed)
        _j, jh = _sir_mlp_run(jpt, seed)
        assert h.n_populations == jh.n_populations == 4
        trails.append(_eps(h))
        ref.append(_eps(jh))
    np.testing.assert_allclose(np.mean(trails, 0), np.mean(ref, 0),
                               rtol=EPS_RTOL)


@pytest.mark.parametrize("seed", SIR_SEEDS[:2])
def test_network_sir_mlp_early_reject_auto_is_off(seed, tmp_path):
    """No prefix bound under an MLP transform: early reject auto stays
    off with the JAX package's reason, and the run is bit-identical to
    early reject off; History rows raw at generation 0, learned after,
    read back by the JAX package; one counter read a round, one fetch a
    chunk (the CPU fit records no read)."""
    db = f"sqlite:///{tmp_path / 'sir.db'}"
    abc_on, h_on = _sir_mlp_run(tpt, seed, "auto", db)
    _abc, h_off = _sir_mlp_run(tpt, seed, False)
    assert h_on.n_populations == h_off.n_populations == 4
    a, b = _arrays(h_on), _arrays(h_off)
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    reasons = [f["reason"] for f in abc_on.capability_fallbacks]
    jabc = jpt.ABCSMC(jsir.make_network_sir_model(**SIR_SHAPE),
                      jsir.network_sir_prior(),
                      jpt.PNormDistance(p=2, sumstat=jpt.PredictorSumstat(
                          jpt.MLPPredictor(hidden=(8, 8)))),
                      population_size=256)
    jabc.new("sqlite://", jsir.observed_network_sir(**SIR_SHAPE))
    jreason = jabc._early_reject_incapable_reason(
        adaptive=False, stochastic=False, sumstat_mode=True,
        sharded_n=None)
    assert reasons == [jreason]
    assert "retired_early" not in h_on.get_telemetry(1)
    assert a["ss_0"].shape[1] == 16
    assert all(a[f"ss_{t}"].shape[1] == 2 for t in range(1, 4))
    tel = h_on.get_telemetry(0)["sumstat"]
    assert tel["kind"] == "mlp" and tel["dim_reduced"] == 2
    assert [t for t in range(4)
            if h_on.get_telemetry(t).get("sumstat_refit")] == [2, 3]
    jh = JHistory(db)
    assert jh.n_populations == 4
    np.testing.assert_array_equal(
        jh.get_weighted_distances(3)["distance"].to_numpy(), a["d_3"])
    by_kind = abc_on.sync_ledger.summary()["by_kind"]
    assert set(by_kind) == {"round_counters", "chunk_fetch"}
    assert by_kind["chunk_fetch"] == 3
