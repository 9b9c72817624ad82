"""LocalTransition under segmented early reject on the CPU.

The JAX package's early-reject gate names no transition
(``pyabc_tpu/inference/smc.py::_early_reject_incapable_reason``), and its
segmented sweep draws through the generic lane; the port's K18 takes the
simulator's place after K2's local mode and K14 have proposed and scored
the round. So early reject on and off run the same proposals: under a
fixed p-norm (one model and the K = 2 birth-death pair) and in K18's
stochastic mode the populations (thetas, weights, distances, models) are
bit-identical. Under a moment-adaptive distance the refit reads every
resolved candidate's simulated columns with early reject on and the record
ring with it off (K22 against K9), so, as on the MVN path
(``tests/test_torch_seg_adaptive.py``), on and off share generation 0's
bits and agree in law after it. The port's on-runs sit beside the JAX
package's on-runs over four seeds (posterior means within 0.15: a seed's
mean moves by about 0.12 in log_b, so a 4-seed mean by about 0.06).
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import pyabc_tpu as jpt  # noqa: E402
from pyabc_tpu.models import gillespie as jg  # noqa: E402
import pyabc_tpu_torch as tpt  # noqa: E402
from pyabc_tpu_torch.distance import scale as tscale  # noqa: E402
from pyabc_tpu_torch.epsilon.temperature import (  # noqa: E402
    ExpDecayFixedIterScheme)
from pyabc_tpu_torch.models import gillespie as tg  # noqa: E402

torch.set_num_threads(1)

SMALL = dict(n_leaps=100, n_obs=20)
SEEDS = (1, 2, 3, 4)
MEAN_ATOL = 0.15


def _obs():
    return {k: np.asarray(v) for k, v in jg.observed_birth_death(
        segments=5, **SMALL).items()}


def _bd(x0=None):
    kw = {} if x0 is None else {"x0": x0, "name": f"bd{int(x0)}"}
    return tg.make_birth_death_model(segments=5, **SMALL, **kw)


def _run(case, early, seed=3, pop=64, gens=4):
    K = 2 if case == "pair" else 1
    models = [_bd(), _bd(25.0)] if K == 2 else _bd()
    priors = [tg.birth_death_prior()] * 2 if K == 2 else \
        tg.birth_death_prior()
    transitions = ([tpt.LocalTransition(), tpt.LocalTransition()] if K == 2
                   else tpt.LocalTransition())
    kw = dict(population_size=pop, seed=seed, early_reject=early,
              fused_generations=2, transitions=transitions, device="cpu")
    if case == "stochastic":
        kw.update(eps=tpt.Temperature(schemes=[ExpDecayFixedIterScheme()],
                                      initial_temperature=50.0),
                  acceptor=tpt.StochasticAcceptor(
                      pdf_norm_method=tpt.ScaledPDFNorm()))
        distance = tpt.IndependentNormalKernel(var=4.0)
    elif case == "adaptive":
        kw["eps"] = tpt.MedianEpsilon()
        distance = tpt.AdaptivePNormDistance(
            p=2, scale_function=tscale.standard_deviation)
    else:
        kw["eps"] = tpt.MedianEpsilon()
        distance = tpt.PNormDistance(p=2)
    abc = tpt.ABCSMC(models, priors, distance, **kw)
    abc.new("sqlite://", _obs())
    return abc, abc.run(max_nr_populations=gens)


def _same_generation(h_on, h_off, t, K):
    for m in range(K):
        if K > 1:
            p_on = h_on.get_model_probabilities(t)["p"]
            p_off = h_off.get_model_probabilities(t)["p"]
            np.testing.assert_array_equal(p_on.to_numpy(), p_off.to_numpy())
            if float(p_on.get(m, 0.0)) == 0.0:
                continue
        a, wa = h_on.get_distribution(m=m, t=t)
        b, wb = h_off.get_distribution(m=m, t=t)
        np.testing.assert_array_equal(a.to_numpy(), b.to_numpy())
        np.testing.assert_array_equal(wa, wb)
    d_on = h_on.get_weighted_distances(t)["distance"].to_numpy()
    d_off = h_off.get_weighted_distances(t)["distance"].to_numpy()
    np.testing.assert_array_equal(d_on, d_off)


@pytest.mark.parametrize("case", ["pnorm", "pair", "stochastic"])
def test_on_and_off_are_bit_identical(case):
    """One birth-death model, the K = 2 pair (initial counts 40 and 25)
    and K18's stochastic mode, each with LocalTransitions: every
    generation's thetas, weights, distances and models bit-identical, the
    same rounds, slots retired with early reject on."""
    (abc_on, h_on), (_abc_off, h_off) = (_run(case, "auto"),
                                         _run(case, False))
    K = 2 if case == "pair" else 1
    assert h_on.max_t == h_off.max_t >= 2
    retired = 0
    for t in range(h_on.max_t + 1):
        _same_generation(h_on, h_off, t, K)
        tel_on, tel_off = h_on.get_telemetry(t), h_off.get_telemetry(t)
        assert tel_on["rounds"] == tel_off["rounds"]
        assert "retired_early" not in tel_off
        retired += tel_on["retired_early"]
    assert retired > 0
    if case == "stochastic":
        assert (h_on.get_all_populations()["epsilon"].to_numpy().tolist()
                == h_off.get_all_populations()["epsilon"].to_numpy()
                .tolist())


def test_moment_adaptive_distance_agrees_in_law():
    """Under AdaptivePNormDistance(standard_deviation): generation 0 is
    bit-identical (the calibration and the first rounds are the same), the
    weights refit from K22's moment block with early reject on, and the
    4-seed posterior means on and off within MEAN_ATOL."""
    on, off = [], []
    for seed in SEEDS:
        abc_on, h_on = _run("adaptive", "auto", seed=seed, pop=128, gens=4)
        _abc, h_off = _run("adaptive", False, seed=seed, pop=128, gens=4)
        _same_generation(h_on, h_off, 0, 1)
        assert sum(h_on.get_telemetry(t)["retired_early"]
                   for t in range(4)) > 0
        w = abc_on.distance_function.weights
        assert all(np.all(np.isfinite(w[t])) for t in range(1, 5))
        on.append(_post_mean(h_on))
        off.append(_post_mean(h_off))
    assert np.abs(np.mean(on, 0) - np.mean(off, 0)).max() < MEAN_ATOL


def _post_mean(h):
    df, w = h.get_distribution(m=0, t=h.max_t)
    return (np.asarray(df) * np.asarray(w)[:, None]).sum(axis=0)


def test_on_runs_sit_beside_the_jax_on_runs():
    """Four seeds (pop 128, 4 generations) of one birth-death model with a
    LocalTransition and early reject on, in both packages (the JAX runs
    share one device context): posterior means within MEAN_ATOL."""
    port = [_post_mean(_run("pnorm", "auto", seed=s, pop=128)[1])
            for s in SEEDS]
    jax_means, jctx = [], None
    for seed in SEEDS:
        jabc = jpt.ABCSMC(
            jg.make_birth_death_model(segments=5, **SMALL),
            jg.birth_death_prior(), jpt.PNormDistance(p=2),
            population_size=128, eps=jpt.MedianEpsilon(), seed=seed,
            early_reject="auto", fused_generations=2,
            transitions=jpt.LocalTransition())
        jabc.new("sqlite://", _obs())
        if jctx is not None:
            jabc._device_ctx = jctx
        h = jabc.run(max_nr_populations=4)
        jctx = jabc._device_ctx
        assert sum(h.get_telemetry(t).get("retired_early", 0)
                   for t in range(4)) > 0
        jax_means.append(_post_mean(h))
    assert np.abs(np.mean(port, 0) - np.mean(jax_means, 0)).max() \
        < MEAN_ATOL


def test_unserved_modes_keep_the_mvn_paths_refusal():
    """A segmented run the port's engine does not serve raises as it does
    with the MVN transition (here a sharded run, item 13)."""
    with pytest.raises(NotImplementedError,
                       match="segmented early reject in a sharded run.*13"):
        tpt.ABCSMC(_bd(), tg.birth_death_prior(), tpt.PNormDistance(p=2),
                   transitions=tpt.LocalTransition(), sharded=8,
                   device="cpu")
