"""Port parity: K6 (the mask-and-refill compaction, and its record mode
for noisy ABC) against the JAX package's
``DeviceContext._generation_while``.

A deterministic JAX ``run_lanes`` makes the round outputs from
``fold_in(key, r)``; the JAX while-loop consumes them inside its trace and
the port's generation loop consumes the same rounds, computed eagerly,
through its plain compaction. Reservoir, record ring and counters must
agree exactly (the compaction moves values, it computes none).
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
from pyabc_tpu_torch import RV, Distribution  # noqa: E402
from pyabc_tpu_torch.core.sumstat_spec import SumStatSpec  # noqa: E402
from pyabc_tpu_torch.epsilon.temperature import TempConfig  # noqa: E402
from pyabc_tpu_torch.inference.context import DeviceContext  # noqa: E402
from pyabc_tpu_torch.kernels import compact_round  # noqa: E402

torch.set_num_threads(1)

B, D, S = 64, 2, 5


def _run_lanes(key, dyn):
    k = jax.random.split(key, 7)
    return {
        "logq": jax.random.normal(k[6], (B,)),
        "m": jnp.zeros((B,), jnp.int32),
        "theta": jax.random.normal(k[0], (B, D)),
        "sumstats": jax.random.normal(k[1], (B, S)),
        "distance": jax.random.uniform(k[2], (B,)),
        "accepted": jax.random.uniform(k[3], (B,)) < 0.7,
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


def _port_ctx(n_cap, rec_cap, max_rounds, record=False):
    prior = Distribution(a=RV("norm", 0, 1), b=RV("norm", 0, 1))
    # a noisy-ABC run (a temperature descriptor) keeps the record columns
    temp_config = TempConfig(schemes=(), max_np=-1, pdf_max=None, lin=False,
                             pdf_scaled=None, initial=("constant", 1.0))
    return DeviceContext(
        model=None, prior=prior, distance=None, acceptor=None,
        transition=None, spec=SumStatSpec({"s": np.zeros(S)}),
        x0=torch.zeros(S), device=torch.device("cpu"), generator=None, B=B,
        n_cap=n_cap, rec_cap=rec_cap, max_rounds=max_rounds,
        temp_config=temp_config if record else None)


@pytest.mark.parametrize("n_cap,n_target,rec_cap,max_rounds", [
    (64, 64, 128, 10),   # round 2 overflows the reservoir
    (128, 100, 96, 10),  # three rounds, the ring fills mid-round
    (128, 128, 256, 2),  # the round budget ends the generation
])
def test_compaction_matches_generation_while(n_cap, n_target, rec_cap,
                                             max_rounds):
    key = jax.random.key(11)
    n_acc, rounds, n_valid, res, rec = _jax_ctx()._generation_while(
        key, None, jnp.int32(n_target), B=B, n_cap=n_cap, rec_cap=rec_cap,
        max_rounds=max_rounds, run_lanes=_run_lanes)
    n_acc, rounds = int(n_acc), int(rounds)

    def lanes(r=iter(range(100))):
        out = _run_lanes(jax.random.fold_in(key, next(r)), None)
        return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}

    run = _port_ctx(n_cap, rec_cap, max_rounds).generation_while(
        lanes, n_target)
    assert (run.n_acc, run.rounds, run.n_valid) == (n_acc, rounds,
                                                   int(n_valid))
    if n_cap == 64:
        assert n_acc > n_cap  # lanes dropped past n_cap still count
    for k in ("theta", "sumstats", "distance", "log_weight", "slot"):
        np.testing.assert_array_equal(run.res[k].numpy(),
                                      np.asarray(res[k]), err_msg=k)
    for k in ("sumstats", "distance", "accepted", "valid"):
        np.testing.assert_array_equal(run.rec[k].numpy(),
                                      np.asarray(rec[k]), err_msg=k)


@pytest.mark.parametrize("n_cap,n_target,rec_cap,max_rounds", [
    (64, 64, 128, 10),   # round 2 overflows the reservoir
    (128, 100, 96, 10),  # three rounds, the ring fills mid-round
])
def test_record_mode_matches_generation_while(n_cap, n_target, rec_cap,
                                              max_rounds):
    """``record_proposal=True``: the ring also keeps each valid record's
    theta and proposal log-density, in slot order, exactly as the JAX
    ring; the plain columns are the same as without the mode."""
    key = jax.random.key(13)
    n_acc, rounds, n_valid, res, rec = _jax_ctx()._generation_while(
        key, None, jnp.int32(n_target), B=B, n_cap=n_cap, rec_cap=rec_cap,
        max_rounds=max_rounds, run_lanes=_run_lanes, record_proposal=True)

    def lanes(r=iter(range(100))):
        out = _run_lanes(jax.random.fold_in(key, next(r)), None)
        return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}

    run = _port_ctx(n_cap, rec_cap, max_rounds, record=True)\
        .generation_while(lanes, n_target)
    assert (run.n_acc, run.rounds, run.n_valid) == (int(n_acc), int(rounds),
                                                   int(n_valid))
    assert set(run.rec) == {"sumstats", "distance", "accepted", "valid",
                            "theta", "logq"}
    for k in ("theta", "logq", "sumstats", "distance", "accepted",
              "valid"):
        np.testing.assert_array_equal(run.rec[k].numpy(),
                                      np.asarray(rec[k]), err_msg=k)
    for k in ("theta", "sumstats", "distance", "log_weight", "slot"):
        np.testing.assert_array_equal(run.res[k].numpy(),
                                      np.asarray(res[k]), err_msg=k)


def test_record_mode_needs_the_round_logq():
    ctx = _port_ctx(64, 128, 4, record=True)
    res, rec = ctx.new_reservoir(), ctx.new_ring()
    out = {k: torch.from_numpy(np.array(v)) for k, v in
           _run_lanes(jax.random.key(1), None).items()}
    args = (out["accepted"], out["valid"], out["theta"], out["sumstats"],
            out["distance"], out["log_weight"], res, rec,
            torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="logq"):
        compact_round(*args)
    compact_round(*args, logq=out["logq"])
    assert bool(rec["valid"][:B].any())


def test_no_ring_when_rec_cap_is_zero():
    key = jax.random.key(2)

    def lanes(r=iter(range(10))):
        out = _run_lanes(jax.random.fold_in(key, next(r)), None)
        return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}

    run = _port_ctx(64, 0, 4).generation_while(lanes, 32)
    assert run.rec is None and run.rounds == 1
    assert int((run.res["slot"] >= 0).sum()) == min(run.n_acc, 64)


def test_generation_step_on_a_carry_from_jax():
    """State carried across with ``convert.carry`` from a JAX-shaped
    multigen carry, then one generation step on the compacted reservoir:
    the refit and the quantile epsilon match the JAX package's twins."""
    from pyabc_tpu.ops import stats as jstats
    from pyabc_tpu.transition import util as jutil
    from pyabc_tpu_torch import MedianEpsilon, MultivariateNormalTransition
    from pyabc_tpu_torch import PNormDistance, convert

    key = jax.random.key(5)
    n_cap, n_target = 64, 48
    rng = np.random.default_rng(0)
    th0 = rng.normal(size=(n_cap, D)).astype(np.float32)
    fit0 = jax.tree.map(np.asarray, jpt.MultivariateNormalTransition
                        .device_fit(jnp.asarray(th0),
                                    jnp.full(n_cap, 1.0 / n_cap), dim=D,
                                    scaling=1.0, bandwidth_selector=jutil
                                    .silverman_rule_of_thumb))
    jax_carry = ((fit0,), np.zeros(1, np.float32), np.array([True]),
                 np.ones(S, np.float32), np.float32(0.9),
                 (np.float32(np.inf), np.float32(-1e30), np.float32(0.0)),
                 np.array(False), (np.float32(np.inf), np.int32(0)))
    carry = convert.carry(jax_carry, device="cpu")
    assert bool(carry.fitted) and float(carry.eps) == np.float32(0.9)
    np.testing.assert_array_equal(carry.trans_params["prec"].numpy(),
                                  fit0["prec"])

    def lanes(r=iter(range(10))):
        out = _run_lanes(jax.random.fold_in(key, next(r)), None)
        return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}

    ctx = _port_ctx(n_cap, 0, 10)
    ctx.distance = PNormDistance(p=2)
    ctx.transition = MultivariateNormalTransition()
    run = ctx.generation_while(lanes, n_target)
    nxt, out = ctx.generation_step(
        carry, run, n_target=n_target, adaptive=False, eps_quantile=True,
        eps_weighted=True, alpha=0.5, multiplier=1.0,
        fit_statics=ctx.transition.fit_statics(),
        health_config=(0.0, 0.0, 16, 1e-6))
    res = {k: jnp.asarray(v.numpy()) for k, v in run.res.items()}
    k_mask = jnp.arange(n_cap) < min(run.n_acc, n_target)
    w = jstats.normalize_log_weights(res["log_weight"], k_mask)
    ref_eps = jstats.weighted_quantile(
        jnp.where(k_mask, res["distance"], jnp.inf),
        jnp.where(k_mask, w, 0.0), 0.5)
    assert float(nxt.eps) == float(ref_eps)
    ref_fit = jpt.MultivariateNormalTransition.device_fit(
        res["theta"], w, dim=D, scaling=1.0,
        bandwidth_selector=jutil.silverman_rule_of_thumb)
    # float32 moments in another summation order: rtol 1e-4
    for k in ("chol", "prec", "logdet", "quad"):
        np.testing.assert_allclose(nxt.trans_params[k].numpy(),
                                   np.asarray(ref_fit[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    assert int(out["health"]) == 0 and float(out["eps_used"]) == \
        np.float32(0.9)
    assert MedianEpsilon().requires_calibration()
