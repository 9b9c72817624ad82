"""Segmented early reject under an adaptive distance: K22's plain fold and
finish, K18's per-slot segment count and whole runs against the JAX
package on the CPU.

Under retirement the JAX engine refits the scale over every resolved
candidate's simulated columns (a retired candidate's prefix), folded into a
``(6, S)`` moment block while the generation runs, and finishes the weights
from that block. The port does the same (K18's ``nseg``, K22), so with
early reject on and off the posteriors agree in law, not in bits, and the
port's on-run agrees with the JAX package's on-run.
"""
import math
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import pyabc_tpu as jpt  # noqa: E402
from pyabc_tpu.distance.scale import (  # noqa: E402
    standard_deviation as j_standard_deviation)
from pyabc_tpu.models import gillespie as jg  # noqa: E402
from pyabc_tpu.ops import scale_reduce as jsr  # noqa: E402
import pyabc_tpu_torch as tpt  # noqa: E402
from pyabc_tpu_torch.core.sumstat_spec import SumStatSpec  # noqa: E402
from pyabc_tpu_torch.distance import scale as tscale  # noqa: E402
from pyabc_tpu_torch.kernels import philox  # noqa: E402
from pyabc_tpu_torch.kernels.moments import (  # noqa: E402
    SCALE_NAMES, moment_finish, moment_fold, seg_of_columns)
from pyabc_tpu_torch.kernels.segment_round import (  # noqa: E402
    bound_limit, segment_round)
from pyabc_tpu_torch.models import gillespie as tg  # noqa: E402
from pyabc_tpu_torch.ops import scale_reduce as tsr  # noqa: E402

torch.set_num_threads(1)

SMALL = dict(n_leaps=100, n_obs=20)
SEEDS = (1, 2, 3, 4)
#: sums run in another order than XLA's
SUM_RTOL = 1e-5
#: tolerance on 4-seed posterior means (pop 128, 5 generations): the JAX
#: package's own runs at seeds 1-4 (early reject on and off, on its
#: observation) spread with a per-seed sd of about 0.12 in log_b (one
#: off-run alone moved 0.35), so a 4-seed mean carries a standard error of
#: about 0.06 and 0.1 is under two of them. Its one-seed cell
#: (tests/test_segment.py::test_adaptive_early_reject_posterior_parity,
#: atol 0.15) is red on this tree: on and off are 0.196 apart at seed 5.
MEAN_ATOL = 0.1


# ------------------------------------------------------------ K22 plain
def _fold_inputs(seed: int, B: int = 96, n_seg: int = 5, seg_size: int = 4):
    """One round's inputs, made with numpy: a permuted emission map, each
    slot's simulated segment count, validity, and statistics whose columns
    a slot did not simulate hold NaN (they must not be read)."""
    rng = np.random.default_rng(seed)
    S = n_seg * seg_size
    imap = rng.permutation(S).reshape(n_seg, seg_size).astype(np.int32)
    nseg = rng.integers(1, n_seg + 1, B).astype(np.int32)
    valid = rng.random(B) > 0.15
    x0 = rng.normal(2.0, 1.0, S).astype(np.float32)
    ss = rng.normal(3.0, 2.0, (B, S)).astype(np.float32)
    seg_of = seg_of_columns(imap)
    ss[seg_of[None, :] >= nseg[:, None]] = np.nan
    return imap, nseg, valid, x0, ss


def _jax_take(imap, nseg, valid, round_idx, B, rec_cap):
    """The JAX engine's per-column take (util.py:1139-1157): dense_pos
    from the emission map, the simulated segments, the record window."""
    n_seg, seg_size = imap.shape
    S = n_seg * seg_size
    dense_pos = np.empty(S, np.int32)
    for j in range(n_seg):
        dense_pos[imap[j]] = j * seg_size + np.arange(seg_size)
    seg_done = np.arange(n_seg)[None, :] < nseg[:, None]
    col_mask = np.broadcast_to(seg_done[:, :, None], (B, n_seg, seg_size)
                               ).reshape(B, S)[:, dense_pos]
    slot = round_idx * B + np.arange(B)
    return (valid & (slot < rec_cap))[:, None] & col_mask


def _fold_both(rounds: int, rec_cap: int, seed: int = 0):
    """Fold ``rounds`` rounds into one block in both packages."""
    mom_j = jsr.init_moments(20)
    mom_t = tsr.init_moments(20)
    counters = torch.zeros(4, dtype=torch.int32)
    for r in range(rounds):
        imap, nseg, valid, x0, ss = _fold_inputs(seed + r)
        B = ss.shape[0]
        take = _jax_take(imap, nseg, valid, r, B, rec_cap)
        mom_j = jsr.accumulate_moments(mom_j, jnp.asarray(ss),
                                       jnp.asarray(take), jnp.asarray(x0))
        counters[1] = r
        moment_fold(mom_t, torch.from_numpy(ss), torch.from_numpy(nseg),
                    torch.from_numpy(valid),
                    torch.from_numpy(seg_of_columns(imap)),
                    torch.from_numpy(x0), counters, rec_cap=rec_cap)
    return np.asarray(mom_j), mom_t.numpy(), x0


def _assert_moments_close(got, ref):
    np.testing.assert_allclose(got[:3], ref[:3], rtol=SUM_RTOL, atol=1e-4)
    np.testing.assert_array_equal(got[3:], ref[3:])


@pytest.mark.parametrize("rounds,rec_cap", [(1, 1000), (2, 150)])
def test_fold_matches_jax(rounds, rec_cap):
    """One round, and two rounds with the record window cut inside the
    second: the block equals the JAX package's (counts and extrema
    exactly, sums within SUM_RTOL)."""
    ref, got, _x0 = _fold_both(rounds, rec_cap)
    assert np.all(np.isfinite(ref[:4]))
    _assert_moments_close(got, ref)
    if rounds == 2:
        # the window cut the second round: fewer counts than all valid
        assert ref[3].max() < 2 * 96


def test_combine_matches_jax():
    """Blocks folded apart and combined equal the JAX combine."""
    parts_j, parts_t = [], []
    for seed in (3, 4, 5):
        ref, got, _x0 = _fold_both(1, 1000, seed=seed)
        parts_j.append(ref)
        parts_t.append(torch.from_numpy(got))
    ref = np.asarray(jsr.combine_moments(jnp.asarray(np.stack(parts_j))))
    got = tsr.combine_moments(torch.stack(parts_t)).numpy()
    _assert_moments_close(got, ref)


@pytest.mark.parametrize("name", SCALE_NAMES)
def test_finish_matches_jax(name):
    """The scale of every moment name against ``scale_from_moments``,
    the weights against ``device_weight_update`` (with a ratio clip) and
    the recomputed distances against the p-norm under those weights."""
    ref_mom, mom, x0 = _fold_both(2, 150)
    scale_j = np.asarray(jsr.scale_from_moments(name)(
        jnp.asarray(ref_mom), jnp.asarray(x0)))
    jd = jpt.AdaptivePNormDistance(
        p=2, scale_function=getattr(jpt.distance.scale, name),
        max_weight_ratio=5.0)
    w_j = np.asarray(jd.device_weight_update()(jnp.asarray(scale_j)))
    rows = np.random.default_rng(9).normal(3.0, 2.0, (33, 20)).astype(
        np.float32)
    scale, w, d = moment_finish(
        torch.from_numpy(mom), torch.from_numpy(x0), scale_name=name,
        max_weight_ratio=5.0, rows=torch.from_numpy(rows), p=2.0)
    np.testing.assert_allclose(scale.numpy(), scale_j, rtol=SUM_RTOL,
                               atol=1e-6)
    np.testing.assert_allclose(w.numpy(), w_j, rtol=SUM_RTOL)
    d_ref = np.sqrt(((w_j * np.abs(rows - x0)) ** 2).sum(1))
    np.testing.assert_allclose(d.numpy(), d_ref, rtol=SUM_RTOL)


def test_moment_names_are_the_jax_packages():
    assert set(SCALE_NAMES) == jsr.SHARDED_SCALE_NAMES
    assert tsr.SHARDED_SCALE_NAMES == jsr.SHARDED_SCALE_NAMES


# ---------------------------------------------------------- K18's nseg
def test_nseg_replays_the_bound():
    """K18's plain ``nseg`` equals a step-by-step replay of the prefix
    bound over the full trajectory: the first segment after which the slot
    is invalid or its bound exceeds the threshold, + 1, else n_seg."""
    model = tg.make_birth_death_model(segments=5, **SMALL)
    spec = SumStatSpec({"x": np.zeros(20)})
    B = 256
    gen = torch.Generator()
    gen.manual_seed(8)
    theta = tg.birth_death_prior().rvs_array(B, gen, torch.device("cpu"))
    valid = torch.rand(B, generator=gen) > 0.1
    st = philox.PhiloxStream(3, 2, philox.SIM_NOISE, 8,
                             torch.zeros(4, dtype=torch.int32))
    x0 = torch.tensor(np.asarray(jg.observed_birth_death(
        segments=5, **SMALL)["x"], np.float32))
    w = torch.linspace(0.5, 1.5, 20)
    imap = model.index_map(spec, "cpu")
    full = model.simulate_flat(theta, gen, spec, stream=st)
    dist = tpt.PNormDistance(p=2)
    eps = torch.quantile(dist.rows(full, x0, w), 0.3)
    ss, keep, nseg = segment_round(
        model.segmented, theta, valid, st, imap=imap, x0=x0, w=w, p=2.0,
        eps=eps, width=20, seg_ctr=torch.zeros(4, dtype=torch.int64),
        return_nseg=True)
    bound = dist.device_bound_fn(spec)
    lim = bound_limit(eps, 2.0)
    want = np.full(B, 5, np.int32)
    for b in range(B):
        acc = bound["init"](1)
        for j in range(5):
            cols = imap[j].long()
            acc = bound["step"](acc, full[b:b + 1, cols], cols, x0, w)
            if j < 4 and (not bool(valid[b]) or bool(acc[0] > lim)):
                want[b] = j + 1
                break
    np.testing.assert_array_equal(nseg.numpy(), want)
    assert torch.equal(keep, valid & (nseg == 5))
    assert (want < 5).any() and (want == 5).any()
    done = nseg.long()[:, None] > torch.as_tensor(seg_of_columns(imap))
    assert torch.equal(ss[done], full[done])


# ---------------------------------------------------------- whole runs
def _jax_obs():
    return {k: np.asarray(v) for k, v in jg.observed_birth_death(
        segments=5, **SMALL).items()}


def _post_mean(h):
    df, w = h.get_distribution(m=0, t=h.max_t)
    return (np.asarray(df) * np.asarray(w)[:, None]).sum(axis=0)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port on and off and the JAX package on, seeds 1-4 (pop 128, 5
    generations, G 4, the JAX observation); the JAX runs share one device
    context (one compile)."""
    obs = _jax_obs()
    out = {"on": [], "off": [], "jax": [], "abc_on": [], "dbs": []}
    for seed in SEEDS:
        for early in ("auto", False):
            db = "sqlite:///" + str(tmp_path_factory.mktemp("ad") / "p.db")
            abc = tpt.ABCSMC(
                tg.make_birth_death_model(segments=5, **SMALL),
                tg.birth_death_prior(),
                tpt.AdaptivePNormDistance(
                    p=2, scale_function=tscale.standard_deviation),
                population_size=128, eps=tpt.MedianEpsilon(), seed=seed,
                early_reject=early, fused_generations=4, device="cpu")
            abc.new(db, obs)
            h = abc.run(max_nr_populations=5)
            out["on" if early else "off"].append(h)
            if early:
                out["abc_on"].append(abc)
                out["dbs"].append(db)
    jctx = None
    for seed in SEEDS:
        jabc = jpt.ABCSMC(
            jg.make_birth_death_model(segments=5, **SMALL),
            jg.birth_death_prior(),
            jpt.AdaptivePNormDistance(
                p=2, scale_function=j_standard_deviation),
            population_size=128, eps=jpt.MedianEpsilon(), seed=seed,
            early_reject="auto", fused_generations=4)
        jabc.new("sqlite://", obs)
        if jctx is not None:
            jabc._device_ctx = jctx
        out["jax"].append(jabc.run(max_nr_populations=5))
        jctx = jabc._device_ctx
    return out


def test_early_reject_retires_and_resolves(runs):
    for h_on, h_off in zip(runs["on"], runs["off"]):
        assert h_on.max_t == h_off.max_t == 4
        retired = 0
        for t in range(5):
            tel_on, tel_off = h_on.get_telemetry(t), h_off.get_telemetry(t)
            assert "retired_early" not in tel_off
            # whole rounds of pick_batch(128) = 512 slots resolve
            assert tel_on["seg_resolved"] == tel_on["rounds"] * 512
            assert 0.0 < tel_on["segment_occupancy"] <= 1.0
            retired += tel_on["retired_early"]
        assert retired > 0


def test_posterior_on_matches_off_and_jax(runs):
    """4-seed posterior means: the port on against the port off, and the
    port on against the JAX package on, within MEAN_ATOL."""
    on = np.mean([_post_mean(h) for h in runs["on"]], axis=0)
    off = np.mean([_post_mean(h) for h in runs["off"]], axis=0)
    jax_on = np.mean([_post_mean(h) for h in runs["jax"]], axis=0)
    assert np.abs(on - off).max() < MEAN_ATOL, (on, off)
    assert np.abs(on - jax_on).max() < MEAN_ATOL, (on, jax_on)


def test_adaptive_weights_refit_each_generation(runs):
    """Every generation refits its weights from the moment block: no two
    consecutive generations share weights, and all stay finite and mean
    1."""
    for abc in runs["abc_on"]:
        w = abc.distance_function.weights
        assert sorted(w) == list(range(6))
        for t in range(1, 6):
            assert np.all(np.isfinite(w[t]))
            np.testing.assert_allclose(w[t].mean(), 1.0, rtol=1e-5)
            assert not np.allclose(w[t], w[t - 1])


def test_fold_runs_only_below_the_window(monkeypatch):
    """The host launches K22's fold only for rounds that start below
    ``rec_cap`` (it knows the round from its per-round counter read):
    each generation folds rounds 0, 1, ... up to min(its rounds,
    ceil(rec_cap / B)), and later rounds, which the window would empty,
    launch nothing."""
    from pyabc_tpu_torch.inference import context

    calls = []

    def counting_fold(mom, ss, nseg, valid, seg_of, x0, counters, *,
                      rec_cap):
        calls.append((int(counters[1]), ss.shape[0], rec_cap))
        return moment_fold(mom, ss, nseg, valid, seg_of, x0, counters,
                           rec_cap=rec_cap)

    monkeypatch.setattr(context, "moment_fold", counting_fold)
    abc = tpt.ABCSMC(
        tg.make_birth_death_model(segments=5, **SMALL),
        tg.birth_death_prior(),
        tpt.AdaptivePNormDistance(
            p=2, scale_function=tscale.standard_deviation),
        population_size=128, eps=tpt.MedianEpsilon(), seed=1,
        early_reject="auto", fused_generations=4, device="cpu")
    abc.new("sqlite://", _jax_obs())
    h = abc.run(max_nr_populations=8)
    B, rec_cap = calls[0][1], calls[0][2]
    per_gen = math.ceil(rec_cap / B)
    rounds = [h.get_telemetry(t)["rounds"] for t in range(h.max_t + 1)]
    expected = [r for n in rounds for r in range(min(n, per_gen))]
    assert [c[0] for c in calls] == expected
    assert all(r * B < rec_cap for r, _, _ in calls)
    # the late generations run past the window (B 512, rec_cap 1024)
    assert max(rounds) > per_gen, (B, rec_cap, rounds)


def test_history_opens_in_the_jax_package(runs):
    db, h = runs["dbs"][0], runs["on"][0]
    jh = jpt.History(db)
    assert jh.max_t == h.max_t == 4
    np.testing.assert_array_equal(jh.get_all_populations()["epsilon"],
                                  h.get_all_populations()["epsilon"])
    for t in range(5):
        df_j, w_j = jh.get_distribution(0, t)
        df_t, w_t = h.get_distribution(0, t)
        np.testing.assert_array_equal(df_j.to_numpy(), df_t.to_numpy())
        np.testing.assert_allclose(w_j, w_t, rtol=1e-12)
        assert jh.get_telemetry(t)["retired_early"] >= 0
    assert math.isfinite(float(jh.get_all_populations()["epsilon"].iloc[-1]))
