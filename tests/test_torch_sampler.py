"""The port's ``BatchedSampler`` and Sample containers
(``pyabc_tpu_torch/sampler``) against the JAX package's
(``pyabc_tpu/sampler``) on the same numpy inputs, exactly: B's sizing, the
two finalizations (per-round and fused, with records and a speculative
round's lanes), the slot-ordered trim, and the record ring's one counted
fetch.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from pyabc_tpu.inference.util import RoundResult as JRound  # noqa: E402
from pyabc_tpu.sampler import base as jbase  # noqa: E402
from pyabc_tpu.sampler.batched import BatchedSampler as JSampler  # noqa: E402
from pyabc_tpu_torch.inference.context import RoundResult  # noqa: E402
from pyabc_tpu_torch.observability.sync import SyncLedger  # noqa: E402
from pyabc_tpu_torch.sampler import (BatchedSampler, DeviceRecords,  # noqa
                                     Sample, exp_normalize_log_weights)

torch.set_num_threads(1)

SAMPLE_KEYS = ("ms", "thetas", "weights", "distances", "sumstats",
               "proposal_ids")


def _same_sample(a, b, records=False):
    for k in SAMPLE_KEYS:
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)
    if records:
        for k in ("all_sumstats", "all_distances", "all_accepted"):
            va, vb = getattr(a, k), getattr(b, k)
            assert (va is None) == (vb is None), k
            if va is not None:
                np.testing.assert_array_equal(va, vb, err_msg=k)


@pytest.mark.parametrize("case", [
    # (n, carried rate or None, the last B or None, min_batch, max_batch)
    (100, None, None, 256, 1 << 17), (1000, None, None, 256, 1 << 17),
    (1000, 0.5, 2048, 256, 1 << 17), (1000, 0.01, 2048, 256, 1 << 17),
    (1000, 0.001, 2048, 256, 1 << 17), (16384, 0.2, None, 256, 1 << 17),
    (16384, 0.002, 4096, 256, 1 << 17), (50, 0.9, 65536, 256, 1 << 17),
    (500, 0.3, 256, 64, 1024), (10 ** 6, 0.05, None, 256, 1 << 17)])
def test_pick_B_matches_jax(case):
    n, rate, last, lo, hi = case
    port, ref = BatchedSampler(lo, hi), JSampler(lo, hi)
    for s in (port, ref):
        s._rate_estimate, s._last_B = rate, last
    assert port._pick_B(n) == ref._pick_B(n)
    assert port._last_B == ref._last_B
    # a second call, after the hysteresis moved or kept B
    assert port._pick_B(n // 3 + 1) == ref._pick_B(n // 3 + 1)


def _rounds(seed, Bs, d=3, S=4, with_logq=True):
    rng = np.random.default_rng(seed)
    port, ref, base = [], [], 0
    for B in Bs:
        valid = rng.random(B) < 0.9
        arrs = dict(
            ms=rng.integers(0, 2, B).astype(np.int32),
            thetas=rng.normal(size=(B, d)),
            sumstats=rng.normal(size=(B, S)),
            distances=rng.random(B),
            accepted=(rng.random(B) < 0.3) & valid, valid=valid,
            log_weights=np.where(valid, rng.normal(size=B), -np.inf),
            logqs=rng.normal(size=B) if with_logq else None)
        for out, cls in ((port, RoundResult), (ref, JRound)):
            r = cls(**{k: (None if v is None else v.copy())
                       for k, v in arrs.items()})
            r.slot_ids = base + np.arange(B)
            out.append(r)
        base += B
    return port, ref


@pytest.mark.parametrize("record", [False, True])
@pytest.mark.parametrize("n", [5, 60, 10 ** 4])
def test_finalize_rounds_matches_jax(record, n):
    port_rounds, jax_rounds = _rounds(1, [64, 64, 128, 256])
    ps, js = BatchedSampler(), JSampler()
    for s in (ps, js):
        s.sample_factory.record_rejected = record
    acc = np.concatenate([c.accepted for c in port_rounds])
    a = ps._finalize_rounds(ps.sample_factory(), port_rounds, acc, n)
    b = js._finalize_rounds(js.sample_factory(), jax_rounds, acc.copy(), n)
    _same_sample(a, b, records=record)


def _fused_out(seed, n_cap=128, rec_cap=512, d=2, S=3, n_acc=100):
    rng = np.random.default_rng(seed)
    lw = rng.normal(size=n_cap)
    lw[n_acc:] = -np.inf
    slots = np.sort(rng.choice(10 ** 4, n_cap, replace=False))
    return {"n_acc": n_acc, "rounds": 3, "n_valid": 700,
            "m": rng.integers(0, 2, n_cap).astype(np.int32),
            "theta": rng.normal(size=(n_cap, d)).astype(np.float32),
            "sumstats": rng.normal(size=(n_cap, S)).astype(np.float32),
            "distance": rng.random(n_cap).astype(np.float32),
            "log_weight": lw.astype(np.float32),
            "slot": slots.astype(np.int32),
            "rec_distance": rng.random(rec_cap).astype(np.float32),
            "rec_accepted": rng.random(rec_cap) < 0.2,
            "rec_valid": rng.random(rec_cap) < 0.8,
            "rec_scale": rng.random(S).astype(np.float32)}


def _spec_block(seed, B=64, d=2, S=3):
    rng = np.random.default_rng(seed)
    idx = np.sort(rng.choice(B, 9, replace=False))
    valid = rng.random(B) < 0.9
    return {"ms": rng.integers(0, 2, 9).astype(np.int32),
            "thetas": rng.normal(size=(9, d)),
            "sumstats": rng.normal(size=(9, S)),
            "distances": rng.random(9), "log_weights": rng.normal(size=9),
            "slots": idx - B, "n_valid": int(valid.sum()),
            "records": {"distances": rng.random(B),
                        "accepted": rng.random(B) < 0.3, "valid": valid}}


@pytest.mark.parametrize("record", [False, True])
@pytest.mark.parametrize("spec", [False, True])
@pytest.mark.parametrize("n", [50, 100, 128])
def test_finalize_fused_matches_jax(record, spec, n):
    """The same collected arrays (a ring left on the device, a speculative
    round's accepted lanes first) give the same Sample and the same
    carried acceptance rate."""
    out = _fused_out(2)
    blk = _spec_block(3) if spec else None
    ps, js = BatchedSampler(), JSampler()
    ss_ring = np.random.default_rng(4).normal(size=(512, 3)).astype(
        np.float32)
    samples = []
    for s, dev in ((ps, torch.from_numpy(ss_ring)), (js, ss_ring)):
        s.sample_factory.record_rejected = record
        host = dict(out, rec_sumstats_dev=dev,
                    rec_valid_dev=(torch.from_numpy(out["rec_valid"])
                                   if s is ps else out["rec_valid"]))
        samples.append(s._finalize_fused(
            host, s.sample_factory(), n, 128,
            spec=None if blk is None else {k: (v.copy() if isinstance(
                v, np.ndarray) else v) for k, v in blk.items()}))
    a, b = samples
    _same_sample(a, b)
    assert ps.nr_evaluations_ == js.nr_evaluations_
    assert ps._rate_estimate == js._rate_estimate
    if record:
        np.testing.assert_array_equal(a.all_distances, b.all_distances)
        np.testing.assert_array_equal(a.all_accepted, b.all_accepted)
        np.testing.assert_array_equal(a.device_records.scale,
                                      b.device_records.scale)
        np.testing.assert_array_equal(a.device_records.to_host(),
                                      np.asarray(b.device_records.to_host()))


def test_trim_keeps_the_first_n_by_slot():
    rng = np.random.default_rng(5)
    n = 40
    slots = rng.permutation(200)[:90] - 30  # speculative lanes negative
    arrs = dict(ms=rng.integers(0, 3, 90), thetas=rng.normal(size=(90, 2)),
                weights=rng.random(90), distances=rng.random(90),
                sumstats=rng.normal(size=(90, 4)), proposal_ids=slots)
    a, b = Sample(), jbase.Sample()
    for s in (a, b):
        s.set_accepted(**{k: v.copy() for k, v in arrs.items()})
        s.trim(n)
    _same_sample(a, b)
    assert a.n_accepted == n
    np.testing.assert_array_equal(a.proposal_ids, np.sort(slots)[:n])


def test_exp_normalize_log_weights_matches_jax():
    for lw in (np.array([0.0, -1.0, -np.inf, 2.5]), np.full(4, -np.inf),
               np.random.default_rng(6).normal(size=100) * 30):
        np.testing.assert_array_equal(exp_normalize_log_weights(lw),
                                      jbase.exp_normalize_log_weights(lw))


def test_device_records_count_one_fetch():
    """The ring's rows reach the host once, masked, recorded in the run's
    ledger as ``records_fetch``; later reads reuse them."""
    ledger = SyncLedger()
    ss = torch.arange(24, dtype=torch.float32).reshape(8, 3)
    valid = torch.tensor([1, 0, 1, 1, 0, 0, 1, 1], dtype=torch.bool)
    rec = DeviceRecords(ss, valid, sync_ledger=ledger)
    host = rec.to_host()
    np.testing.assert_array_equal(host, ss.numpy()[valid.numpy()])
    assert host.dtype == np.float64
    assert np.asarray(rec).shape == rec.shape == (5, 3)
    assert ledger.summary()["by_kind"] == {"records_fetch": 1}
    assert ledger.summary()["bytes"]["records_fetch"] == 8 * 3 * 4 + 8
