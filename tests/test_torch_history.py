"""Port parity: a History database written by the port opens in the JAX
package's ``pyabc_tpu.History`` with the same populations, weights and
epsilons."""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import pyabc_tpu as jpt  # noqa: E402
import pyabc_tpu_torch as tpt  # noqa: E402
from pyabc_tpu_torch.models import gaussian  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    db = "sqlite:///" + str(tmp_path_factory.mktemp("hist") / "port.db")
    abc = tpt.ABCSMC(gaussian.make_gaussian_model(), gaussian.default_prior(),
                     tpt.PNormDistance(p=2), population_size=64,
                     eps=tpt.MedianEpsilon(), seed=0, device="cpu",
                     fused_generations=2)
    abc.new(db, {"mean": np.float32(0.4), "std": np.float32(1.1)},
            gt_par={"mu": 0.4, "sigma": 1.1}, meta_info={"who": "port"})
    return db, abc.run(max_nr_populations=3)


def test_jax_history_reads_port_db(port_run):
    db, h = port_run
    jh = jpt.History(db)
    assert jh.id == h.id and jh.max_t == h.max_t == 2
    assert jh.n_populations == 3
    ours, theirs = h.get_all_populations(), jh.get_all_populations()
    np.testing.assert_array_equal(theirs["t"], ours["t"])
    np.testing.assert_array_equal(theirs["samples"], ours["samples"])
    np.testing.assert_array_equal(theirs["epsilon"], ours["epsilon"])
    assert jh.total_nr_simulations == h.total_nr_simulations
    for t in range(3):
        df_j, w_j = jh.get_distribution(0, t)
        df_t, w_t = h.get_distribution(0, t)
        assert list(df_j.columns) == ["mu", "sigma"]
        np.testing.assert_array_equal(df_j.to_numpy(), df_t.to_numpy())
        np.testing.assert_allclose(w_j, w_t, rtol=1e-12)
        np.testing.assert_allclose(w_j.sum(), 1.0)
        wd = jh.get_weighted_distances(t)
        # every stored distance respects its generation's epsilon
        assert (wd["distance"] <= ours["epsilon"][t + 1]).all()
        weights, stats = jh.get_weighted_sum_stats(t)
        assert stats.shape == (64, 2) and np.isfinite(stats).all()
    obs = jh.get_observed_sum_stat()
    assert set(obs) == {"mean", "std"}
    np.testing.assert_allclose(float(obs["std"]), 1.1, rtol=1e-6)
    assert jh.get_ground_truth_parameter() == {"mu": 0.4, "sigma": 1.1}
    assert jh.get_json_parameters()["who"] == "port"
    tel = jh.get_telemetry(2)
    assert tel["rounds"] >= 1 and tel["health"] == 0


def test_store_sum_stats_policy(tmp_path):
    db = "sqlite:///" + str(tmp_path / "nss.db")
    abc = tpt.ABCSMC(gaussian.make_mean_only_model(),
                     gaussian.mean_only_prior(), population_size=32, seed=1,
                     device="cpu")
    abc.new(db, {"x": 1.0}, store_sum_stats=False)
    abc.run(max_nr_populations=2)
    with pytest.raises(ValueError, match="no sum stats"):
        jpt.History(db).get_weighted_sum_stats(1)


# ------------------------------------------------- the async writer
def _populations(n_gens=3, n=40, seed=0):
    rng = np.random.default_rng(seed)
    space = tpt.ParameterSpace(["mu", "sigma"])
    spec = tpt.core.SumStatSpec({"mean": np.float32(0), "std": np.float32(0)})
    return [tpt.Population(
        ms=np.zeros(n, np.int32), thetas=rng.normal(size=(n, 2)),
        weights=rng.uniform(0.1, 1.0, n), distances=rng.uniform(size=n),
        sumstats=rng.normal(size=(n, 2)), spaces=[space],
        sumstat_spec=spec) for _ in range(n_gens)]


def _new_history(db):
    h = tpt.History(db)
    h.store_initial_data(None, {}, {"mean": np.float32(0.4)}, {}, ["m0"],
                         "{}", "{}", "{}")
    return h


def _rows(db):
    """Every table's rows, the timestamps left out."""
    import sqlite3

    conn = sqlite3.connect(db[len("sqlite:///"):])
    out = {t: conn.execute(f"SELECT * FROM {t} ORDER BY id").fetchall()
           for t in ("models", "particles", "parameters", "samples")}
    out["populations"] = conn.execute(
        "SELECT id, abc_smc_id, t, nr_samples, epsilon, telemetry FROM "
        "populations ORDER BY id").fetchall()
    conn.close()
    return out


def test_async_writer_rows_equal_sync(tmp_path):
    """The writer thread writes row for row what a synchronous append
    writes, and the reference History reads it."""
    pops = _populations()
    dbs = {}
    for mode in ("sync", "async"):
        db = f"sqlite:///{tmp_path / mode}.db"
        h = _new_history(db)
        if mode == "async":
            h.start_async_writer()
        for t, pop in enumerate(pops):
            (h.append_population_async if mode == "async"
             else h.append_population)(t, 1.0 / (t + 1), pop, 100 + t,
                                       ["m0"], {"t": t})
        h.done()
        assert h._writer is None
        dbs[mode] = db
        assert [t for t, _s in h.write_seconds] == (
            [0, 1, 2] if mode == "async" else [])
    assert _rows(dbs["sync"]) == _rows(dbs["async"])
    jh = jpt.History(dbs["async"])
    assert jh.n_populations == 3
    for t in range(3):
        df_j, w_j = jh.get_distribution(0, t)
        df_t, w_t = tpt.History(dbs["sync"]).get_distribution(0, t)
        np.testing.assert_array_equal(df_j.to_numpy(), df_t.to_numpy())
        np.testing.assert_allclose(w_j, w_t, rtol=1e-12)


def test_async_write_error_surfaces_on_done(tmp_path, monkeypatch):
    """A failed write is sticky: the next submit and done() raise it, the
    generations before it are in the db, none after it is written."""
    db = f"sqlite:///{tmp_path / 'fail.db'}"
    h = _new_history(db)
    real = tpt.History._append_locked

    def flaky(self, t, *args):
        if t == 2:
            raise RuntimeError("disk gone")
        return real(self, t, *args)

    monkeypatch.setattr(tpt.History, "_append_locked", flaky)
    h.start_async_writer()
    pops = _populations(n_gens=4)
    for t in range(3):
        h.append_population_async(t, 1.0, pops[t], 10, ["m0"])
    with pytest.raises(RuntimeError, match="disk gone"):
        h.flush()
    with pytest.raises(RuntimeError, match="disk gone"):
        h.append_population_async(3, 1.0, pops[3], 10, ["m0"])
    with pytest.raises(RuntimeError, match="disk gone"):
        h.done()
    assert tpt.History(db).n_populations == 2
    assert jpt.History(db).max_t == 1


def test_run_flushes_before_a_loop_error_propagates(tmp_path, monkeypatch):
    """A run whose loop fails after handing generations to the writer
    drains them before the error propagates: they are in the db at once,
    though each write is slow."""
    import time as _time

    db = "sqlite:///" + str(tmp_path / "loop.db")
    abc = tpt.ABCSMC(gaussian.make_mean_only_model(),
                     gaussian.mean_only_prior(), population_size=32, seed=1,
                     fused_generations=2, device="cpu")
    abc.new(db, {"x": 1.0})
    real_append = tpt.History.append_population

    def slow(self, *args, **kwargs):
        _time.sleep(0.3)
        return real_append(self, *args, **kwargs)

    monkeypatch.setattr(tpt.History, "append_population", slow)
    real_fetch = abc._fetch_chunk
    calls = []

    def fetch(*args, **kwargs):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("device lost")
        return real_fetch(*args, **kwargs)

    monkeypatch.setattr(abc, "_fetch_chunk", fetch)
    with pytest.raises(RuntimeError, match="device lost"):
        abc.run(max_nr_populations=5)
    assert tpt.History(db).n_populations == 2
    abc.history.done()
    assert [g["t"] for g in abc.generation_log] == [0, 1]
    assert all(g["persist_s"] < 0.3 for g in abc.generation_log)


def test_run_rows_equal_sync_writes(tmp_path, monkeypatch):
    """A run through the writer thread stores row for row what the same
    run stores with synchronous appends (the writer never started)."""
    dbs = {}
    for mode in ("async", "sync"):
        if mode == "sync":
            monkeypatch.setattr(tpt.History, "start_async_writer",
                                lambda self: None)
        db = "sqlite:///" + str(tmp_path / f"{mode}.db")
        abc = tpt.ABCSMC(gaussian.make_gaussian_model(),
                         gaussian.default_prior(), tpt.PNormDistance(p=2),
                         population_size=64, eps=tpt.MedianEpsilon(),
                         seed=3, device="cpu", fused_generations=2)
        abc.new(db, {"mean": np.float32(0.4), "std": np.float32(1.1)})
        h = abc.run(max_nr_populations=3)
        assert [t for t, _s in h.write_seconds] == (
            [0, 1, 2] if mode == "async" else [])
        dbs[mode] = db
    rows = {m: _rows(db) for m, db in dbs.items()}
    # telemetry holds the chunk's host seconds: compare it without them
    for m in rows:
        rows[m]["populations"] = [r[:5] for r in rows[m]["populations"]]
    assert rows["async"] == rows["sync"]
