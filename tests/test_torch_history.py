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
