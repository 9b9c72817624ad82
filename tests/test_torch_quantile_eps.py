"""Port parity: K7's quantile epsilon (``normalize_quantile.
quantile_epsilon``, the generation step's masked entry) against the JAX
package's composition at ``pyabc_tpu/inference/util.py:1866-1872``
(``jnp.where`` + ``stats.weighted_quantile`` times the multiplier), on the
same numpy inputs; and a whole LV run on the CPU against its pinned epsilon
trail."""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from pyabc_tpu.ops import stats as jstats  # noqa: E402
import pyabc_tpu_torch as tpt  # noqa: E402
from pyabc_tpu_torch.kernels import (normalize_quantile,  # noqa: E402
                                     quantile_epsilon_plain)
from pyabc_tpu_torch.models import lotka_volterra as lv  # noqa: E402
from pyabc_tpu_torch.ops import stats  # noqa: E402

torch.set_num_threads(1)

N = 64


def _inputs(case):
    """(distances, kept-row mask, normalized weights) for a case: a prefix
    mask, K24b's shard-blocked mask (4 shards of 16 rows keeping 5, 5, 4
    and 4), nothing kept, ties, NaN and inf distances among the kept."""
    rng = np.random.default_rng(11)
    d = rng.exponential(size=N).astype(np.float32)
    mask = np.arange(N) < 41
    if case == "shard_blocked":
        mask = np.zeros(N, bool)
        for s, q in enumerate((5, 5, 4, 4)):
            mask[s * 16:s * 16 + q] = True
    elif case == "all_masked":
        mask[:] = False
    elif case == "ties":
        d = (np.round(d * 2) / 2).astype(np.float32)
    elif case == "nan_inf":
        d[[2, 17]] = np.nan
        d[[5, 30]] = np.inf
        d[50] = np.nan  # masked: +inf of weight 0 all the same
    lw = rng.normal(-3.0, 1.0, size=N).astype(np.float32)
    w = np.where(mask, np.exp(lw), 0.0)
    w = (w / w.sum() if w.sum() > 0 else w).astype(np.float32)
    return d, mask, w


def _jax_eps(d, mask, w, weighted, alpha, multiplier):
    pts = jnp.where(jnp.asarray(mask), jnp.asarray(d), jnp.inf)
    wts = (jnp.where(jnp.asarray(mask), jnp.asarray(w), 0.0) if weighted
           else jnp.asarray(mask).astype(jnp.float32))
    return float(jstats.weighted_quantile(pts, wts, alpha) * multiplier)


def _same(a: float, b: float) -> bool:
    return a == b or (np.isnan(a) and np.isnan(b))


@pytest.mark.parametrize("multiplier", [1.0, 0.8])
@pytest.mark.parametrize("alpha", [0.1, 0.5, 0.9, 1.0])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("case", ["prefix", "shard_blocked", "all_masked",
                                  "ties", "nan_inf"])
def test_quantile_epsilon_matches_jax(case, weighted, alpha, multiplier):
    d, mask, w = _inputs(case)
    ref = _jax_eps(d, mask, w, weighted, alpha, multiplier)
    got = float(stats.quantile_epsilon(
        torch.from_numpy(d), torch.from_numpy(mask), torch.from_numpy(w),
        weighted, alpha, multiplier))
    # the same stable sort, float32 cumsum, left search and float32
    # product: equal (nothing kept: +inf; NaN where both select a NaN)
    assert _same(got, ref), (got, ref)


@pytest.mark.parametrize("case", ["prefix", "shard_blocked", "nan_inf"])
def test_quantile_epsilon_is_the_masked_composition(case):
    """The entry equals the composition the generation step ran before it
    was one launch: torch.where, K7's quantile, then the multiply; the
    unweighted entry reads no weights (the calibration passes None)."""
    d, mask, w = _inputs(case)
    dt, mt, wt = (torch.from_numpy(x) for x in (d, mask, w))
    for weighted in (False, True):
        pts = torch.where(mt, dt, torch.full_like(dt, np.inf))
        wts = torch.where(mt, wt, torch.zeros_like(wt)) if weighted \
            else mt.float()
        ref = float(stats.weighted_quantile(pts, wts, 0.5) * 0.8)
        got = float(normalize_quantile.quantile_epsilon(
            dt, mt, wt if weighted else None, weighted, 0.5, 0.8))
        assert _same(got, ref)
        assert _same(got, float(quantile_epsilon_plain(
            dt, mt, wt, weighted, 0.5, 0.8)))


def test_quantile_epsilon_counts_no_launch_on_the_cpu():
    d, mask, w = _inputs("prefix")
    before = (normalize_quantile.launches,
              dict(normalize_quantile.mode_launches))
    stats.quantile_epsilon(torch.from_numpy(d), torch.from_numpy(mask),
                           torch.from_numpy(w), True, 0.5, 1.0)
    assert (normalize_quantile.launches,
            normalize_quantile.mode_launches) == before


#: LV config 2's shape at pop 200, seed 3, four generations on the CPU: the
#: epsilon trail the generation step gave when its quantile epsilon was the
#: torch.where + quantile + multiply composition (float32 values)
LV_TRAIL = [56.053104400634766, 52.27183532714844, 50.810142517089844,
            52.712364196777344]


def test_lv_cpu_run_keeps_its_pinned_epsilon_trail():
    abc = tpt.ABCSMC(lv.make_lv_model(), lv.default_prior(),
                     tpt.AdaptivePNormDistance(p=2), population_size=200,
                     eps=tpt.MedianEpsilon(), seed=3, device="cpu")
    abc.new("sqlite://", lv.observed_data(seed=0), store_sum_stats=False)
    h = abc.run(max_nr_populations=4)
    eps = [float(e) for e in h.get_all_populations()["epsilon"][1:]]
    assert eps == LV_TRAIL
