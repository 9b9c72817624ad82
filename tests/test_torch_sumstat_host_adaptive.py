"""Whole runs in the host-refit mode under ``AdaptivePNormDistance``: the
port against the JAX package's own runs on the CPU.

The statistics of ``tests/test_torch_sumstat_host_runs.py`` on its
Fearnhead-Prangle model, with the weights refit in the transformed space
over the record ring inside a chunk and over the accepted rows at a
boundary (both packages): the generations a fit ran at equal to the JAX
package's at every seed, the seed-mean epsilon trails within 0.2
relative.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import pyabc_tpu as jpt  # noqa: E402
import pyabc_tpu_torch as tpt  # noqa: E402
from test_torch_sumstat_host_runs import GENS, RUNS, _both  # noqa: E402
from test_torch_sumstat_runs import EPS_RTOL  # noqa: E402

torch.set_num_threads(1)

#: over five generations:
#: at the sixth the fit_every 3 trails of these three seeds part by 0.23
#: relative, within the seed-to-seed spread of both packages there
ADAPTIVE = ("GPPredictor", "LassoPredictor", "fit_every 3",
            "IdentitySumstat functions")


@pytest.mark.parametrize("name", ADAPTIVE)
def test_adaptive_host_refit_runs_match_jax(name, monkeypatch):
    make, options, _hold = RUNS[name]
    out = _both(monkeypatch, make, options, adaptive=True, gens=GENS - 1)
    (jfits, jtrail, _jmu), (tfits, ttrail, _tmu) = out[jpt], out[tpt]
    assert tfits == jfits
    np.testing.assert_allclose(ttrail, jtrail, rtol=EPS_RTOL)
