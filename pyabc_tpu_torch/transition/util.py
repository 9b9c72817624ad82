"""Transition utilities (``pyabc_tpu/transition/util.py`` counterpart):
bandwidth rules, the plain device Cholesky with its jitter-escalation
ladder (single matrix beside K8 in ``kernels/mvn_fit.py``, batched beside
K13 in ``kernels/local_factor.py``), the refit cadence's drift
statistic (beside K15 in ``kernels/proposal_drift.py``), the bootstrap
CV and bisection of the adaptive population size (K16's entries, in
``kernels/bootstrap_cv.py``) and the host loop's weighted covariance
``smart_cov``."""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.bootstrap_cv import (DONE, HI, MAX_PROBES, PROBE,
                                    bootstrap_bisect_plain, bootstrap_cv)
from ..kernels.local_factor import device_chol_guarded_batched  # noqa: F401
from ..kernels.mvn_fit import (CHOL_JITTER_LADDER,  # noqa: F401
                               device_chol_guarded)
from ..kernels.proposal_drift import device_proposal_drift  # noqa: F401


class NotEnoughParticles(Exception):
    """A host fit was given no particles."""


def smart_cov(X: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Weighted covariance robust to degenerate input (float64 numpy,
    the host fit's): a zero-variance direction gets a small positive
    diagonal, one particle or a non-finite result a small isotropic
    covariance."""
    X = np.asarray(X, np.float64)
    w = np.asarray(w, np.float64)
    w = w / w.sum()
    mean = w @ X
    centered = X - mean
    cov = (centered * w[:, None]).T @ centered
    d = X.shape[1]
    if len(X) == 1 or not np.all(np.isfinite(cov)):
        cov = np.eye(d) * 1e-4
    diag = np.diag(cov).copy()
    bad = diag <= 0
    if bad.any():
        fill = np.abs(mean) * 1e-4 + 1e-8
        cov[np.diag_indices(d)] = np.where(bad, fill, diag)
    return cov


def scott_rule_of_thumb(n_samples, dimension: int):
    """Scott bandwidth factor n^(-1/(d+4)) (floats or tensors)."""
    return n_samples ** (-1.0 / (dimension + 4))


def silverman_rule_of_thumb(n_samples, dimension: int):
    """Silverman factor (4/(d+2))^(1/(d+4)) n^(-1/(d+4))."""
    return (4 / (dimension + 2)) ** (1 / (dimension + 4)) * n_samples ** (
        -1 / (dimension + 4))


def device_bootstrap_indices(params: dict, n_bootstrap: int, *, seed: int,
                             generation: int,
                             max_rounds: int) -> torch.Tensor:
    """The bootstrap ancestors ``(n_bootstrap, n_cap)`` int32 of one fitted
    transition: K16's draw on the BOOT stream, by inverse CDF on the fit's
    ancestor ``cdf`` (the blocks of model 0; a run over several models
    draws from its stacked cdfs with ``bootstrap_cv.draw``)."""
    idx, _state = bootstrap_cv.draw(
        params["cdf"].reshape(1, -1).contiguous(), n_boot=n_bootstrap,
        seed=seed, generation=generation, max_rounds=max_rounds, min_n=0,
        max_n=0)
    return idx[0]


def device_mean_cv(params: dict, idx: torch.Tensor, n, *, dim: int,
                   scaling: float, bandwidth_selector) -> torch.Tensor:
    """Bootstrap CV of the MVN KDE density at resample size ``n``: K16's fit
    and density + CV entries on one model. Bootstrap b weights the first n
    of its ancestors ``idx[b]`` uniformly and refits; each fitted
    particle's densities under the refits are shifted by their maximum,
    their CV std / mean (ddof 0) is taken where the mean is positive, and
    the CVs are averaged with the fitted weights. ``idx`` is
    ``(n_bootstrap, n_cap)``: K16's draw, or any other. The JAX package's
    twin is generic over the transition class; here it is the MVN's
    (LocalTransition's is ``kernels/bootstrap_cv.py::local_probe``, K16's
    LocalTransition mode)."""
    n = int(n)
    state = torch.tensor([n, n, n, 0, 0], dtype=torch.int32,
                         device=params["thetas"].device)
    thetas = params["thetas"][None].contiguous()
    fit = bootstrap_cv.fit(
        thetas, idx.to(torch.int32)[None].contiguous(), state, dims=[dim],
        statics=[{"scaling": scaling,
                  "bandwidth_selector": bandwidth_selector}])
    partial = bootstrap_cv.density(
        thetas, params["weights"][None].contiguous(), fit, state)[0]
    return partial[:, 0].sum() / partial[:, 1].sum().clamp_min(1e-38)


def device_required_nr(cv_at, *, target_cv: float, min_n: int,
                       max_n: int) -> int:
    """The bisection of ``AdaptivePopulationSize`` over any ``cv_at(n)``:
    K16's plain bisect step fed each probe's CV, so the smallest n in
    [min_n, max_n] whose CV is at most ``target_cv``, or max_n at once
    when cv(max_n) misses it. The CV and the target are compared in
    float32, as on the device."""
    state = torch.tensor([min_n, max_n, max_n, 0, 0], dtype=torch.int32)
    cvs = torch.zeros(MAX_PROBES, dtype=torch.float32)
    while not int(state[DONE]):
        cv = float(cv_at(int(state[PROBE])))
        bootstrap_bisect_plain(
            torch.tensor([[[cv, 1.0]]], dtype=torch.float32), state, cvs,
            model_p=None, target=target_cv)
    return int(state[HI])
