"""Which learned statistics fit on the card
(``pyabc_tpu/sumstat/device.py`` counterpart).

:func:`device_fit_plan` resolves the static plan K23 runs (``linear`` for
``LinearPredictor``, ``mlp`` for ``MLPPredictor``) or the JAX package's
reason why the configuration stays on its host-refit path, word for word;
the port has no host-refit path yet and raises ``not_ported`` with that
reason.
:func:`mirror_fitted_params` writes a boundary fit, fetched with its
chunk, back into the host predictor.
"""
from __future__ import annotations

import numpy as np

from ..predictor import (GPPredictor, LassoPredictor, LinearPredictor,
                         MLPPredictor, ModelSelectionPredictor)
from .base import PredictorSumstat


def device_fit_plan(distance, *, total_size: int, d_max: int,
                    sharded_n: int | None = None
                    ) -> tuple[dict | None, str | None]:
    """``(plan, None)`` when K23 can own the boundary refit, else ``(None,
    reason)``. The plan is static (predictor type and hyperparameters): its
    ``kind``, ``out_dim`` (the fit's C' = d_max), ``need`` (the rows a fit
    needs) and the linear plan's ``alpha`` or the MLP plan's ``lr`` and
    ``n_steps`` (at most 100 a boundary)."""
    sumstat = getattr(distance, "sumstat", None)
    if sumstat is None:
        return None, "distance has no learned sumstat transform"
    if not isinstance(sumstat, PredictorSumstat):
        return None, (
            f"{type(sumstat).__name__} is a fixed transform, not a "
            f"fitted predictor — nothing to refit in-kernel"
        )
    if sumstat.fit_every != 1:
        return None, (
            f"fit_every={sumstat.fit_every} host cadence control: the "
            f"in-kernel fit runs at every chunk boundary; drop "
            f"fit_every (or set 1) for device-native fits"
        )
    pred = sumstat.predictor
    need = sumstat.need(total_size)
    if isinstance(pred, ModelSelectionPredictor):
        return None, (
            "ModelSelectionPredictor's cross-validated winner selection "
            "is host control flow (per-candidate fits + a validation "
            "split); the host-refit path serves it — pick the winning "
            "predictor directly for device-native fits"
        )
    if isinstance(pred, GPPredictor):
        return None, (
            "GPPredictor subsamples training points with host RNG and "
            "solves a dense kernel system per fit; the host-refit path "
            "serves it — LinearPredictor/MLPPredictor fit on-device"
        )
    if isinstance(pred, LassoPredictor):
        return None, (
            "LassoPredictor's ISTA proximal loop fits host-side (L1 "
            "thresholding has no bounded-cost in-kernel form here); "
            "the host-refit path serves it — LinearPredictor fits "
            "on-device"
        )
    if isinstance(pred, MLPPredictor):
        if sharded_n:
            return None, (
                "MLPPredictor's warm-started Adam steps refit on the "
                "gathered reservoir; the sharded kernel serves LINEAR "
                "device fits only — drop sharding or switch to "
                "LinearPredictor"
            )
        return {"kind": "mlp", "out_dim": int(d_max), "need": need,
                "lr": float(pred.lr),
                "n_steps": min(int(pred.n_steps), 100)}, None
    if isinstance(pred, LinearPredictor):
        return {"kind": "linear", "out_dim": int(d_max), "need": need,
                "alpha": float(pred.alpha)}, None
    return None, (
        f"{type(pred).__name__} has no traceable in-kernel fit twin; "
        f"the host-refit path serves it"
    )


def seed_params_ready(distance) -> bool:
    """True once the generation-0 host fit has seeded the predictor (C' is
    fixed from then on)."""
    sumstat = getattr(distance, "sumstat", None)
    return (isinstance(sumstat, PredictorSumstat)
            and sumstat.predictor.fitted)


def mirror_fitted_params(distance, ssp_host: dict, t: int) -> None:
    """Write a boundary fit's fetched parameters (numpy float32: ``{"W",
    "b", "mu", "sd"}`` of a ``LinearPredictor``, ``{"layers": [{"w", "b"},
    ...], "mu", "sd", "ymu", "ysd"}`` of an ``MLPPredictor``) into the host
    predictor, as float32: ``device_params()`` then gives back the very
    tensors the card carried. ``t`` becomes the predictor's
    ``_last_fit_t``."""
    sumstat = distance.sumstat
    pred = sumstat.predictor
    if isinstance(pred, MLPPredictor):
        pred._params = [{k: np.asarray(layer[k], np.float32)
                         for k in ("w", "b")}
                        for layer in ssp_host["layers"]]
        keys, out = ("mu", "sd", "ymu", "ysd"), "ymu"
    else:
        keys, out = ("W", "b", "mu", "sd"), "b"
    for key in keys:
        setattr(pred, f"_{key}", np.asarray(ssp_host[key], np.float32))
    sumstat._out_dim = int(np.asarray(ssp_host[out]).shape[-1])
    sumstat._last_fit_t = int(t)
