"""Regression predictors for learned summary statistics
(``pyabc_tpu/predictor/predictor.py`` counterpart).

``LinearPredictor`` is the weighted ridge regression behind
Fearnhead-Prangle statistics: the host fit (float64 numpy, the JAX
package's ``fit`` line for line) seeds the transform after generation 0,
and from then on K23 refits it on the card at each chunk's boundary
(``kernels/ridge_fit.py``); ``device_params(device)`` hands the fitted
transform to the kernels as float32 tensors. ``MLPPredictor`` is the
nonlinear regression: its seed fit standardizes on the host in float64 and
runs its Adam steps through K23's MLP fit (``kernels/mlp_fit.py``) on
``device``, the card unless the CPU is asked for. The other predictors of
the JAX package can be constructed, and ``ABCSMC`` refuses them with the
JAX package's reason: the host-refit mode (Lasso, GP, model selection) is
not ported yet (ROADMAP queue A, item 14).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.fit import (MLP_KEYS, SD_FLOOR, linear_predict, mlp_forward,
                       mlp_layout, mlp_predict, mlp_sizes, unpack_layers)
from ..utils import not_ported, resolve_device


def _standardize_fit(x: np.ndarray):
    mu = x.mean(axis=0)
    sd = x.std(axis=0)
    sd = np.where(sd > SD_FLOOR, sd, 1.0)
    return mu, sd


class Predictor:
    """y ~ f(x) regression: a host fit and the transform's device
    parameters."""

    #: the device a fit that trains on the card runs on (None: the card);
    #: ``ABCSMC`` sets its own
    device = None
    #: the owning run's ``SyncLedger`` (set by ``ABCSMC``): a fit that
    #: trains on the device and reads its result back records the read
    sync_ledger = None

    @property
    def fitted(self) -> bool:
        return False

    def fit(self, x: np.ndarray, y: np.ndarray,
            w: np.ndarray | None = None) -> None:
        raise not_ported(f"the host fit of {type(self).__name__}", "14")

    def predict(self, x: np.ndarray) -> np.ndarray:
        raise not_ported(f"{type(self).__name__}.predict", "14")

    def __repr__(self):
        return f"{type(self).__name__}()"


class LinearPredictor(Predictor):
    """Weighted ridge regression, W = (X'ΛX + αI)^-1 X'Λ (y - ym) on
    standardized inputs (``normalize``: the host fit only; K23's refit on
    the card always standardizes, as the JAX package's kernel does)."""

    def __init__(self, alpha: float = 1e-6, normalize: bool = True):
        self.alpha = float(alpha)
        self.normalize = normalize
        self._W = None  # (S, d)
        self._b = None  # (d,)
        self._mu = None
        self._sd = None

    @property
    def fitted(self) -> bool:
        return self._W is not None

    def fit(self, x, y, w=None):
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        if y.ndim == 1:
            y = y[:, None]
        n, S = x.shape
        if self.normalize:
            self._mu, self._sd = _standardize_fit(x)
        else:
            self._mu, self._sd = np.zeros(S), np.ones(S)
        xs = (x - self._mu) / self._sd
        if w is None:
            w = np.ones(n)
        w = np.asarray(w, np.float64) * n / np.sum(w)
        xw = xs * w[:, None]
        A = xs.T @ xw + self.alpha * np.eye(S)
        ym = (w @ y) / n
        B = xs.T @ (w[:, None] * (y - ym))
        self._W = np.linalg.solve(A, B)
        self._b = ym

    def predict(self, x):
        x = np.asarray(x, np.float64)
        single = x.ndim == 1
        xs = (np.atleast_2d(x) - self._mu) / self._sd
        out = xs @ self._W + self._b
        return out[0] if single else out

    def device_params(self, device=None) -> dict:
        """The fitted transform as float32 tensors ``{"W", "b", "mu",
        "sd"}`` (contiguous)."""
        return {k: torch.as_tensor(np.asarray(v, np.float32),
                                   device=device).contiguous()
                for k, v in (("W", self._W), ("b", self._b),
                             ("mu", self._mu), ("sd", self._sd))}

    @staticmethod
    def device_predict(x: torch.Tensor, params: dict) -> torch.Tensor:
        """Plain transform of rows: ((x - mu) / sd) @ W + b."""
        return linear_predict(x, params)

    def __repr__(self):
        return f"LinearPredictor(alpha={self.alpha})"


class LassoPredictor(LinearPredictor):
    """L1-regularized linear regression (the JAX package fits it by ISTA on
    the host, in its host-refit mode)."""

    def __init__(self, alpha: float = 0.01, n_iter: int = 500,
                 normalize: bool = True):
        super().__init__(alpha=alpha, normalize=normalize)
        self.n_iter = int(n_iter)

    def fit(self, x, y, w=None):
        raise not_ported("the host fit of LassoPredictor", "14")


class MLPPredictor(Predictor):
    """Small tanh MLP trained with Adam (the JAX package's ``MLPPredictor``
    and its in-kernel MLP plan). ``fit`` standardizes x and y on the host
    in float64, draws a He init (normal * sqrt(2 / fan_in), zero biases)
    from a ``torch.Generator`` seeded with ``seed`` (declared difference:
    not ``jax.random``'s bits), and runs ``n_steps`` full-batch Adam steps
    of the weighted squared loss from zero moments through K23's MLP fit
    on ``device``."""

    def __init__(self, hidden: tuple = (64, 64), n_steps: int = 400,
                 lr: float = 1e-3, seed: int = 0):
        self.hidden = tuple(hidden)
        self.n_steps = int(n_steps)
        self.lr = float(lr)
        self.seed = int(seed)
        self._params = None  # [{"w": (fan_in, fan_out), "b"}, ...] float32
        self._mu = self._sd = None
        self._ymu = self._ysd = None

    @property
    def fitted(self) -> bool:
        return self._params is not None

    def init_params(self, sizes, device=None) -> dict:
        """The parameters a seed fit starts from: the seeded He init of
        the layers (each w from one generator in order, its b zero), views
        of one packed float32 buffer on ``device``, and the identity
        standardization (mu 0, sd 1, ymu 0, ysd 1)."""
        gen = torch.Generator().manual_seed(self.seed)
        flat = torch.cat([
            t.reshape(-1) for fi, fo in zip(sizes[:-1], sizes[1:])
            for t in (torch.randn(fi, fo, generator=gen,
                                  dtype=torch.float32) * math.sqrt(2.0 / fi),
                      torch.zeros(fo, dtype=torch.float32))]).to(device)
        S, C = sizes[0], sizes[-1]
        f32 = dict(dtype=torch.float32, device=device)
        return {"layers": unpack_layers(flat, sizes),
                "mu": torch.zeros(S, **f32), "sd": torch.ones(S, **f32),
                "ymu": torch.zeros(C, **f32), "ysd": torch.ones(C, **f32)}

    def fit(self, x, y, w=None):
        from ..kernels.mlp_fit import mlp_fit

        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        if y.ndim == 1:
            y = y[:, None]
        n, S = x.shape
        C = y.shape[1]
        self._mu, self._sd = _standardize_fit(x)
        self._ymu, self._ysd = _standardize_fit(y)
        dev = resolve_device(self.device)

        def put(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)

        xs = put((x - self._mu) / self._sd)
        ys = put((y - self._ymu) / self._ysd)
        wts = put(np.ones(n) if w is None else w / np.mean(w))
        sizes = (S, *self.hidden, C)
        start = self.init_params(sizes, dev)
        counters = torch.tensor([n, 0, 0, 0, n], dtype=torch.int32,
                                device=dev)
        params, _flags = mlp_fit(xs, ys, wts, counters, start, lr=self.lr,
                                 n_steps=self.n_steps, need=0,
                                 standardize=False)
        self._params = [{k: layer[k].cpu().numpy() for k in ("w", "b")}
                        for layer in params["layers"]]
        if self.sync_ledger is not None and dev.type == "cuda":
            self.sync_ledger.record(
                "sumstat_train_fetch", 4 * mlp_layout(sizes)[1])

    def predict(self, x):
        x = np.asarray(x, np.float64)
        single = x.ndim == 1
        xs = (np.atleast_2d(x) - self._mu) / self._sd
        layers = [{k: torch.tensor(np.asarray(v, np.float32))
                   for k, v in layer.items()}
                  for layer in self._params]
        out = mlp_forward(layers, torch.as_tensor(xs.astype(np.float32)))
        out = out.numpy().astype(np.float64) * self._ysd + self._ymu
        return out[0] if single else out

    def device_params(self, device=None) -> dict:
        """The fitted transform as float32 tensors ``{"layers": [{"w",
        "b"}, ...], "mu", "sd", "ymu", "ysd"}``, the layers views of one
        packed buffer (the kernels' layout)."""
        sizes = mlp_sizes(self._params)
        flat = torch.as_tensor(np.concatenate(
            [np.asarray(layer[k], np.float32).reshape(-1)
             for layer in self._params for k in ("w", "b")]), device=device)
        return {"layers": unpack_layers(flat, sizes),
                **{k: torch.as_tensor(np.asarray(getattr(self, f"_{k}"),
                                                 np.float32), device=device)
                   for k in MLP_KEYS}}

    @staticmethod
    def device_predict(x: torch.Tensor, params: dict) -> torch.Tensor:
        """Plain transform of rows through the network."""
        return mlp_predict(x, params)

    def __repr__(self):
        return (f"MLPPredictor(hidden={self.hidden}, n_steps={self.n_steps}, "
                f"lr={self.lr})")


class GPPredictor(Predictor):
    """RBF kernel-ridge regression (the JAX package's host-refit mode)."""

    def __init__(self, length_scale: float | None = None,
                 alpha: float = 1e-4, cap: int = 512, seed: int = 0):
        self.length_scale = length_scale
        self.alpha = float(alpha)
        self.cap = int(cap)
        self.seed = int(seed)


class ModelSelectionPredictor(Predictor):
    """Picks the best of several predictors by validation MSE (the JAX
    package's host-refit mode)."""

    def __init__(self, predictors: list, split: float = 0.2, seed: int = 0):
        self.predictors = list(predictors)
        self.split = float(split)
        self.seed = int(seed)
