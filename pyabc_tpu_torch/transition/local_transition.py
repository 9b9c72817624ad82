"""Locally adaptive Gaussian perturbation kernel
(``pyabc_tpu/transition/local_transition.py`` counterpart).

Each accepted particle gets its own covariance from its k nearest
neighbours, times the squared Silverman factor at k. The fit is K12 (the
covariance field, ``kernels/local_cov.py``) then K13 (the factorization,
``kernels/local_factor.py``, only of rows whose covariance changed in the
incremental refit); drawing is K2's local mode (``propose_local``) and the
density K14 (``kernels/local_logpdf.py``).

Params are a dict of device tensors: ``thetas (n, d)``, ``weights (n,)``,
``chols``/``precs (n, d, d)``, ``logdets (n,)``, the ancestor ``cdf (n,)``,
the per-component constant ``lconst (n,)`` and the true ``dim`` (a Python
float). As for the MVN transition, the host ``fit``/``pdf`` are not
ported: the fused path fits on the device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.local_cov import k_table_host, local_cov
from ..kernels.local_factor import PARAM_KEYS, REUSE_RTOL, local_factor
from ..kernels.local_logpdf import local_logpdf
from ..kernels.philox import PhiloxStream
from ..kernels.propose import propose_local, unbounded_prior
from ..ops.select import DEFAULT_TOPK_CUTOFF, default_stride


def dense_field(n_cap: int, block_rows: int | None = None) -> bool:
    """The JAX package's size rule for the distance formula: the diff form
    when one tile holds every row (n_cap <= 4096, or an awkward n_cap with
    no divisor tile of at least 256 rows), else |x|^2 + |y|^2 - 2 x.y."""
    if block_rows is None:
        if n_cap <= 4096:
            return True
        block_rows = next((b for b in range(2048, 0, -1) if n_cap % b == 0),
                          1)
        if block_rows < 256:
            return True
    return min(block_rows, n_cap) >= n_cap


class LocalTransition:
    """k-nearest-neighbour local-covariance Gaussian KDE.

    ``k`` neighbours per particle (default ``k_fraction * n``, at least
    dim + 1, at most ``k_max``); ``scaling`` multiplies the covariance;
    ``selection`` is "topk" (exact), "threshold" (radius bisection) or
    "auto" (threshold from a k bound of ``DEFAULT_TOPK_CUTOFF`` up).
    """

    EPS = 1e-3
    REUSE_RTOL = REUSE_RTOL

    @staticmethod
    def device_refit_min_count(dim: int) -> int:
        """Accepted particles a refit needs; below it the old params carry
        forward."""
        return dim + 1

    def __init__(self, k: int | None = None, k_fraction: float = 0.25,
                 scaling: float = 1.0, k_max: int | None = None,
                 selection: str = "auto"):
        if selection not in ("auto", "topk", "threshold"):
            raise ValueError(
                f"selection must be auto/topk/threshold, got {selection!r}")
        self.k = k
        self.k_fraction = float(k_fraction)
        self.scaling = float(scaling)
        self.k_max = int(k_max) if k_max is not None else None
        self.selection = str(selection)

    def _effective_k(self, n: int, dim: int) -> int:
        k = self.k if self.k is not None else int(round(self.k_fraction * n))
        if self.k_max is not None:
            k = min(k, self.k_max)
        return int(np.clip(k, dim + 1, n))

    def fit_statics(self, n: int, dim: int) -> dict:
        """The fit's static configuration for a population of n: the k
        bound at n (the per-generation k comes from the valid count on the
        device), the neighbour rule and the selection."""
        return {"scaling": self.scaling, "k_cap": self._effective_k(n, dim),
                "k_fixed": int(self.k) if self.k is not None else -1,
                "k_fraction": self.k_fraction, "k_max": self.k_max,
                "selection": self.selection}

    @staticmethod
    def zero_params(n: int, d: int, device) -> dict:
        """Placeholder params of a never-fitted transition."""
        shapes = {"thetas": (n, d), "weights": (n,), "cdf": (n,),
                  "chols": (n, d, d), "precs": (n, d, d), "logdets": (n,),
                  "lconst": (n,)}
        params = {k: torch.zeros(shapes[k], dtype=torch.float32,
                                 device=device) for k in PARAM_KEYS}
        return {**params, "dim": float(d)}

    @staticmethod
    def field_config(n_cap: int, dim: int, *, scaling: float,
                     k: int | None = None, k_cap: int | None = None,
                     k_fixed: int = -1, k_fraction: float = 0.25,
                     k_max: int | None = None,
                     block_rows: int | None = None,
                     selection: str = "auto",
                     topk_cutoff: int | None = None,
                     bisect_stride: int | None = None,
                     k_table: torch.Tensor | None = None,
                     device=None) -> dict:
        """K12's arguments from the JAX package's ``device_fit`` keywords:
        ``k`` forces k_cap = k_fixed = k; the k table is built here unless
        given (the fused loop builds it once per run)."""
        if k is not None:
            k_cap, k_fixed = int(k), int(k)
        if k_cap is None:
            raise ValueError("device_fit needs k or k_cap")
        cutoff = DEFAULT_TOPK_CUTOFF if topk_cutoff is None else topk_cutoff
        if selection == "auto":
            selection = "threshold" if k_cap >= cutoff else "topk"
        if k_table is None:
            k_table = torch.as_tensor(
                k_table_host(n_cap, dim, k_fixed=k_fixed,
                             k_fraction=k_fraction, k_max=k_max),
                device=device)
        return {"dim": dim, "scaling": scaling, "k_table": k_table,
                "k_cap": int(k_cap), "topk": selection == "topk",
                "stride": (default_stride(n_cap) if bisect_stride is None
                           else int(bisect_stride)),
                "dense": dense_field(n_cap, block_rows)}

    @staticmethod
    def device_fit(thetas: torch.Tensor, weights: torch.Tensor, *, dim: int,
                   prev: dict | None = None,
                   flag: torch.Tensor | None = None, **statics) -> dict:
        """The full refit: K12's covariance field, then K13 factorizes
        every row. ``flag`` (int32 on the device, K15's decision) with the
        carried ``prev`` params: 0 carries ``prev`` forward."""
        field = local_cov(thetas, weights, flag=flag,
                          **LocalTransition.field_config(
                              thetas.shape[0], dim, device=thetas.device,
                              **statics))
        params, _n = local_factor(field, prev, dim=dim, incremental=False,
                                  flag=flag)
        return params

    @staticmethod
    def device_fit_update(thetas: torch.Tensor, weights: torch.Tensor,
                          prev: dict, *, dim: int,
                          flag: torch.Tensor | None = None, **statics):
        """The incremental refit -> (params, n_changed): K12's field, then
        K13 factorizes only the rows whose covariance moved away from
        ``prev``'s factors by more than ``REUSE_RTOL``."""
        field = local_cov(thetas, weights, flag=flag,
                          **LocalTransition.field_config(
                              thetas.shape[0], dim, device=thetas.device,
                              **statics))
        return local_factor(field, prev, dim=dim, incremental=True,
                            flag=flag)

    @staticmethod
    def device_rvs(params: dict, n: int, stream: PhiloxStream,
                   prior: dict | None = None) -> torch.Tensor:
        """``n`` draws (K2's local mode) redrawn against zero mass under
        ``prior`` (None: no bounds)."""
        if prior is None:
            prior = unbounded_prior(params["thetas"].shape[1],
                                    params["thetas"].device)
        return propose_local(stream, n, prior, params)[0]

    @staticmethod
    def device_logpdf(q: torch.Tensor, params: dict) -> torch.Tensor:
        """``(B, d)`` -> ``(B,)`` mixture log-density (K14)."""
        return local_logpdf(q.contiguous(), params)

    def get_config(self) -> dict:
        return {"name": type(self).__name__, "k": self.k,
                "k_fraction": self.k_fraction, "scaling": self.scaling,
                "k_max": self.k_max, "selection": self.selection}

    def __repr__(self):
        return f"LocalTransition(k={self.k}, scaling={self.scaling})"
