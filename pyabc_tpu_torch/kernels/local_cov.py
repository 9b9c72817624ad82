"""K12: LocalTransition's k-nearest-neighbour covariance field.

Counterpart of ``pyabc_tpu/transition/local_transition.py::_device_cov_field``
with the neighbour selection of ``pyabc_tpu/ops/select.py``; the CUDA
kernel is ``csrc/local_cov.cu``.

On ``thetas (n_cap, d)`` (d = d_max, the first ``dim`` real) and
``weights (n_cap,)``: ``X = thetas * vmask``, ``w = weights / max(sum,
1e-38)``, the valid count c = #(weights > 0) and ``k_dyn = min(k_table[c],
k_cap)`` (``k_table`` built once in float64 numpy, ``k_table_host``, and
read on the device, so no host sync). Then per row the squared distances
(the diff form for a dense field, n_cap <= ``block_rows``; |x|^2 + |y|^2 -
2 x.y clamped at 0 above), invalid candidates +inf, the neighbours by
exact top-k (the k_dyn smallest, ties by index) or by radius bisection on
the ``[::stride]`` subsample, and their covariance times the squared
Silverman factor at k_dyn, with EPS relative jitter on the real diagonal
and 1 on the padded one.

Returns a dict: ``thetas`` (X), ``weights`` (w), the ancestor ``cdf`` of
K2's local mode, ``covs (n_cap, d, d)``, ``cnt (n_cap,)`` int32 (k_dyn
for top-k, the realized count for threshold) and, with ``want_idx``,
``idx (n_cap, buf)`` int32: each row's neighbours in candidate order, 0
past its count (buf = k_cap, or ceil(k_cap / stride) for threshold). With
a refit ``flag`` (int32 on the device) that reads 0 the kernel writes
nothing and K13 carries the previous params forward.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.select import threshold_neighbors
from . import _build
from .base import Kernel
from .mvn_fit import ancestor_cdf_plain

#: LocalTransition.EPS: the relative diagonal jitter
EPS = 1e-3
#: dim buckets of the kernel
MAX_DIM = 16
#: shared memory a block may use (H100), for the row's distances and
#: neighbour buffer
MAX_SMEM_BYTES = 232448
#: rows of a tile of the plain version (its distance tile is rows x n_cap)
PLAIN_ROWS = 2048


def k_table_host(n_cap: int, dim: int, *, k_fixed: int = -1,
                 k_fraction: float = 0.25, k_max: int | None = None
                 ) -> np.ndarray:
    """c -> k for every valid count c in [0, n_cap]: ``clip(k_fixed or
    round(k_fraction c), dim + 1, max(c, dim + 1))`` with ``k_max``, in
    float64 (round half to even, as the host rule)."""
    counts = np.arange(n_cap + 1)
    base = (np.full(n_cap + 1, k_fixed) if k_fixed > 0
            else np.round(k_fraction * counts))
    if k_max is not None:
        base = np.minimum(base, k_max)
    return np.clip(base, dim + 1, np.maximum(counts, dim + 1)).astype(
        np.int32)


def _div(x: torch.Tensor, v) -> torch.Tensor:
    """x / v with v as a tensor: PyTorch divides a card tensor by a Python
    number as a product by its reciprocal, the kernel divides."""
    return x / torch.as_tensor(v, dtype=x.dtype, device=x.device)


def seq_norms(X: torch.Tensor) -> torch.Tensor:
    """|x|^2 per row, summed over the dims in order."""
    acc = X[:, 0] * X[:, 0]
    for k in range(1, X.shape[1]):
        acc = acc + X[:, k] * X[:, k]
    return acc


def sq_distances(Xr: torch.Tensor, X: torch.Tensor, valid: torch.Tensor,
                 dense: bool, nr: torch.Tensor | None = None,
                 nj: torch.Tensor | None = None) -> torch.Tensor:
    """(rows, n) squared distances, each operation in the kernel's order:
    the diff form, or (|x|^2 + |y|^2) - 2 x.y clamped at 0; invalid
    candidates +inf."""
    d = X.shape[1]
    if dense:
        acc = None
        for k in range(d):
            df = Xr[:, None, k] - X[None, :, k]
            p = df * df
            acc = p if acc is None else acc + p
    else:
        dot = None
        for k in range(d):
            p = Xr[:, None, k] * X[None, :, k]
            dot = p if dot is None else dot + p
        acc = (nr[:, None] + nj[None, :]) - 2.0 * dot
        acc = torch.where(acc < 0, torch.zeros_like(acc), acc)
    return torch.where(valid[None, :], acc, torch.full_like(acc, math.inf))


def topk_neighbors(sq: torch.Tensor, k_dyn: torch.Tensor, k_cap: int):
    """The k_dyn smallest of each row by (distance, index) -> (idx
    (rows, k_cap) in candidate order, 0 past k_dyn; cnt (rows,) = k_dyn)."""
    rows, n = sq.shape
    order = torch.sort(sq, dim=1, stable=True).indices[:, :k_cap]
    pos = torch.arange(order.shape[1], device=sq.device)[None, :]
    sel = torch.where(pos < k_dyn, order, torch.full_like(order, n))
    sel = torch.sort(sel, dim=1).values
    idx = torch.where(sel < n, sel, torch.zeros_like(sel)).to(torch.int32)
    cnt = k_dyn.to(torch.int32).expand(rows)
    return idx.contiguous(), cnt.contiguous()


def local_cov_plain(thetas: torch.Tensor, weights: torch.Tensor, *,
                    dim: int, scaling: float, k_table: torch.Tensor,
                    k_cap: int, topk: bool, stride: int, dense: bool,
                    want_idx: bool = False,
                    flag: torch.Tensor | None = None) -> dict:
    """Plain PyTorch version (``flag`` is the kernel's; the plain version
    computes the field whatever it reads)."""
    del flag
    n, d = thetas.shape
    dev = thetas.device
    vmask = (torch.arange(d, device=dev) < dim).to(thetas.dtype)
    X = thetas * vmask
    w = weights / weights.sum().clamp_min(1e-38)
    valid = weights > 0
    c = valid.sum()
    k_dyn = torch.clamp(k_table[c].to(torch.int64), max=k_cap)
    factor = ((4 / (dim + 2)) ** (1 / (dim + 4))
              * k_dyn.to(thetas.dtype) ** (-1 / (dim + 4)) * scaling)
    factor2 = factor * factor
    norms = None if dense else seq_norms(X)
    buf = k_cap if topk else -(-k_cap // stride)
    covs = torch.empty(n, d, d, dtype=thetas.dtype, device=dev)
    cnts = torch.empty(n, dtype=torch.int32, device=dev)
    idxs = torch.empty(n, buf, dtype=torch.int32, device=dev)
    eye = torch.eye(d, dtype=thetas.dtype, device=dev)
    outer = vmask[:, None] * vmask[None, :]
    for r0 in range(0, n, PLAIN_ROWS):
        r1 = min(n, r0 + PLAIN_ROWS)
        Xr = X[r0:r1]
        sq = sq_distances(Xr, X, valid, dense,
                          None if dense else norms[r0:r1], norms)
        if topk:
            idx, cnt = topk_neighbors(sq, k_dyn, k_cap)
            div = k_dyn.expand(r1 - r0)
        else:
            idx, cnt, _r = threshold_neighbors(sq, k_dyn, k_cap,
                                               stride=stride)
            div = cnt
        pos_ok = ((torch.arange(buf, device=dev)[None, :] < cnt[:, None])
                  & valid[idx.long()])
        centered = (X[idx.long()] - Xr[:, None, :]) * pos_ok[..., None]
        cov = torch.einsum("nkd,nke->nde", centered, centered)
        cov = cov / div.clamp_min(1).to(cov.dtype)[:, None, None] * factor2
        tr = cov[:, 0, 0]
        for e in range(1, d):
            tr = tr + cov[:, e, e]
        jit = _div(tr, float(dim)).clamp_min(1e-10) * EPS
        diag = jit[:, None] * vmask[None, :] + (1.0 - vmask)[None, :]
        covs[r0:r1] = cov * outer + diag[:, :, None] * eye
        cnts[r0:r1] = cnt
        idxs[r0:r1] = idx
    out = {"thetas": X.contiguous(), "weights": w.contiguous(),
           "cdf": ancestor_cdf_plain(w).contiguous(), "covs": covs,
           "cnt": cnts}
    if want_idx:
        out["idx"] = idxs
    return out


class LocalCov(Kernel):
    name = "local_cov"
    source = "pyabc_tpu_torch/csrc/local_cov.cu"
    replaces = "pyabc_tpu/transition/local_transition.py:144"

    def __call__(self, thetas: torch.Tensor, weights: torch.Tensor, *,
                 dim: int, scaling: float, k_table: torch.Tensor,
                 k_cap: int, topk: bool, stride: int, dense: bool,
                 want_idx: bool = False,
                 flag: torch.Tensor | None = None) -> dict:
        kw = dict(dim=dim, scaling=scaling, k_table=k_table, k_cap=k_cap,
                  topk=topk, stride=stride, dense=dense, want_idx=want_idx,
                  flag=flag)
        extra = [] if flag is None else [flag]
        if self.on_cpu(thetas, weights, k_table, *extra):
            return local_cov_plain(thetas, weights, **kw)
        n, d = thetas.shape
        if d > MAX_DIM:
            raise ValueError(f"{self.name}: dim {d} above the kernel's "
                             f"cap {MAX_DIM}")
        f32, i32 = torch.float32, torch.int32
        self.expect(thetas, "thetas", f32, (n, d))
        self.expect(weights, "weights", f32, (n,))
        self.expect(k_table, "k_table", i32, (n + 1,))
        if flag is not None:
            self.expect(flag, "flag", i32, ())
        if stride < 1 or not 0 < k_cap <= n:
            raise ValueError(f"{self.name}: k_cap {k_cap} or stride "
                             f"{stride} outside [1, n_cap {n}]")
        buf = k_cap if topk else -(-k_cap // stride)
        m = n if topk else -(-n // stride)
        if 4 * (m + buf) > MAX_SMEM_BYTES:
            raise ValueError(
                f"{self.name}: a row's {m} distances and {buf} neighbour "
                f"slots exceed a block's shared memory ({MAX_SMEM_BYTES} "
                f"bytes)")
        dev = thetas.device
        out = {"thetas": torch.empty(n, d, dtype=f32, device=dev),
               "weights": torch.empty(n, dtype=f32, device=dev),
               "cdf": torch.empty(n, dtype=f32, device=dev),
               "covs": torch.empty(n, d, d, dtype=f32, device=dev),
               "cnt": torch.empty(n, dtype=i32, device=dev)}
        if want_idx:
            out["idx"] = torch.empty(n, buf, dtype=i32, device=dev)
        norms = None if dense else torch.empty(n, dtype=f32, device=dev)
        k_dyn = torch.empty(1, dtype=i32, device=dev)
        factor2 = torch.empty(1, dtype=f32, device=dev)
        err = _build.library().pyabc_local_cov(
            thetas.data_ptr(), weights.data_ptr(), n, d, int(dim),
            k_table.data_ptr(), int(k_cap),
            (4 / (dim + 2)) ** (1 / (dim + 4)), -1.0 / (dim + 4),
            float(scaling), int(bool(topk)), int(stride), self.ptr(flag),
            out["thetas"].data_ptr(), out["weights"].data_ptr(),
            out["cdf"].data_ptr(), self.ptr(norms), k_dyn.data_ptr(),
            factor2.data_ptr(), out["covs"].data_ptr(),
            out["cnt"].data_ptr(), self.ptr(out.get("idx")), buf,
            _build.stream_ptr(dev))
        _build.check(err, self.name)
        self.launches += 1
        return out


local_cov = LocalCov()
