"""K21a / K21c: noise-model log-density, stochastic accept test and
importance log-weight of one round (the stochastic twin of K5).

Counterpart of the ``device_fn`` of every device-compatible noise model of
``pyabc_tpu/distance/kernel.py`` (K21a: ``IndependentNormalKernel``; K21c:
``NormalKernel``, ``IndependentLaplaceKernel``, ``BinomialKernel``,
``PoissonKernel``, ``NegativeBinomialKernel`` in both parameterizations)
+ ``acceptor/acceptor.py::StochasticAcceptor.device_fn`` + the log-weight
sums of ``inference/util.py::_lane_prior`` / ``_lane_transition``; the CUDA
kernels are ``csrc/kernel_accept.cu`` (the per-entry terms in
``csrc/noise.cuh``, which K18's noisy mode shares). Each lane's uniform is
word 0 of block 0 of the accept stream (``philox.ACCEPT``, K1), in the
kernel on the card and by the plain twin on the CPU. The temperature and
the pdf norm are device scalars.

A family's device parameters are one flat float32 vector: the per-column
variance (independent normal), scale b (Laplace), p (binomial, negative
binomial: the same p in every column) or zeros (Poisson), ``(S,)``; the
full normal's is the ``(S, S)`` precision, then its log-determinant and
``S log 2 pi``, ``(S * S + 2,)``. The elementwise families' log-density is
``scale * sum_s term_s`` (``SCALES``), the terms in the JAX package's
order of operations; a SCALE_LIN kernel other than the independent normal
and Laplace ones (whose JAX ``device_fn`` never exponentiates) returns the
density ``exp(total)``.
"""
from __future__ import annotations

import math

import torch

from . import _build
from .base import Kernel
from .philox import PhiloxStream, no_lane_base, uniforms

_LOG_2PI = math.log(2.0 * math.pi)

#: noise families in the order of ``csrc/noise.cuh``'s codes
FAMILIES = ("independent_normal", "laplace", "binomial", "poisson",
            "negbin_size", "negbin_mean", "normal")
FAMILY_CODES = {name: i for i, name in enumerate(FAMILIES)}
#: v = SCALES[family] * sum(terms) for the elementwise families
SCALES = {"independent_normal": -0.5, "laplace": -1.0, "binomial": 1.0,
          "poisson": 1.0, "negbin_size": 1.0, "negbin_mean": 1.0}
#: families whose SCALE_LIN form is exp(total) (JAX's ``device_fn``)
EXP_LIN = ("binomial", "poisson", "negbin_size", "negbin_mean", "normal")
#: the largest S of the full normal: its (S, S) precision, x0 and a
#: column of S diffs for each of NORMAL_THREADS threads in shared memory
NORMAL_THREADS = 128
SMEM_BYTES = 232448
MAX_NORMAL_S = max(s for s in range(1, 512)
                   if 4 * (s * s + s * (NORMAL_THREADS + 1)) <= SMEM_BYTES)


def _neg_inf(like: torch.Tensor) -> torch.Tensor:
    return torch.full_like(like, -math.inf)


def binom_logpmf(k, n, p):
    """``_binom_logpmf`` of the JAX package: gammaln and xlogy/xlog1py."""
    return (torch.lgamma(n + 1.0) - torch.lgamma(k + 1.0)
            - torch.lgamma(n - k + 1.0) + torch.special.xlogy(k, p)
            + torch.special.xlog1py(n - k, -p))


def noise_terms(family: str, x: torch.Tensor, x0: torch.Tensor,
                par: torch.Tensor) -> torch.Tensor:
    """The per-entry terms of an elementwise family at ``x (..., k)``, with
    ``x0`` and ``par`` those columns' observation and parameter:
    (log 2 pi + log var) + diff^2 / var; log 2b + |diff| / b; and the
    binomial, Poisson and negative-binomial log-pmfs, -inf off their
    support."""
    if family == "independent_normal":
        diff = x - x0
        return (_LOG_2PI + torch.log(par)) + diff * diff / par
    if family == "laplace":
        return torch.log(2.0 * par) + (x - x0).abs() / par
    k = torch.round(x0)
    if family == "binomial":
        n = torch.clamp_min(torch.round(x), 0.0)
        return torch.where((k >= 0) & (k <= n), binom_logpmf(k, n, par),
                           _neg_inf(n))
    lam = torch.clamp_min(x, 1e-12)
    if family == "poisson":
        logp = k * torch.log(lam) - lam - torch.lgamma(k + 1.0)
    else:
        n = lam * par / (1.0 - par) if family == "negbin_mean" else lam
        logp = (torch.lgamma(k + n) - torch.lgamma(n) - torch.lgamma(k + 1.0)
                + n * torch.log(par) + k * torch.log1p(-par))
    return torch.where(k >= 0, logp, _neg_inf(logp))


#: families with an upper bound (K18's noisy mode)
BOUND_FAMILIES = ("independent_normal", "laplace", "binomial", "poisson")


def noise_bound_fold(family: str, acc: torch.Tensor, vals: torch.Tensor,
                     x0: torch.Tensor, par: torch.Tensor) -> torch.Tensor:
    """Fold one segment's values ``(B, k)`` (x0, par: that segment's
    columns) into the upper bound ``acc`` in emission order: the entries'
    sum, then acc - 0.5 sum (normal: diff^2 / var), acc - sum (Laplace:
    |diff| / b) or acc + sum (binomial, Poisson: the log-pmfs)."""
    if family == "independent_normal":
        diff = vals - x0
        e = diff * diff / par
    elif family == "laplace":
        e = (vals - x0).abs() / par
    else:
        e = noise_terms(family, vals, x0, par)
    s = torch.zeros_like(acc)
    for k in range(e.shape[-1]):
        s = s + e[..., k]
    if family == "independent_normal":
        return acc - 0.5 * s
    return acc - s if family == "laplace" else acc + s


def upper_exceeds(acc: torch.Tensor, thr: torch.Tensor) -> torch.Tensor:
    """``_upper_exceeds``: True only where the final log-density is
    provably below ``thr``, acc < thr - (1e-3 + 1e-4 |acc|)."""
    return acc < thr - (1e-3 + 1e-4 * acc.abs())


def noise_logdensity_rows(family: str, ss: torch.Tensor, x0: torch.Tensor,
                          params: torch.Tensor) -> torch.Tensor:
    """The family's log-density of every row of ``ss (B, S)``."""
    if family == "normal":
        S = ss.shape[1]
        prec = params[:S * S].reshape(S, S)
        diff = ss - x0
        quad = ((diff @ prec) * diff).sum(-1)
        return -0.5 * ((params[S * S + 1] + params[S * S]) + quad)
    return SCALES[family] * noise_terms(family, ss, x0, params).sum(-1)


def accept_uniforms(stream: PhiloxStream, B: int) -> torch.Tensor:
    """The ``(B,)`` uniforms the kernel draws on ``stream``."""
    lanes = torch.arange(B, dtype=torch.int64, device=stream.counters.device)
    return uniforms(stream, lanes, 0, 0)


def kernel_accept_plain(ss, x0, params, temp, pdf_norm, valid, *,
                        stream: PhiloxStream, lin: bool, apply_iw: bool,
                        logpri=None, logq=None,
                        family: str = "independent_normal"):
    """Plain PyTorch version -> (kernel value v, accept, log_weight)."""
    v = noise_logdensity_rows(family, ss, x0, params)
    if lin and family in EXP_LIN:
        v = torch.exp(v)
    logv = torch.log(v.clamp_min(1e-30)) if lin else v
    log_ratio = (logv - pdf_norm) / temp
    u = accept_uniforms(stream, ss.shape[0])
    accept = valid & (torch.log(u) < log_ratio)
    log_acc_w = torch.where((log_ratio > 0) & apply_iw, log_ratio,
                            torch.zeros_like(log_ratio))
    lw = log_acc_w if logpri is None else (logpri + log_acc_w) - logq
    lw = torch.where(valid, lw, torch.full_like(lw, -math.inf))
    return v, accept, lw


class KernelAccept(Kernel):
    name = "kernel_accept"
    source = "pyabc_tpu_torch/csrc/kernel_accept.cu"
    replaces = "pyabc_tpu/acceptor/acceptor.py:306"

    def __init__(self):
        super().__init__()
        #: launches of each noise family (K21a: independent_normal; the
        #: others are K21c)
        self.mode_launches = {f: 0 for f in FAMILIES}

    def __call__(self, ss, x0, params, temp, pdf_norm, valid, *,
                 stream: PhiloxStream, lin: bool, apply_iw: bool,
                 logpri=None, logq=None, family: str = "independent_normal"):
        if family not in FAMILY_CODES:
            raise ValueError(f"{self.name}: unknown noise family {family!r}")
        no_lane_base(stream, self.name)
        kw = dict(stream=stream, lin=lin, apply_iw=apply_iw, logpri=logpri,
                  logq=logq, family=family)
        opt = [t for t in (logpri, logq) if t is not None]
        if self.on_cpu(ss, x0, params, temp, pdf_norm, valid,
                       stream.counters, *opt):
            return kernel_accept_plain(ss, x0, params, temp, pdf_norm, valid,
                                       **kw)
        if (logpri is None) != (logq is None):
            raise ValueError(f"{self.name}: logpri and logq go together")
        B, S = ss.shape
        if family == "normal" and S > MAX_NORMAL_S:
            raise ValueError(
                f"{self.name}: NormalKernel holds its (S, S) precision in "
                f"shared memory, which takes S <= {MAX_NORMAL_S}; got S = "
                f"{S}")
        f32 = torch.float32
        self.expect(ss, "ss", f32, (B, S))
        self.expect(x0, "x0", f32, (S,))
        self.expect(params, "params", f32,
                    (S * S + 2,) if family == "normal" else (S,))
        self.expect(temp, "temp", f32, ())
        self.expect(pdf_norm, "pdf_norm", f32, ())
        self.expect(valid, "valid", torch.bool, (B,))
        self.expect(stream.counters, "counters", torch.int32,
                    (stream.counters.shape[0],))
        if logpri is not None:
            self.expect(logpri, "logpri", f32, (B,))
            self.expect(logq, "logq", f32, (B,))
        dev = ss.device
        v = torch.empty(B, dtype=f32, device=dev)
        accept = torch.empty(B, dtype=torch.bool, device=dev)
        lw = torch.empty(B, dtype=f32, device=dev)
        err = _build.library().pyabc_kernel_accept(
            ss.data_ptr(), B, S, x0.data_ptr(), params.data_ptr(),
            FAMILY_CODES[family], valid.data_ptr(), temp.data_ptr(),
            pdf_norm.data_ptr(), int(bool(lin)), int(bool(apply_iw)),
            self.ptr(logpri), self.ptr(logq), *stream.key,
            stream.generation, stream.tag, stream.max_rounds,
            stream.counters.data_ptr(), v.data_ptr(), accept.data_ptr(),
            lw.data_ptr(), _build.stream_ptr(dev))
        _build.check(err, self.name)
        self.launches += 1
        self.mode_launches[family] += 1
        return v, accept, lw


kernel_accept = KernelAccept()
