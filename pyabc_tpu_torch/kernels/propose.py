"""K2 (with K1): the proposal of one round, drawing its own Philox numbers.

Counterpart of ``pyabc_tpu/inference/util.py::_switch_propose_sim`` (the
redraws), ``_lane_transition``, ``_lane_prior``,
``transition/multivariatenormal.py::device_rvs`` and
``Distribution.rvs_array`` / ``logpdf_array``; the CUDA kernel is
``csrc/propose.cu``.

Two modes, one thread per lane:

- transition (``params`` given): the weighted ancestor by inverse CDF over
  the fit's ``cdf`` (zero-weight rows are never picked, the scaled uniform
  stays below the total), theta = thetas[idx] + chol z, and up to
  ``N_REDRAWS`` draws against zero prior mass, each at its own fixed place
  in the stream: the first draw with a finite prior log-density is kept,
  else the last. Redraw j reads block j (1 + nb) word 0 for the ancestor
  and blocks from j (1 + nb) + 1 for its d normals (nb = ceil(d / 4));
- prior (``params`` None): theta from the prior, normals from blocks
  [0, nb), uniforms from word k % 4 of block nb + k // 4; every lane is
  valid;
- local (``propose_local``, LocalTransition's fit): the transition mode
  with each ancestor's own factor, theta = thetas[idx] + chols[idx] z.

The prior is given as ``Distribution.arrays`` (per-dimension kind, loc,
scale, hi, log_scale). Output: theta ``(B, d)`` float32, the prior
log-density ``(B,)`` float32 and ``valid (B,)`` bool.

K > 1 mode (``propose.models``, a run over several models, with K26's
draws in the kernel): each lane first draws its model index on the MODEL
Philox stream, block 0: word 0 gives the prior model (prior mode, by
inverse CDF over the model prior) or the ancestor model (transition mode,
over ``exp(log_model_probs)``), word 1 the perturbed model from the
ancestor's row of the masked perturbation matrix. Then model m's prior or
model m's fit (stacked ``(K, ...)`` params) draws theta as above, with
``nb = ceil(d_max / 4)``; entries past model m's dim are exactly 0. It also
returns the model index ``m (B,)`` int32. The categorical draws are
inverse CDFs on the probabilities: the law of ``jax.random.categorical``,
not its bits (a declared difference).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from . import _build
from .base import Kernel
from .philox import (MODEL, PhiloxStream, lane_blocks, normals, uniform_of,
                     uniforms)

N_REDRAWS = 4
#: register cap of the kernel's dim buckets (the K3 buckets)
MAX_DIM = 32
_LOG_2PI = math.log(2.0 * math.pi)


def prior_logpdf_plain(theta: torch.Tensor, prior: dict,
                       real: torch.Tensor | None = None) -> torch.Tensor:
    """Sum over the dims of the norm / uniform log-densities; ``real``
    (B, d) masks the dims that count, per lane (a run over several models,
    whose per-lane prior arrays are ``(B, d_max)``)."""
    d = prior["kind"].shape[-1]
    x = theta[:, :d]
    z = (x - prior["loc"]) / prior["scale"]
    lp_norm = -0.5 * (z * z + _LOG_2PI) - prior["log_scale"]
    inside = (x >= prior["loc"]) & (x <= prior["hi"])
    lp_unif = torch.where(inside, -prior["log_scale"],
                          torch.full_like(x, -math.inf))
    parts = torch.where(prior["kind"] == 0, lp_norm, lp_unif)
    out = parts[:, 0]
    for k in range(1, d):
        out = (out + parts[:, k] if real is None
               else torch.where(real[:, k], out + parts[:, k], out))
    return out


def prior_draw_plain(stream: PhiloxStream, lanes: torch.Tensor,
                     prior: dict, d: int) -> torch.Tensor:
    """Theta from the prior: normals from blocks [0, nb), uniforms from
    word k % 4 of block nb + k // 4 (nb = ceil(d / 4))."""
    nb = _blocks_per_draw(d)
    z = normals(stream, lanes, 0, d)
    blocks = nb + torch.arange(nb, dtype=torch.int64, device=lanes.device)
    w = lane_blocks(stream, lanes[:, None], blocks[None, :])
    u = uniform_of(torch.stack(w, dim=-1).reshape(lanes.shape[0],
                                                   4 * nb)[:, :d])
    return torch.where(prior["kind"] == 0, prior["loc"] + prior["scale"] * z,
                       prior["loc"] + prior["scale"] * u)


def unbounded_prior(d: int, device) -> dict:
    """Prior arrays with no bounds: uniform on [-inf, inf] with log density
    0, so every finite draw is kept."""
    f32 = torch.float32
    return {"kind": torch.ones(d, dtype=torch.int32, device=device),
            "loc": torch.full((d,), -math.inf, dtype=f32, device=device),
            "scale": torch.ones(d, dtype=f32, device=device),
            "hi": torch.full((d,), math.inf, dtype=f32, device=device),
            "log_scale": torch.zeros(d, dtype=f32, device=device)}


def _blocks_per_draw(d: int) -> int:
    return (d + 3) // 4


def propose_plain(stream: PhiloxStream, B: int, prior: dict,
                  params: dict | None = None, local: bool = False):
    """Plain PyTorch version -> (theta, logpri, valid); ``local`` draws
    with the ancestor's own factor ``chols[idx]`` (LocalTransition)."""
    dev = prior["loc"].device
    lanes = torch.arange(B, dtype=torch.int64, device=dev)
    d = prior["kind"].shape[0]
    nb = _blocks_per_draw(d)
    if params is None:
        theta = prior_draw_plain(stream, lanes, prior, d)
        logpri = prior_logpdf_plain(theta, prior)
        return theta, logpri, torch.ones(B, dtype=torch.bool, device=dev)
    cdf, thetas = params["cdf"], params["thetas"]
    n = thetas.shape[0]
    total = cdf[-1]
    below = torch.nextafter(total, torch.zeros_like(total))
    theta = logpri = None
    for j in range(N_REDRAWS):
        base = j * (1 + nb)
        u = torch.minimum(uniforms(stream, lanes, base, 0) * total, below)
        # all-zero weights leave no row with mass: the clamp takes the last
        idx = torch.searchsorted(cdf, u, right=True).clamp(max=n - 1)
        z = normals(stream, lanes, base + 1, d)
        draw = thetas[idx] + (
            torch.einsum("bkl,bl->bk", params["chols"][idx], z) if local
            else z @ params["chol"].T)
        lp = prior_logpdf_plain(draw, prior)
        if theta is None:
            theta, logpri = draw, lp
        else:
            take = ~torch.isfinite(logpri)
            theta = torch.where(take[:, None], draw, theta)
            logpri = torch.where(take, lp, logpri)
    return theta.contiguous(), logpri, torch.isfinite(logpri)


def categorical_plain(p: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF draw from the rows of ``p (..., K)`` with uniforms
    ``u (...)``: the first k whose running float32 sum exceeds u * total
    (capped just below the total), so a zero-probability entry is never
    drawn; an all-zero row draws uniformly."""
    K = p.shape[-1]
    cum = [p[..., 0]]
    for k in range(1, K):
        cum.append(cum[-1] + p[..., k])
    cum = torch.stack(cum, dim=-1)
    total = cum[..., -1]
    x = torch.minimum(u * total, torch.nextafter(total,
                                                 torch.zeros_like(total)))
    idx = (cum <= x[..., None]).sum(dim=-1).clamp(max=K - 1)
    flat = (u * K).to(torch.int64).clamp(max=K - 1)
    return torch.where(total > 0, idx, flat).to(torch.int32)


def model_stream(stream: PhiloxStream) -> PhiloxStream:
    """The MODEL stream beside a round's theta stream."""
    return dataclasses.replace(stream, tag=MODEL)


def draw_models_plain(stream: PhiloxStream, B: int, model_p: torch.Tensor,
                      mpk: torch.Tensor | None = None) -> torch.Tensor:
    """The lanes' model indices: from the model prior ``model_p`` (mpk
    None), else the ancestor from ``exp(model_p)`` (log model
    probabilities) and its perturbation by row of ``mpk``."""
    lanes = torch.arange(B, dtype=torch.int64, device=model_p.device)
    w = lane_blocks(model_stream(stream), lanes,
                    torch.zeros((), dtype=torch.int64, device=lanes.device))
    if mpk is None:
        return categorical_plain(model_p.expand(B, -1), uniform_of(w[0]))
    anc = categorical_plain(torch.exp(model_p).expand(B, -1),
                            uniform_of(w[0]))
    return categorical_plain(mpk[anc.long()], uniform_of(w[1]))


def propose_models_plain(stream: PhiloxStream, B: int, priors: dict,
                         model_p: torch.Tensor, params: dict | None = None,
                         mpk: torch.Tensor | None = None):
    """Plain PyTorch version of the K > 1 mode -> (theta, logpri, valid,
    m). ``priors`` is ``random_variables.stacked_arrays``."""
    dev = priors["loc"].device
    K, d = priors["loc"].shape
    m = draw_models_plain(stream, B, model_p,
                          None if params is None else mpk).long()
    lanes = torch.arange(B, dtype=torch.int64, device=dev)
    nb = _blocks_per_draw(d)
    lane_prior = {k: priors[k][m] for k in ("kind", "loc", "scale", "hi",
                                            "log_scale")}
    real = torch.arange(d, device=dev)[None, :] < priors["dims"][m][:, None]
    if params is None:
        theta = torch.where(real, prior_draw_plain(stream, lanes, lane_prior,
                                                   d), 0.0)
        return (theta.contiguous(),
                prior_logpdf_plain(theta, lane_prior, real),
                torch.ones(B, dtype=torch.bool, device=dev),
                m.to(torch.int32))
    cdf, thetas = params["cdf"][m], params["thetas"]
    n = thetas.shape[1]
    total = cdf[:, -1]
    below = torch.nextafter(total, torch.zeros_like(total))
    theta = logpri = None
    for j in range(N_REDRAWS):
        base = j * (1 + nb)
        u = torch.minimum(uniforms(stream, lanes, base, 0) * total, below)
        idx = (cdf <= u[:, None]).sum(dim=1).clamp(max=n - 1)
        idx = torch.where(torch.isnan(u), n - 1, idx)
        z = normals(stream, lanes, base + 1, d)
        draw = thetas[m, idx] + torch.einsum("bkl,bl->bk",
                                             params["chol"][m], z)
        draw = torch.where(real, draw, 0.0)
        lp = prior_logpdf_plain(draw, lane_prior, real)
        if theta is None:
            theta, logpri = draw, lp
        else:
            take = ~torch.isfinite(logpri)
            theta = torch.where(take[:, None], draw, theta)
            logpri = torch.where(take, lp, logpri)
    return (theta.contiguous(), logpri, torch.isfinite(logpri),
            m.to(torch.int32))


class Propose(Kernel):
    name = "propose"
    source = "pyabc_tpu_torch/csrc/propose.cu"
    replaces = "pyabc_tpu/inference/util.py:415"

    def __call__(self, stream: PhiloxStream, B: int, prior: dict,
                 params: dict | None = None):
        return self._draw(stream, B, prior, params, local=False)

    def _draw(self, stream: PhiloxStream, B: int, prior: dict,
              params: dict | None, local: bool):
        """Both single-model modes: the MVN fit's shared ``chol`` or, with
        ``local``, LocalTransition's per-row ``chols``."""
        keys = ("kind", "loc", "scale", "hi", "log_scale")
        chol = "chols" if local else "chol"
        pt = [] if params is None else [params[k] for k in
                                        ("cdf", "thetas", chol)]
        if self.on_cpu(stream.counters, *(prior[k] for k in keys), *pt):
            if local:
                return propose_local_plain(stream, B, prior, params)
            return propose_plain(stream, B, prior, params)
        d = prior["kind"].shape[0]
        if d > MAX_DIM:
            raise ValueError(f"{self.name}: dim {d} above the kernel's "
                             f"register cap {MAX_DIM}")
        f32 = torch.float32
        self.expect(prior["kind"], "prior.kind", torch.int32, (d,))
        for k in keys[1:]:
            self.expect(prior[k], f"prior.{k}", f32, (d,))
        self.expect(stream.counters, "counters", torch.int32,
                    (stream.counters.shape[0],))
        n = 0
        ptrs = [None, None, None]
        if params is not None:
            n = params["thetas"].shape[0]
            self.expect(params["cdf"], "cdf", f32, (n,))
            self.expect(params["thetas"], "thetas", f32, (n, d))
            self.expect(params[chol], chol, f32,
                        (n, d, d) if local else (d, d))
            ptrs = [t.data_ptr() for t in pt]
        dev = prior["loc"].device
        theta = torch.empty(B, d, dtype=f32, device=dev)
        logpri = torch.empty(B, dtype=f32, device=dev)
        valid = torch.empty(B, dtype=torch.bool, device=dev)
        k0, k1 = stream.key
        err = _build.library().pyabc_propose(
            B, d, n, *ptrs, int(local), *(prior[k].data_ptr() for k in keys),
            k0, k1, stream.generation, stream.tag, stream.max_rounds,
            stream.counters.data_ptr(), N_REDRAWS, theta.data_ptr(),
            logpri.data_ptr(), valid.data_ptr(), _build.stream_ptr(dev))
        _build.check(err, self.name)
        self.launches += 1
        return theta, logpri, valid

    def models(self, stream: PhiloxStream, B: int, priors: dict,
               model_p: torch.Tensor, params: dict | None = None,
               mpk: torch.Tensor | None = None):
        """The K > 1 mode -> (theta ``(B, d_max)``, logpri, valid, m)."""
        keys = ("kind", "loc", "scale", "hi", "log_scale", "dims")
        pt = [] if params is None else [params[k] for k in
                                        ("cdf", "thetas", "chol")] + [mpk]
        if self.on_cpu(stream.counters, model_p,
                       *(priors[k] for k in keys), *pt):
            return propose_models_plain(stream, B, priors, model_p, params,
                                        mpk)
        K, d = priors["loc"].shape
        if d > MAX_DIM:
            raise ValueError(f"{self.name}: dim {d} above the kernel's "
                             f"register cap {MAX_DIM}")
        f32, i32 = torch.float32, torch.int32
        self.expect(priors["kind"], "priors.kind", i32, (K, d))
        for k in keys[1:5]:
            self.expect(priors[k], f"priors.{k}", f32, (K, d))
        self.expect(priors["dims"], "priors.dims", i32, (K,))
        self.expect(model_p, "model_p", f32, (K,))
        self.expect(stream.counters, "counters", i32,
                    (stream.counters.shape[0],))
        n = 0
        ptrs = [None, None, None, None]
        if params is not None:
            n = params["thetas"].shape[1]
            self.expect(params["cdf"], "cdf", f32, (K, n))
            self.expect(params["thetas"], "thetas", f32, (K, n, d))
            self.expect(params["chol"], "chol", f32, (K, d, d))
            self.expect(mpk, "mpk", f32, (K, K))
            ptrs = [t.data_ptr() for t in pt]
        dev = priors["loc"].device
        theta = torch.empty(B, d, dtype=f32, device=dev)
        logpri = torch.empty(B, dtype=f32, device=dev)
        valid = torch.empty(B, dtype=torch.bool, device=dev)
        m = torch.empty(B, dtype=i32, device=dev)
        k0, k1 = stream.key
        err = _build.library().pyabc_propose_models(
            B, K, d, n, *ptrs[:3], *(priors[k].data_ptr() for k in keys),
            model_p.data_ptr(), ptrs[3], k0, k1, stream.generation,
            stream.tag, MODEL, stream.max_rounds, stream.counters.data_ptr(),
            N_REDRAWS, theta.data_ptr(), logpri.data_ptr(), valid.data_ptr(),
            m.data_ptr(), _build.stream_ptr(dev))
        _build.check(err, self.name)
        self.launches += 1
        return theta, logpri, valid, m


propose = Propose()


def propose_local_plain(stream: PhiloxStream, B: int, prior: dict,
                        params: dict):
    """Plain PyTorch version of K2's local mode."""
    return propose_plain(stream, B, prior, params, local=True)


class ProposeLocal(Propose):
    """K2's local mode (K14's draw): the ancestor by inverse CDF over the
    fit's ``cdf``, exactly as the MVN mode, then ``thetas[idx] +
    chols[idx] z`` with LocalTransition's per-row factors
    (``pyabc_tpu/transition/local_transition.py::device_rvs``), the same
    Philox block layout and the ``N_REDRAWS`` redraws against zero prior
    mass. The same CUDA kernel as ``propose``, counted on its own."""

    name = "propose_local"
    replaces = "pyabc_tpu/transition/local_transition.py:432"

    def __call__(self, stream: PhiloxStream, B: int, prior: dict,
                 params: dict):
        return self._draw(stream, B, prior, params, local=True)


propose_local = ProposeLocal()
