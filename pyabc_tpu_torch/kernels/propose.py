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
  valid.

The prior is given as ``Distribution.arrays`` (per-dimension kind, loc,
scale, hi, log_scale). Output: theta ``(B, d)`` float32, the prior
log-density ``(B,)`` float32 and ``valid (B,)`` bool.
"""
from __future__ import annotations

import math

import torch

from . import _build
from .base import Kernel
from .philox import PhiloxStream, lane_blocks, normals, uniform_of, uniforms

N_REDRAWS = 4
#: register cap of the kernel's dim buckets (the K3 buckets)
MAX_DIM = 32
_LOG_2PI = math.log(2.0 * math.pi)


def prior_logpdf_plain(theta: torch.Tensor, prior: dict) -> torch.Tensor:
    """Sum over the dims of the norm / uniform log-densities."""
    d = prior["kind"].shape[0]
    x = theta[:, :d]
    z = (x - prior["loc"]) / prior["scale"]
    lp_norm = -0.5 * (z * z + _LOG_2PI) - prior["log_scale"]
    inside = (x >= prior["loc"]) & (x <= prior["hi"])
    lp_unif = torch.where(inside, -prior["log_scale"],
                          torch.full_like(x, -math.inf))
    parts = torch.where(prior["kind"] == 0, lp_norm, lp_unif)
    out = parts[:, 0]
    for k in range(1, d):
        out = out + parts[:, k]
    return out


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
                  params: dict | None = None):
    """Plain PyTorch version -> (theta, logpri, valid)."""
    dev = prior["loc"].device
    lanes = torch.arange(B, dtype=torch.int64, device=dev)
    d = prior["kind"].shape[0]
    nb = _blocks_per_draw(d)
    if params is None:
        z = normals(stream, lanes, 0, d)
        blocks = nb + torch.arange(nb, dtype=torch.int64, device=dev)
        w = lane_blocks(stream, lanes[:, None], blocks[None, :])
        u = uniform_of(torch.stack(w, dim=-1).reshape(B, 4 * nb)[:, :d])
        theta = torch.where(prior["kind"] == 0,
                            prior["loc"] + prior["scale"] * z,
                            prior["loc"] + prior["scale"] * u)
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
        draw = thetas[idx] + z @ params["chol"].T
        lp = prior_logpdf_plain(draw, prior)
        if theta is None:
            theta, logpri = draw, lp
        else:
            take = ~torch.isfinite(logpri)
            theta = torch.where(take[:, None], draw, theta)
            logpri = torch.where(take, lp, logpri)
    return theta.contiguous(), logpri, torch.isfinite(logpri)


class Propose(Kernel):
    name = "propose"
    source = "pyabc_tpu_torch/csrc/propose.cu"
    replaces = "pyabc_tpu/inference/util.py:415"

    def __call__(self, stream: PhiloxStream, B: int, prior: dict,
                 params: dict | None = None):
        keys = ("kind", "loc", "scale", "hi", "log_scale")
        pt = [] if params is None else [params[k] for k in
                                        ("cdf", "thetas", "chol")]
        if self.on_cpu(stream.counters, *(prior[k] for k in keys), *pt):
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
            self.expect(params["chol"], "chol", f32, (d, d))
            ptrs = [t.data_ptr() for t in pt]
        dev = prior["loc"].device
        theta = torch.empty(B, d, dtype=f32, device=dev)
        logpri = torch.empty(B, dtype=f32, device=dev)
        valid = torch.empty(B, dtype=torch.bool, device=dev)
        k0, k1 = stream.key
        err = _build.library().pyabc_propose(
            B, d, n, *ptrs, *(prior[k].data_ptr() for k in keys), k0, k1,
            stream.generation, stream.tag, stream.max_rounds,
            stream.counters.data_ptr(), N_REDRAWS, theta.data_ptr(),
            logpri.data_ptr(), valid.data_ptr(), _build.stream_ptr(dev))
        _build.check(err, self.name)
        self.launches += 1
        return theta, logpri, valid


propose = Propose()
