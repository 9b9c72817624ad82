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
- prior (``params`` None): theta from the prior (the layout below);
  every lane is valid;
- local (``propose_local``, LocalTransition's fit): the transition mode
  with each ancestor's own factor, theta = thetas[idx] + chols[idx] z.

The prior is given as ``Distribution.arrays``: per dimension its family
code and parameters, the constants of its log-density and a decorator's
lower bound (``core/random_variables.py``). Output: theta ``(B, d)``
float32, the prior log-density ``(B,)`` float32 and ``valid (B,)`` bool.
The log-density is the JAX package's per family, in float32; the draws
follow the JAX samplers' algorithms (their law, not their bits) on this
layout of the prior mode's Philox blocks:

- an undecorated norm or uniform keeps its first blocks: normal k from
  blocks [0, nb), uniform k from word k % 4 of block nb + k // 4 (nb =
  ceil(d / 4)), as before the other families came;
- any other dimension k takes draw number q = 1 + 9 k, a decorated one its
  draws q + j, j < 9 (the first above the bound kept, else 2 bound - x of
  the ninth). Uniform i of draw q is word i % 4 of block (q << 12) | i //
  4 (``philox.cuh::poisson``'s layout), and a second sequence (beta's
  second gamma, t's normal, nbinom's Poisson) is draw q + SECOND_DRAW.
  Draw numbers' blocks start at 4096, past the first blocks' 16 for d <=
  32, and no two draw numbers meet.

A prior whose table flag ``families`` is False (norm and uniform only)
runs the kernel's first code, unchanged.

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

K > 1 local mode (``propose_local.models``, each model a LocalTransition
fit: ``local_transition.py::device_rvs`` through ``_switch_propose_sim``):
the K > 1 mode with model m's per-row factors, theta = thetas[m, idx] +
chols[m, idx] z (stacked ``chols (K, n, d, d)``); counted as
``propose_local``'s launches and in its ``mode_launches["models"]``.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from . import _build
from ..core.random_variables import PRIOR_KEYS
from .base import Kernel
from .philox import (MODEL, POISSON_MAX_UNIFORMS, PhiloxStream, _rdiv,
                     box_muller, lane_blocks, normals, poisson_plain,
                     poisson_uniforms, uniform_of, uniforms)
from .philox import lanes as stream_lanes

N_REDRAWS = 4
#: register cap of the kernel's dim buckets (the K3 buckets)
MAX_DIM = 32
_LOG_2PI = math.log(2.0 * math.pi)
_INF = math.inf

#: family codes (``core/random_variables.py::FAMILIES``)
(NORM, UNIFORM, LOGNORM, EXPON, GAMMA, BETA, LAPLACE, CAUCHY, T, TRUNCNORM,
 RANDINT, BINOM, POISSON, NBINOM) = range(14)
#: draws of a decorated dimension: its draw j (< 9) is draw number
#: ``1 + N_BOUND_DRAWS k + j`` of dimension k (undecorated: j = 0)
N_BOUND_DRAWS = 9
#: a draw's second sequence (beta's second gamma, t's normal, nbinom's
#: Poisson) is draw number ``q + SECOND_DRAW``
SECOND_DRAW = 512
#: Marsaglia-Tsang attempts of one gamma draw (blocks 1.. of its draw)
GAMMA_MAX_ATTEMPTS = 64
#: uniforms of one binomial draw: inversion's iterations, two per BTRS try
BINOM_MAX_UNIFORMS = POISSON_MAX_UNIFORMS
#: float32 constants the kernel uses
PI_F32 = 3.14159274101257324
SQRT2_F32 = 1.41421353816986084
ONE_THIRD_F32 = 0.333333343267440796
#: JAX's Stirling tail values of BTRS (``jax/_src/random.py``)
_STIRLING_TAIL = (0.0810614667953272, 0.0413406959554092, 0.0276779256849983,
                  0.02079067210376509, 0.0166446911898211,
                  0.0138761288230707, 0.0118967099458917, 0.0104112652619720,
                  0.00925546218271273, 0.00833056343336287)
#: blocks a vectorized pass of the plain samplers fetches at once
_PASS_BLOCKS = 4


def _xlogy(a: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``jax.scipy.special.xlogy``: 0 where a is 0."""
    return torch.where(a == 0, torch.zeros_like(a), a * torch.log(y))


def _family_logpdf(x, loc, scale, hi, log_scale, par, f):
    """Family f's log-density at x (every argument broadcast to x); the
    JAX package's formulas (``core/random_variables.py:143-329``) in
    float32, the discrete ones continuous in x."""
    pa, pb, c0, c1, c2 = (par[..., i] for i in range(5))
    neg = torch.full_like(x, -_INF)
    z = (x - loc) / scale
    if f == NORM:
        return -0.5 * (z * z + _LOG_2PI) - log_scale
    if f == UNIFORM:
        return torch.where((x >= loc) & (x <= hi), -log_scale, neg)
    if f == LOGNORM:
        zz = torch.log(x / scale) / pa
        out = -0.5 * (zz * zz + _LOG_2PI) - torch.log(x * pa)
        return torch.where(x > 0, out, neg)
    if f == EXPON:
        return torch.where(z >= 0, -z - log_scale, neg)
    if f == GAMMA:
        out = (_xlogy(pa - 1.0, z) - z) - c0 - log_scale
        return torch.where(z > 0, out, neg)
    if f == BETA:
        t2 = torch.where(pb == 1.0, torch.zeros_like(z),
                         (pb - 1.0) * torch.log1p(-z))
        out = (-c0 + (_xlogy(pa - 1.0, z) + t2)) - log_scale
        return torch.where((z > 0) & (z < 1), out, neg)
    if f == LAPLACE:
        return -(x - loc).abs() / scale - c0
    if f == CAUCHY:
        return -torch.log(c0 * (1.0 + z * z))
    if f == T:
        return -(c0 + c1 * torch.log1p(z * z / pa)) - log_scale
    if f == TRUNCNORM:
        out = (-0.5 * (z * z + _LOG_2PI) - log_scale) - c0
        return torch.where((z >= pa) & (z <= pb), out, neg)
    if f == RANDINT:
        return torch.where((x >= loc) & (x < hi), -log_scale, neg)
    if f == BINOM:
        nx = pa - x
        logc = (c0 - torch.lgamma(x + 1.0)) - torch.lgamma(nx + 1.0)
        out = (logc + torch.where(x == 0, torch.zeros_like(x), x * c1)
               + torch.where(nx == 0, torch.zeros_like(x), nx * c2))
        return torch.where((x >= 0) & (x <= pa), out, neg)
    if f == POISSON:
        out = (x * c0 - pa) - torch.lgamma(x + 1.0)
        return torch.where(x >= 0, out, neg)
    # NBINOM
    logc = (torch.lgamma(x + pa) - c0) - torch.lgamma(x + 1.0)
    out = (logc + pa * c1) + x * c2
    return torch.where(x >= 0, out, neg)


def dims_logpdf_plain(x: torch.Tensor, prior: dict) -> torch.Tensor:
    """Each entry's log-density: ``x (B, d)`` against the prior's
    ``(d,)`` or per-lane ``(B, d)`` table, with a decorator's bound (-inf
    at or below it)."""
    kind = prior["kind"].expand_as(x)
    cols = [prior[k].expand_as(x) for k in ("loc", "scale", "hi",
                                            "log_scale")]
    par = prior["par"].expand(*x.shape, 6)
    out = torch.full_like(x, -_INF)
    for f in kind.unique().tolist():
        out = torch.where(kind == f,
                          _family_logpdf(x, *cols, par, f), out)
    bound = par[..., 5]
    return torch.where((bound != -_INF) & ~(x > bound),
                       torch.full_like(x, -_INF), out)


def prior_logpdf_plain(theta: torch.Tensor, prior: dict,
                       real: torch.Tensor | None = None) -> torch.Tensor:
    """Sum over the dims of the prior's log-densities; ``real`` (B, d)
    masks the dims that count, per lane (a run over several models,
    whose per-lane prior arrays are ``(B, d_max)``)."""
    d = prior["kind"].shape[-1]
    parts = dims_logpdf_plain(theta[:, :d], prior)
    out = parts[:, 0]
    for k in range(1, d):
        out = (out + parts[:, k] if real is None
               else torch.where(real[:, k], out + parts[:, k], out))
    return out


# ------------------------------------------------------- the samplers
def gamma_mt_plain(stream, lanes, q, alpha):
    """Marsaglia-Tsang on ``alpha' = alpha`` (alpha >= 1) or ``alpha + 1``
    -> (d, V), the gamma(alpha') draw being d V; attempt t reads block
    (q << 12) | (1 + t): the cos normal of words 0-1 and the uniform of
    word 2. A lane that fails GAMMA_MAX_ATTEMPTS times keeps V = 1."""
    ap = torch.where(alpha >= 1, alpha, alpha + 1.0)
    d = ap - ONE_THIRD_F32
    c = _rdiv(ONE_THIRD_F32, torch.sqrt(d))
    V = torch.ones_like(alpha)
    todo = torch.ones_like(alpha, dtype=torch.bool)
    t = 0
    while t < GAMMA_MAX_ATTEMPTS and bool(todo.any()):
        sel = todo.nonzero()[:, 0]
        nblk = min(_PASS_BLOCKS, GAMMA_MAX_ATTEMPTS - t)
        w = poisson_uniforms(stream, lanes[sel], q[sel], 1 + t, nblk)
        dd, cc, got = d[sel], c[sel], V[sel]
        done = torch.zeros_like(dd, dtype=torch.bool)
        for a in range(nblk):
            x = box_muller(w[:, 4 * a], w[:, 4 * a + 1], False)
            U = w[:, 4 * a + 2]
            v = 1.0 + x * cc
            X = x * x
            VV = (v * v) * v
            cont = ((U >= 1.0 - 0.0331 * (X * X))
                    & (torch.log(U) >= X * 0.5
                       + dd * ((1.0 - VV) + torch.log(VV))))
            acc = (v > 0) & ~cont & ~done
            got = torch.where(acc, VV, got)
            done = done | acc
        V[sel] = got
        todo[sel] = ~done
        t += nblk
    return d, V


def log_gamma_plain(stream, lanes, q, alpha):
    """log of a gamma(alpha) draw in log space (``jax.random.loggamma``):
    log d + log V, plus log1p(-u) / alpha for alpha < 1 with u word 0 of
    block (q << 12)."""
    return _gamma_parts(stream, lanes, q, alpha)[1]


def gamma_plain(stream, lanes, q, alpha):
    """A gamma(alpha) draw: d V, or the exp of its log-space value for
    alpha < 1."""
    dv, log_g = _gamma_parts(stream, lanes, q, alpha)
    return torch.where(alpha >= 1, dv, torch.exp(log_g))


def _gamma_parts(stream, lanes, q, alpha):
    d, V = gamma_mt_plain(stream, lanes, q, alpha)
    u = poisson_uniforms(stream, lanes, q, 0, 1)[:, 0]
    boost = torch.log1p(-u) * _rdiv(1.0, alpha)
    log_g = ((torch.log(d) + torch.log(V))
             + torch.where(alpha >= 1, torch.zeros_like(boost), boost))
    return d * V, log_g


def _stirling_tail(k):
    use = k <= 9
    kc = k.clamp(0.0, 9.0)
    kp1sq = (kc + 1.0) * (kc + 1.0)
    approx = (1.0 / 12 - (1.0 / 360 - _rdiv(1.0 / 1260, kp1sq)) / kp1sq) / (
        kc + 1.0)
    table = torch.tensor(_STIRLING_TAIL, dtype=torch.float32,
                         device=k.device)
    return torch.where(use, table[torch.floor(kc).long()], approx)


def _binom_inversion(stream, lanes, q, n, qq):
    lm = torch.log1p(-qq)
    num = torch.zeros_like(qq)
    gsum = torch.zeros_like(qq)
    act = (gsum <= n) & (qq != 0)
    i = 0
    while i < BINOM_MAX_UNIFORMS and bool(act.any()):
        sel = act.nonzero()[:, 0]
        u = poisson_uniforms(stream, lanes[sel], q[sel], i // 4,
                             _PASS_BLOCKS)
        nn, gs, ll, cnt = num[sel], gsum[sel], lm[sel], n[sel]
        for j in range(4 * _PASS_BLOCKS):
            a = gs <= cnt
            nn = torch.where(a, nn + 1.0, nn)
            gs = torch.where(a, gs + torch.ceil(torch.log(u[:, j]) / ll), gs)
        num[sel], gsum[sel] = nn, gs
        i += 4 * _PASS_BLOCKS
        act = (gsum <= n) & (qq != 0)
    return torch.where(qq == 0, torch.zeros_like(num), num - 1.0)


def _binom_btrs(stream, lanes, q, n, qq):
    stddev = torch.sqrt((n * qq) * (1.0 - qq))
    b = 1.15 + 2.53 * stddev
    a = (-0.0873 + 0.0248 * b) + 0.01 * qq
    c = n * qq + 0.5
    v_r = 0.92 - _rdiv(4.2, b)
    r = qq / (1.0 - qq)
    alpha = (2.83 + _rdiv(5.1, b)) * stddev
    m = torch.floor((n + 1.0) * qq)
    out = torch.full_like(qq, -1.0)
    todo = torch.ones_like(qq, dtype=torch.bool)
    j = 0
    while j < BINOM_MAX_UNIFORMS // 2 and bool(todo.any()):
        sel = todo.nonzero()[:, 0]
        uni = poisson_uniforms(stream, lanes[sel], q[sel], j // 2,
                               _PASS_BLOCKS)
        nn, bb, aa, cc, vr, rr, al, mm = (t[sel] for t in (
            n, b, a, c, v_r, r, alpha, m))
        got = torch.full_like(nn, -1.0)
        done = torch.zeros_like(nn, dtype=torch.bool)
        for att in range(2 * _PASS_BLOCKS):
            u = uni[:, 2 * att] - 0.5
            v = uni[:, 2 * att + 1]
            us = 0.5 - u.abs()
            accept1 = (us >= 0.07) & (v <= vr)
            k = torch.floor(((2.0 * aa) / us + bb) * u + cc)
            reject = (k < 0) | (k > nn)
            v2 = torch.log((v * al) / (aa / (us * us) + bb))
            nm1, nk1 = (nn - mm) + 1.0, (nn - k) + 1.0
            ub = (((((((mm + 0.5) * torch.log((mm + 1.0) / (rr * nm1))
                       + (nn + 1.0) * torch.log(nm1 / nk1))
                      + (k + 0.5) * torch.log((rr * nk1) / (k + 1.0)))
                     + _stirling_tail(mm)) + _stirling_tail(nn - mm))
                   - _stirling_tail(k)) - _stirling_tail(nn - k))
            acc = (accept1 | (~reject & (v2 <= ub))) & ~done
            got = torch.where(acc, k, got)
            done = done | acc
        out[sel] = got
        todo[sel] = ~done
        j += 2 * _PASS_BLOCKS
    return out


def binom_plain(stream, lanes, q, n, p):
    """``jax.random.binomial``'s algorithm (``_binomial``): inversion
    by geometric jumps where n q <= 10 (q = min(p, 1 - p)), BTRS
    otherwise, reflected for p >= 0.5. Inversion takes uniform i at its
    iteration i, BTRS uniforms 2j and 2j + 1 at its try j; at the cap
    inversion gives the count it reached and BTRS -1, as JAX's loops at
    theirs. q = 0 gives 0 at once (JAX's inversion loop does not end
    there)."""
    p_lt = p < 0.5
    qq = torch.where(p_lt, p, 1.0 - p)
    bad = torch.isnan(qq) | (qq < 0) | (n < 0)
    qq = torch.where(bad, torch.full_like(qq, 0.01), qq)
    inv = (n < 0) | (n * qq <= 10.0)
    out = torch.empty_like(qq)
    for mask, fn in ((inv, _binom_inversion), (~inv, _binom_btrs)):
        idx = mask.nonzero()[:, 0]
        if idx.numel():
            out[idx] = fn(stream, lanes[idx], q[idx], n[idx], qq[idx])
    out = torch.where(bad, torch.full_like(out, math.nan), out)
    return torch.where(p_lt | bad, out, n - out)


def family_draw_plain(stream, lanes, q, kind, loc, scale, hi, par):
    """One draw per lane of draw number q from its family (per-lane 1-D
    tensors); the uniforms of draw q (and of ``q + SECOND_DRAW``) only."""
    pa, pb, c0, c1, c2 = (par[:, i] for i in range(5))
    out = torch.empty_like(loc)
    for f in kind.unique().tolist():
        s = (kind == f).nonzero()[:, 0]
        ln, qs = lanes[s], q[s]
        lo, sc, h, a, b = loc[s], scale[s], hi[s], pa[s], pb[s]
        if f in (NORM, UNIFORM, LOGNORM, EXPON, LAPLACE, CAUCHY, TRUNCNORM,
                 RANDINT):
            w = poisson_uniforms(stream, ln, qs, 0, 1)
            u0 = w[:, 0]
            z = box_muller(w[:, 0], w[:, 1], False)
        if f == NORM:
            x = lo + sc * z
        elif f == UNIFORM:
            x = lo + sc * u0
        elif f == LOGNORM:
            x = sc * torch.exp(a * z)
        elif f == EXPON:
            x = lo + sc * -torch.log1p(-u0)
        elif f == GAMMA:
            x = lo + sc * gamma_plain(stream, ln, qs, a)
        elif f == BETA:
            la = log_gamma_plain(stream, ln, qs, a)
            lb = log_gamma_plain(stream, ln, qs + SECOND_DRAW, b)
            top = torch.maximum(la, lb)
            ga, gb = torch.exp(la - top), torch.exp(lb - top)
            x = lo + sc * (ga / (ga + gb))
        elif f == LAPLACE:
            u = 2.0 * u0 - 1.0
            x = lo + sc * (torch.sign(u) * torch.log1p(-u.abs()))
        elif f == CAUCHY:
            x = lo + sc * torch.tan(PI_F32 * (u0 - 0.5))
        elif f == T:
            half = a * 0.5
            g = gamma_plain(stream, ln, qs, half)
            w2 = poisson_uniforms(stream, ln, qs + SECOND_DRAW, 0, 1)
            nz = box_muller(w2[:, 0], w2[:, 1], False)
            x = lo + sc * (nz * torch.sqrt(half / g))
        elif f == TRUNCNORM:
            A, Bv = c1[s], c2[s]
            u = torch.maximum(A, u0 * (Bv - A) + A)
            y = SQRT2_F32 * torch.erfinv(u)
            y = torch.minimum(torch.maximum(
                y, torch.nextafter(a, torch.full_like(a, _INF))),
                torch.nextafter(b, torch.full_like(b, -_INF)))
            x = lo + sc * y
        elif f == RANDINT:
            x = torch.minimum(torch.floor(lo + sc * u0), h - 1.0)
        elif f == BINOM:
            x = binom_plain(stream, ln, qs, a, b)
        elif f == POISSON:
            x = poisson_plain(stream, ln, qs, a)
        else:  # NBINOM
            lam = (gamma_plain(stream, ln, qs, a) * (1.0 - b)) / b
            x = poisson_plain(stream, ln, qs + SECOND_DRAW, lam)
        out[s] = x
    return out


def prior_draw_plain(stream: PhiloxStream, lanes: torch.Tensor,
                     prior: dict, d: int) -> torch.Tensor:
    """Theta from the prior (per-dimension ``(d,)`` or per-lane ``(B, d)``
    tables). An undecorated norm or uniform keeps its first blocks: normals
    from blocks [0, nb), uniforms from word k % 4 of block nb + k // 4 (nb =
    ceil(d / 4)). Any other dimension k takes draw number q = 1 + 9 k (its
    blocks (q << 12) | i, ``family_draw_plain``); a decorated one its draws
    q + j, j < 9, the first above the bound kept, else ``2 bound - x`` of
    the last."""
    B = lanes.shape[0]
    nb = _blocks_per_draw(d)
    z = normals(stream, lanes, 0, d)
    blocks = nb + torch.arange(nb, dtype=torch.int64, device=lanes.device)
    w = lane_blocks(stream, lanes[:, None], blocks[None, :])
    u = uniform_of(torch.stack(w, dim=-1).reshape(B, 4 * nb)[:, :d])
    kind = prior["kind"].expand(B, d)
    loc, scale, hi = (prior[k].expand(B, d) for k in ("loc", "scale", "hi"))
    par = prior["par"].expand(B, d, 6)
    theta = torch.where(kind == NORM, loc + scale * z, loc + scale * u)
    bound = par[..., 5]
    fam = (kind > UNIFORM) | (bound != -_INF)
    for k in range(d):
        s = fam[:, k].nonzero()[:, 0]
        if not s.numel():
            continue
        args = (kind[s, k], loc[s, k], scale[s, k], hi[s, k], par[s, k])
        q = torch.full_like(s, 1 + N_BOUND_DRAWS * k)
        x = family_draw_plain(stream, lanes[s], q, *args)
        bnd = bound[s, k]
        for j in range(1, N_BOUND_DRAWS):
            low = ((bnd != -_INF) & ~(x > bnd)).nonzero()[:, 0]
            if not low.numel():
                break
            x[low] = family_draw_plain(stream, lanes[s][low], q[low] + j,
                                       *(a[low] for a in args))
        theta[s, k] = torch.where((bnd != -_INF) & ~(x > bnd),
                                  2.0 * bnd - x, x)
    return theta


def unbounded_prior(d: int, device) -> dict:
    """Prior arrays with no bounds: uniform on [-inf, inf] with log density
    0, so every finite draw is kept."""
    f32 = torch.float32
    par = torch.zeros(d, 6, dtype=f32, device=device)
    par[:, 5] = -_INF
    return {"kind": torch.ones(d, dtype=torch.int32, device=device),
            "loc": torch.full((d,), -_INF, dtype=f32, device=device),
            "scale": torch.ones(d, dtype=f32, device=device),
            "hi": torch.full((d,), _INF, dtype=f32, device=device),
            "log_scale": torch.zeros(d, dtype=f32, device=device),
            "par": par}


def _blocks_per_draw(d: int) -> int:
    return (d + 3) // 4


def propose_plain(stream: PhiloxStream, B: int, prior: dict,
                  params: dict | None = None, local: bool = False):
    """Plain PyTorch version -> (theta, logpri, valid); ``local`` draws
    with the ancestor's own factor ``chols[idx]`` (LocalTransition)."""
    dev = prior["loc"].device
    lanes = stream_lanes(stream, B)
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
    lanes = stream_lanes(stream, B)
    w = lane_blocks(model_stream(stream), lanes,
                    torch.zeros((), dtype=torch.int64, device=lanes.device))
    if mpk is None:
        return categorical_plain(model_p.expand(B, -1), uniform_of(w[0]))
    anc = categorical_plain(torch.exp(model_p).expand(B, -1),
                            uniform_of(w[0]))
    return categorical_plain(mpk[anc.long()], uniform_of(w[1]))


def propose_models_plain(stream: PhiloxStream, B: int, priors: dict,
                         model_p: torch.Tensor, params: dict | None = None,
                         mpk: torch.Tensor | None = None,
                         local: bool = False,
                         model_logits: torch.Tensor | None = None):
    """Plain PyTorch version of the K > 1 mode -> (theta, logpri, valid,
    m). ``priors`` is ``random_variables.stacked_arrays``; ``local`` draws
    with the ancestor's own factor ``chols[m, idx]``; ``model_logits``
    (prior mode) adds the lane's model's log prior to its logpri."""
    dev = priors["loc"].device
    K, d = priors["loc"].shape
    m = draw_models_plain(stream, B, model_p,
                          None if params is None else mpk).long()
    lanes = stream_lanes(stream, B)
    nb = _blocks_per_draw(d)
    lane_prior = {k: priors[k][m] for k in PRIOR_KEYS}
    real = torch.arange(d, device=dev)[None, :] < priors["dims"][m][:, None]
    if params is None:
        theta = torch.where(real, prior_draw_plain(stream, lanes, lane_prior,
                                                   d), 0.0)
        logpri = prior_logpdf_plain(theta, lane_prior, real)
        if model_logits is not None:
            logpri = model_logits[m] + logpri
        return (theta.contiguous(), logpri,
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
        chol = params["chols"][m, idx] if local else params["chol"][m]
        draw = thetas[m, idx] + torch.einsum("bkl,bl->bk", chol, z)
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


def families(prior: dict) -> bool:
    """The table's host flag (``Distribution.arrays``): True when a
    dimension is neither an undecorated norm nor an undecorated uniform. A
    table built by hand without it holds norm and uniform dims only."""
    return bool(prior.get("families", False))


class Propose(Kernel):
    name = "propose"
    source = "pyabc_tpu_torch/csrc/propose.cu"
    replaces = "pyabc_tpu/inference/util.py:415"

    def __init__(self):
        super().__init__()
        #: launches whose prior holds a family other than an undecorated
        #: norm or uniform (``"propose:families"``), every mode; launches
        #: over a block of a round whose first lane is not 0 (a device mesh
        #: rank's, ``"propose:lane_base"``)
        self.mode_launches = {"families": 0, "lane_base": 0}

    def _count(self, prior: dict, stream: PhiloxStream) -> None:
        self.launches += 1
        if families(prior):
            self.mode_launches["families"] += 1
        if stream.lane0:
            self.mode_launches["lane_base"] += 1

    def __call__(self, stream: PhiloxStream, B: int, prior: dict,
                 params: dict | None = None):
        return self._draw(stream, B, prior, params, local=False)

    def _draw(self, stream: PhiloxStream, B: int, prior: dict,
              params: dict | None, local: bool):
        """Both single-model modes: the MVN fit's shared ``chol`` or, with
        ``local``, LocalTransition's per-row ``chols``."""
        chol = "chols" if local else "chol"
        pt = [] if params is None else [params[k] for k in
                                        ("cdf", "thetas", chol)]
        if self.on_cpu(stream.counters, *(prior[k] for k in PRIOR_KEYS),
                       *pt):
            if local:
                return propose_local_plain(stream, B, prior, params)
            return propose_plain(stream, B, prior, params)
        d = prior["kind"].shape[0]
        if d > MAX_DIM:
            raise ValueError(f"{self.name}: dim {d} above the kernel's "
                             f"register cap {MAX_DIM}")
        f32 = torch.float32
        self.expect(prior["kind"], "prior.kind", torch.int32, (d,))
        for k in PRIOR_KEYS[1:5]:
            self.expect(prior[k], f"prior.{k}", f32, (d,))
        self.expect(prior["par"], "prior.par", f32, (d, 6))
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
            B, d, n, *ptrs, int(local),
            *(prior[k].data_ptr() for k in PRIOR_KEYS),
            int(families(prior)), k0, k1, stream.generation, stream.tag,
            stream.max_rounds, int(stream.lane0),
            stream.counters.data_ptr(), N_REDRAWS, theta.data_ptr(),
            logpri.data_ptr(), valid.data_ptr(), _build.stream_ptr(dev))
        _build.check(err, self.name)
        self._count(prior, stream)
        return theta, logpri, valid

    def models(self, stream: PhiloxStream, B: int, priors: dict,
               model_p: torch.Tensor, params: dict | None = None,
               mpk: torch.Tensor | None = None,
               model_logits: torch.Tensor | None = None):
        """The K > 1 mode -> (theta ``(B, d_max)``, logpri, valid, m). In
        the prior mode ``model_logits`` (the ``(K,)`` log model prior)
        makes logpri the proposal's log density, the lane's model's log
        prior added (K26's prior and calibration rounds)."""
        return self._models(stream, B, priors, model_p, params, mpk,
                            local=False, model_logits=model_logits)

    def _models(self, stream: PhiloxStream, B: int, priors: dict,
                model_p: torch.Tensor, params: dict | None,
                mpk: torch.Tensor | None, local: bool,
                model_logits: torch.Tensor | None = None):
        """Both K > 1 modes: the models' MVN factors ``chol (K, d, d)``
        or, with ``local``, LocalTransition's ``chols (K, n, d, d)``."""
        if model_logits is not None and params is not None:
            raise ValueError(f"{self.name}: model_logits is the prior "
                             "mode's")
        keys = PRIOR_KEYS + ("dims",)
        chol = "chols" if local else "chol"
        pt = [] if params is None else [params[k] for k in
                                        ("cdf", "thetas", chol)] + [mpk]
        ml = [] if model_logits is None else [model_logits]
        if self.on_cpu(stream.counters, model_p,
                       *(priors[k] for k in keys), *pt, *ml):
            return propose_models_plain(stream, B, priors, model_p, params,
                                        mpk, local=local,
                                        model_logits=model_logits)
        K, d = priors["loc"].shape
        if d > MAX_DIM:
            raise ValueError(f"{self.name}: dim {d} above the kernel's "
                             f"register cap {MAX_DIM}")
        f32, i32 = torch.float32, torch.int32
        self.expect(priors["kind"], "priors.kind", i32, (K, d))
        for k in PRIOR_KEYS[1:5]:
            self.expect(priors[k], f"priors.{k}", f32, (K, d))
        self.expect(priors["par"], "priors.par", f32, (K, d, 6))
        self.expect(priors["dims"], "priors.dims", i32, (K,))
        self.expect(model_p, "model_p", f32, (K,))
        if model_logits is not None:
            self.expect(model_logits, "model_logits", f32, (K,))
        self.expect(stream.counters, "counters", i32,
                    (stream.counters.shape[0],))
        n = 0
        ptrs = [None, None, None, None]
        if params is not None:
            n = params["thetas"].shape[1]
            self.expect(params["cdf"], "cdf", f32, (K, n))
            self.expect(params["thetas"], "thetas", f32, (K, n, d))
            self.expect(params[chol], chol, f32,
                        (K, n, d, d) if local else (K, d, d))
            self.expect(mpk, "mpk", f32, (K, K))
            ptrs = [t.data_ptr() for t in pt]
        dev = priors["loc"].device
        theta = torch.empty(B, d, dtype=f32, device=dev)
        logpri = torch.empty(B, dtype=f32, device=dev)
        valid = torch.empty(B, dtype=torch.bool, device=dev)
        m = torch.empty(B, dtype=i32, device=dev)
        k0, k1 = stream.key
        err = _build.library().pyabc_propose_models(
            B, K, d, n, *ptrs[:3], int(local),
            *(priors[k].data_ptr() for k in PRIOR_KEYS),
            int(families(priors)), priors["dims"].data_ptr(),
            model_p.data_ptr(), ptrs[3],
            None if model_logits is None else model_logits.data_ptr(), k0,
            k1, stream.generation,
            stream.tag, MODEL, stream.max_rounds, int(stream.lane0),
            stream.counters.data_ptr(), N_REDRAWS, theta.data_ptr(),
            logpri.data_ptr(), valid.data_ptr(), m.data_ptr(),
            _build.stream_ptr(dev))
        _build.check(err, self.name)
        self._count(priors, stream)
        if local:
            self.mode_launches["models"] += 1
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

    def __init__(self):
        super().__init__()
        #: the K > 1 local mode's launches (``"propose_local:models"``)
        self.mode_launches["models"] = 0

    def __call__(self, stream: PhiloxStream, B: int, prior: dict,
                 params: dict):
        return self._draw(stream, B, prior, params, local=True)

    def models(self, stream: PhiloxStream, B: int, priors: dict,
               model_p: torch.Tensor, params: dict,
               mpk: torch.Tensor):
        """K2's K > 1 local mode: the lane's model as ``propose.models``
        draws it, then the ancestor from that model's ``cdf`` and theta =
        thetas[m, idx] + chols[m, idx] z with the N_REDRAWS redraws against
        that model's prior -> (theta ``(B, d_max)``, logpri, valid, m)."""
        return self._models(stream, B, priors, model_p, params, mpk,
                            local=True)


propose_local = ProposeLocal()
