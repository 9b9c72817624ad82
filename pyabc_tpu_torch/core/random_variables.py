"""Random variables and priors on batched torch tensors.

The ``pyabc_tpu.core.random_variables`` counterpart: ``RV(name, *args)``
for the JAX package's fourteen families in scipy's conventions (uniform,
norm, lognorm, expon, gamma, beta, laplace, cauchy, t, truncnorm, randint,
binom, poisson, nbinom), ``LowerBoundDecorator`` around one of them, and
``Distribution``, their named product. On the run's path the K2 kernel
draws and scores the prior itself, from the per-dimension table of
``Distribution.arrays``; ``rvs_array`` and ``logpdf_array`` are the batched
twins of the JAX per-lane functions for callers outside the rounds.

The table (``arrays``), one entry per dimension, the family's code the
index in ``FAMILIES``:

- ``kind`` int32; ``loc``, ``scale``, ``hi``, ``log_scale`` float32: the
  location, the scale, the upper edge of the support where it has one
  (uniform ``loc + scale``, randint ``high``; else +inf) and ``log(scale)``
  (randint: ``log(high - low)``, with ``loc = low``, ``scale = high -
  low``);
- ``par`` float32 ``(d, 6)``: ``[pa, pb, c0, c1, c2, bound]``, the family's
  shape parameters, three constants of its log-density computed on the
  host in float64 and rounded once to float32 (where the JAX package
  computes them from Python floats), and the lower bound of a
  ``LowerBoundDecorator`` (-inf undecorated):

  ======== ========= ====== ================== ============= ===========
  family   pa        pb     c0                 c1            c2
  ======== ========= ====== ================== ============= ===========
  lognorm  s
  gamma    a                gammaln(a)
  beta     a         b      betaln(a, b)
  laplace                   log(2 scale)
  cauchy                    pi scale
  t        df               t's normalizer     df / 2 + 1/2
  truncnorm a        b      log(Phi(b)-Phi(a)) erf(a / sqrt2) erf(b / sqrt2)
  binom    n         p      gammaln(n + 1)     log p         log1p(-p)
  poisson  mu               log mu
  nbinom   n         p      gammaln(n)         log p         log1p(-p)
  ======== ========= ====== ================== ============= ===========

  truncnorm's three constants are the JAX package's float32 values (its
  float32 ``erf``, ``0.5 (1 + erf)`` and the difference in float32), not
  scipy's: for a far tail (``a = 4``) the float32 difference keeps only a
  few digits (-10.36454 against scipy's -10.36010), and the port is held to
  the JAX number.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..utils import not_ported
from .parameters import ParameterSpace

#: families with a sampler and log-density in K2 and its plain version; the
#: index is the family code K2 reads (``Distribution.arrays``)
FAMILIES = ("norm", "uniform", "lognorm", "expon", "gamma", "beta",
            "laplace", "cauchy", "t", "truncnorm", "randint", "binom",
            "poisson", "nbinom")
DISCRETE = ("randint", "binom", "poisson", "nbinom")
#: families whose canonical parameters are (loc, scale)
_LOC_SCALE = ("uniform", "norm", "expon", "laplace", "cauchy")
_SQRT2_F32 = np.float32(math.sqrt(2.0))


def _canon(name: str, args: tuple, kwargs: dict) -> tuple:
    """The JAX package's ``_canon_*``: scipy's arguments -> the family's
    canonical parameters."""
    def loc_scale(loc=0.0, scale=1.0):
        return (float(loc), float(scale))

    def lognorm(s, loc=0.0, scale=1.0):
        if loc != 0.0:
            raise ValueError("lognorm loc!=0 unsupported (non-traceable "
                             "support shift)")
        return (float(s), float(scale))

    def shape1(a, loc=0.0, scale=1.0):
        return (float(a), float(loc), float(scale))

    def shape2(a, b, loc=0.0, scale=1.0):
        return (float(a), float(b), float(loc), float(scale))

    canon = {
        **{f: loc_scale for f in _LOC_SCALE}, "lognorm": lognorm,
        "gamma": shape1, "t": shape1, "beta": shape2, "truncnorm": shape2,
        "randint": lambda low, high: (int(low), int(high)),
        "binom": lambda n, p: (int(n), float(p)),
        "poisson": lambda mu: (float(mu),),
        "nbinom": lambda n, p: (float(n), float(p)),
    }
    return canon[name](*args, **kwargs)


def _log(x: float) -> float:
    return math.log(x) if x > 0 else -math.inf


def _log1m(p: float) -> float:
    return math.log1p(-p) if p < 1 else -math.inf


#: XLA's float32 erf on the CPU: x clamped to +-_ERF_CLAMP, then x p(x^2) /
#: q(x^2), each Horner step one fused multiply-add
_ERF_CLAMP = np.float32(3.7439208030700684)
_ERF_P = [np.float32(v) for v in (
    0.00022905065861350646, 0.0034082910107109506, 0.050955695062380861,
    0.18520832239976145, 1.128379143519084)]
_ERF_Q = [np.float32(v) for v in (
    -1.1791602954361697e-7, 0.000023547966471313185, 0.0010179625278914885,
    0.014070470171167667, 0.11098505178285362, 0.49746925110067538, 1.0)]


def _fma_f32(a, b, c) -> np.float32:
    # a float32 product is exact in float64
    return np.float32(np.float64(a) * np.float64(b) + np.float64(c))


def _erf_f32(x) -> np.float32:
    """The JAX package's float32 erf (XLA's CPU expansion), bit for bit:
    up to 4 ulps off the correctly rounded erf, which ``log(Phi(b) -
    Phi(a))`` of a far tail turns into a visible difference."""
    x = np.float32(min(max(np.float32(x), -_ERF_CLAMP), _ERF_CLAMP))
    x2 = np.float32(x * x)
    p = _fma_f32(x2, _ERF_P[0], _ERF_P[1])
    for c in _ERF_P[2:]:
        p = _fma_f32(x2, p, c)
    q = _fma_f32(x2, _ERF_Q[0], _ERF_Q[1])
    for c in _ERF_Q[2:]:
        q = _fma_f32(x2, q, c)
    return np.float32(np.float32(x * p) / q)


def _truncnorm_consts(a: float, b: float) -> tuple:
    """truncnorm's (log(Phi(b) - Phi(a)), erf(a / sqrt2), erf(b / sqrt2))
    as the JAX package computes them in float32: ``_norm_cdf`` divides the
    Python float by sqrt(2) in float64, then erf, ``0.5 (1 + erf)`` and the
    difference run in float32; ``jax.random.truncated_normal`` divides
    the float32 bound by float32 sqrt(2)."""
    half, one = np.float32(0.5), np.float32(1.0)
    phi = [half * (one + _erf_f32(v / math.sqrt(2.0))) for v in (a, b)]
    with np.errstate(divide="ignore"):
        lognorm = float(np.log(np.float32(phi[1] - phi[0])))
    return (lognorm, float(_erf_f32(np.float32(a) / _SQRT2_F32)),
            float(_erf_f32(np.float32(b) / _SQRT2_F32)))


class RVBase:
    """A 1-D random variable (pyabc ``RVBase``). Only ``RV`` and
    ``LowerBoundDecorator`` around an ``RV`` run on the device path; a
    user subclass is refused by ``Distribution`` (host-only)."""

    #: True if the variable takes integer values only
    discrete: bool = False

    def rvs(self, n: int, generator: torch.Generator,
            device) -> torch.Tensor:
        """``(n,)`` float32 draws."""
        return Distribution(x=self).rvs_array(n, generator, device)[:, 0]

    def logpdf(self, x: torch.Tensor) -> torch.Tensor:
        """Log density (or the log pmf's continuous extension) at x."""
        return Distribution(x=self).logpdf_array(x[..., None])

    def cdf(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


class RV(RVBase):
    """``RV(name, *args, **kwargs)``: a named family with scipy's
    signature (``RV("gamma", a, loc, scale)``, ``RV("binom", n, p)``,
    ...), the JAX package's canonical parameters in ``_params``."""

    def __init__(self, name: str, *args, **kwargs):
        if name not in FAMILIES:
            raise ValueError(f"unknown RV family {name!r}; supported: "
                             f"{sorted(FAMILIES)}")
        self.name = name
        self.args = args
        self.kwargs = kwargs
        self._params = _canon(name, args, kwargs)
        self.discrete = name in DISCRETE

    @property
    def loc(self) -> float:
        if self.name in _LOC_SCALE:
            return self._params[0]
        if self.name == "lognorm":
            return 0.0
        if self.name in ("gamma", "t", "beta", "truncnorm"):
            return self._params[-2]
        raise AttributeError(f"RV {self.name!r} has no loc")

    @property
    def scale(self) -> float:
        if self.name in _LOC_SCALE + ("lognorm", "gamma", "t", "beta",
                                      "truncnorm"):
            return self._params[-1]
        raise AttributeError(f"RV {self.name!r} has no scale")

    def cdf(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "norm":
            loc, scale = self._params
            return 0.5 * (1.0 + torch.erf((x - loc)
                                          / (scale * math.sqrt(2.0))))
        if self.name == "uniform":
            loc, scale = self._params
            return torch.clamp((x - loc) / scale, 0.0, 1.0)
        raise NotImplementedError(f"cdf for {self.name}")

    def _table_row(self) -> tuple:
        """(kind, loc, scale, hi, log_scale, [pa, pb, c0, c1, c2]) in
        float64, for ``Distribution.arrays``."""
        p, name = self._params, self.name
        loc, scale, hi = 0.0, 1.0, math.inf
        pars = [0.0] * 5
        if name in _LOC_SCALE:
            loc, scale = p
            if name == "uniform":
                hi = loc + scale
            elif name == "laplace":
                pars[2] = math.log(2.0 * scale)
            elif name == "cauchy":
                pars[2] = math.pi * scale
        elif name == "lognorm":
            pars[0], scale = p
        elif name == "gamma":
            a, loc, scale = p
            pars[0], pars[2] = a, math.lgamma(a)
        elif name == "beta":
            a, b, loc, scale = p
            pars[:3] = [a, b,
                        math.lgamma(a) + math.lgamma(b) - math.lgamma(a + b)]
        elif name == "t":
            df, loc, scale = p
            pars[0] = df
            pars[2] = (math.lgamma(df / 2.0) + math.log(math.pi * df) / 2.0
                       - math.lgamma(df / 2.0 + 0.5))
            pars[3] = df / 2.0 + 0.5
        elif name == "truncnorm":
            a, b, loc, scale = p
            pars[:] = [a, b, *_truncnorm_consts(a, b)]
        elif name == "randint":
            low, high = p
            loc, scale, hi = float(low), float(high - low), float(high)
        elif name == "poisson":
            pars[0], pars[2] = p[0], _log(p[0])
        else:  # binom, nbinom
            n, q = p
            c0 = math.lgamma(n + 1.0) if name == "binom" else math.lgamma(n)
            pars[:] = [float(n), q, c0, _log(q), _log1m(q)]
        return (FAMILIES.index(name), loc, scale, hi, _log(scale), pars)

    def __repr__(self) -> str:
        return f"RV({self.name!r}, {', '.join(map(repr, self.args))})"


class RVDecorator(RVBase):
    """Base for decorators wrapping another RV (pyabc ``RVDecorator``)."""

    def __init__(self, component: RVBase):
        self.component = component
        self.discrete = component.discrete

    def cdf(self, x: torch.Tensor) -> torch.Tensor:
        return self.component.cdf(x)


class LowerBoundDecorator(RVDecorator):
    """Truncate the wrapped RV below ``bound`` (pyabc
    ``LowerBoundDecorator``, unnormalized as in the reference): the
    log-density is the component's above the bound and -inf at or below
    it; a draw takes the first of up to 9 draws of the component above the
    bound, else reflects the last one, ``2 bound - x`` (the JAX package's
    ``rvs``). The port carries one decorator around an ``RV``."""

    def __init__(self, component: RVBase, bound: float):
        super().__init__(component)
        self.bound = float(bound)

    def __repr__(self) -> str:
        return f"LowerBoundDecorator({self.component!r}, {self.bound!r})"


class ScipyRV(RVBase):
    """Host-only wrapper around a frozen ``scipy.stats`` distribution, the
    JAX package's escape hatch: the port has no host proposal path, so a
    ``Distribution`` holding one is refused."""

    def __init__(self, frozen):
        self.frozen = frozen
        self.discrete = not hasattr(frozen, "pdf")


def _device_row(rv: RVBase, key: str) -> tuple:
    """``rv``'s table row with the decorator's bound; raises for what K2
    cannot draw (host-only components)."""
    bound = -math.inf
    if isinstance(rv, LowerBoundDecorator):
        bound, rv = rv.bound, rv.component
        if isinstance(rv, RVDecorator):
            raise not_ported(f"prior component {key!r}: a decorator of a "
                             f"decorator", "16")
    if type(rv) is not RV:
        raise not_ported(f"prior component {key!r}: a host-only "
                         f"{type(rv).__name__}", "16")
    kind, loc, scale, hi, log_scale, pars = rv._table_row()
    return kind, loc, scale, hi, log_scale, pars + [bound]


class Distribution:
    """A named product prior, ``Distribution(a=RV(...), b=RV(...))``.

    Columns follow insertion order (``self.space.names``)."""

    def __init__(self, **rvs: RVBase):
        if not rvs:
            raise ValueError("Distribution needs at least one RV")
        for k, rv in rvs.items():
            if not isinstance(rv, RVBase):
                raise TypeError(f"prior component {k!r} is "
                                f"{type(rv).__name__}, not an RV")
        self.rv_map: dict[str, RVBase] = dict(rvs)
        self.space = ParameterSpace(self.rv_map.keys())
        self._rows = [_device_row(rv, k) for k, rv in self.rv_map.items()]

    @classmethod
    def from_spec(cls, spec) -> "Distribution":
        """Build from ``[(name, family, *args), ...]``."""
        return cls(**{name: RV(kind, *args) for name, kind, *args in spec})

    @property
    def dim(self) -> int:
        return self.space.dim

    @property
    def legacy(self) -> bool:
        """True when every dimension is an undecorated norm or uniform
        (the families K2 knew first, drawn from their own blocks)."""
        return all(r[0] <= 1 and r[-1][-1] == -math.inf for r in self._rows)

    def rvs_array(self, n: int, generator: torch.Generator,
                  device) -> torch.Tensor:
        """``(n, dim)`` float32 draw, one column per component. Norm and
        uniform priors draw from the generator's own normals and uniforms;
        any other takes K2's prior draw on a Philox stream the generator
        places (``philox.generator_stream``)."""
        if self.legacy:
            cols = []
            for kind, loc, scale, *_ in self._rows:
                z = (torch.randn(n, generator=generator, device=device)
                     if kind == 0 else
                     torch.rand(n, generator=generator, device=device))
                cols.append(loc + scale * z)
            return torch.stack(cols, dim=1).to(torch.float32)
        import dataclasses

        from ..kernels import philox
        from ..kernels.propose import propose

        stream = dataclasses.replace(
            philox.generator_stream(generator, torch.device(device)),
            tag=philox.PRIOR)
        return propose(stream, n, self.arrays(device))[0]

    def logpdf_array(self, theta: torch.Tensor) -> torch.Tensor:
        """Log density of ``(..., >= dim)`` thetas; only the first ``dim``
        columns are read, so padded thetas are fine."""
        from ..kernels.propose import prior_logpdf_plain

        flat = theta.reshape(-1, theta.shape[-1])
        return prior_logpdf_plain(flat, self.arrays(theta.device)).reshape(
            theta.shape[:-1])

    def arrays(self, device) -> dict:
        """The per-dimension table K2 reads (the module's docstring), on
        ``device``, and ``families``: a host flag, True when a dimension is
        neither an undecorated norm nor an undecorated uniform."""
        rows = self._rows

        def f32(vals):
            return torch.tensor(vals, dtype=torch.float32, device=device)

        return {
            "kind": torch.tensor([r[0] for r in rows], dtype=torch.int32,
                                 device=device),
            "loc": f32([r[1] for r in rows]),
            "scale": f32([r[2] for r in rows]),
            "hi": f32([r[3] for r in rows]),
            "log_scale": f32([r[4] for r in rows]),
            "par": f32([r[5] for r in rows]),
            "families": not self.legacy,
        }

    def __repr__(self) -> str:
        inner = ", ".join(f"{k}={v!r}" for k, v in self.rv_map.items())
        return f"Distribution({inner})"


#: the tensor keys of a prior table, in K2's argument order
PRIOR_KEYS = ("kind", "loc", "scale", "hi", "log_scale", "par")


def stacked_arrays(priors, device) -> dict:
    """The per-model priors of a run over several models as ``(K, d_max)``
    arrays for K2 (``Distribution.arrays`` of each, zero-padded past its
    dim; ``par`` ``(K, d_max, 6)``) and ``dims (K,)`` int32: model m's
    prior log-density runs over its first ``dims[m]`` entries only."""
    parts = [p.arrays("cpu") for p in priors]
    d_max = max(p.dim for p in priors)

    def pad(key):
        rows = [torch.nn.functional.pad(
            a[key], (0, 0) * (a[key].dim() - 1) + (0, d_max - p.dim))
            for a, p in zip(parts, priors)]
        return torch.stack(rows)

    out = {k: pad(k) for k in PRIOR_KEYS}
    # padded entries are undecorated (never read: model m stops at dims[m])
    for m, p in enumerate(priors):
        out["par"][m, p.dim:, 5] = -math.inf
    out = {k: v.contiguous().to(device) for k, v in out.items()}
    out["dims"] = torch.tensor([p.dim for p in priors], dtype=torch.int32,
                               device=device)
    out["families"] = any(a["families"] for a in parts)
    return out
