"""K16: the bootstrap CV of the refit KDE and its bisection over n (the
in-kernel ``AdaptivePopulationSize``).

Counterpart of ``pyabc_tpu/transition/util.py::{device_mean_cv,
device_required_nr}`` with ``MultivariateNormalTransition``'s statics
(``multivariatenormal.py:222, :236``), as ``inference/util.py:2094-2150``
calls them after the refit; the CUDA kernels are ``csrc/bootstrap_cv.cu``.
One wrapper with six entries, each counted in ``launches`` and in
``mode_launches``; the MVN transition's four:

- ``draw``: the bootstrap ancestors ``(K, n_boot, n_cap)`` int32 from the
  BOOT Philox stream by inverse CDF on each model's ancestor ``cdf`` (K8's),
  and the bisection state reset (``STATE``);
- ``fit``: one weighted MVN fit per model and bootstrap on the first n
  resampled rows (n read from the state), K8's arithmetic
  (``csrc/mvn_fit.cuh``);
- ``density``: the bootstrap CV of each fitted particle's density and the
  weighted sums ``partial (K, blocks, 2)`` of ``w cv`` and ``w``;
- ``bisect``: one step of the JAX package's bisection on the aggregate CV.

``required_nr`` drives them: one draw, then ``n_probes(min_n, max_n)``
probes of fit, density and bisect; the result stays in device memory. A
probe whose state reads done does nothing, so no host read is needed.
The ancestors follow the law of ``jax.random.categorical``, not its bits
(a declared difference, as for every stream of the port).

LocalTransition's mode (``device_mean_cv`` over ``LocalTransition``'s
``device_fit`` and ``device_logpdf``): the same draw and bisect, and per
probe

- ``local_gather``: each model's and bootstrap's resampled rows
  ``thetas[k][idx[k, b]]`` into ``(K nb, n_cap, d)``, the bootstrap weights
  (1/n on the first n, read from the state) and ``go`` (int32: not done);
- ``local_fit`` (no kernel of its own): K12 then K13 (the full
  factorization) for each model and bootstrap on those rows, each reading
  ``go`` as its refit flag, so a finished probe does nothing; the fits
  stay in stacked buffers (``local_fit_buffers``). K12 and K13 count these
  launches in their ``mode_launches["bootstrap"]``;
- ``local_density``: each fitted particle's log-density under every
  bootstrap fit (K14's tile loop, ``csrc/local_mix.cuh``), their CV and
  the same ``partial (K, blocks, 2)`` as ``density``.

``local_probe`` composes the three for one probe.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from . import _build
from .base import Kernel
from .local_cov import local_cov
from .local_factor import local_factor
from .local_logpdf import local_logpdf_plain
from .mvn_fit import MAX_DIM, MAX_MODELS, SELECTORS, mvn_fit_plain
from .philox import BOOT, MASK32, philox4x32_10, uniform_of

#: bootstraps one launch takes (the density keeps their log-densities in a
#: thread's local array)
MAX_BOOTSTRAP = 32
#: probes whose CV the bisect step logs
MAX_PROBES = 32
#: threads (fitted particles) of a density block
DENSITY_THREADS = 256
#: the bisection state: lo, hi, the probe's n, done, probes taken
LO, HI, PROBE, DONE, STEP = range(5)
#: dims LocalTransition's mode takes (K12-K14's buckets)
MAX_LOCAL_DIM = 16
#: fitted particles a thread of the local density computes (its R,
#: ``kDensityRows`` in the CUDA source; the block is 256 / R threads over a
#: tile of 256 particles)
LOCAL_DENSITY_ROWS = 2


def n_probes(min_n: int, max_n: int) -> int:
    """Probes the bisection can take: the first at max_n, then
    ceil(log2(max_n - min_n + 1)) halvings."""
    return 1 + math.ceil(math.log2(max(int(max_n) - int(min_n) + 1, 1)))


def n_blocks(n_cap: int) -> int:
    return (n_cap + DENSITY_THREADS - 1) // DENSITY_THREADS


def seed_key(seed: int) -> tuple[int, int]:
    s = int(seed) % (1 << 64)
    return s & MASK32, s >> 32


# ------------------------------------------------------- plain versions
def bootstrap_draw_plain(cdf: torch.Tensor, *, n_boot: int, seed: int,
                         generation: int, max_rounds: int, min_n: int,
                         max_n: int):
    """Plain PyTorch version of the draw -> (idx (K, n_boot, n_cap) int32,
    state (5,) int32): the uniform of word 0 of block ``(model << 8) |
    bootstrap`` of lane = slot on the BOOT stream at round 0, scaled by the
    cdf's total and searched as K2 does."""
    K, n = cdf.shape
    dev = cdf.device
    lanes = torch.arange(n, dtype=torch.int64, device=dev)
    blocks = ((torch.arange(K, dtype=torch.int64, device=dev)[:, None] << 8)
              | torch.arange(n_boot, dtype=torch.int64, device=dev)[None])
    words = philox4x32_10(lanes[None, None, :], blocks[:, :, None],
                          int(generation), BOOT * int(max_rounds),
                          seed_key(seed))
    total = cdf[:, -1]
    below = torch.nextafter(total, torch.zeros_like(total))
    x = torch.minimum(uniform_of(words[0]) * total[:, None, None],
                      below[:, None, None])
    seq = cdf[:, None, :].expand(K, n_boot, n).contiguous()
    idx = torch.searchsorted(seq, x, right=True).clamp(max=n - 1)
    state = torch.tensor([min_n, max_n, max_n, 0, 0], dtype=torch.int32,
                         device=dev)
    return idx.to(torch.int32), state


def _fit_shapes(K, nb, n_cap, d):
    return {"center": (K, nb, d), "prec": (K, nb, d, d), "logdet": (K, nb),
            "thetas_c": (K, nb, n_cap, d), "quad": (K, nb, n_cap)}


def bootstrap_fit_plain(thetas: torch.Tensor, idx: torch.Tensor,
                        state: torch.Tensor, *, dims, statics) -> dict:
    """Plain PyTorch version of the fit: K8's plain fit of the resampled
    rows ``thetas[k][idx[k, b]]`` with weight 1/n on the first n, for each
    model k and bootstrap b; the centred rows and quads of those n rows
    (the rest 0)."""
    K, nb, n_cap = idx.shape
    d = thetas.shape[2]
    out = {k: torch.zeros(s, dtype=torch.float32, device=thetas.device)
           for k, s in _fit_shapes(K, nb, n_cap, d).items()}
    _lo, _hi, n, done, _s = (int(v) for v in state.tolist())
    if done:
        return out
    n = max(0, min(n, n_cap))
    boot_w = torch.where(
        torch.arange(n_cap, device=thetas.device) < n,
        torch.tensor(1.0 / max(n, 1), dtype=torch.float32,
                     device=thetas.device),
        torch.zeros((), dtype=torch.float32, device=thetas.device))
    for k in range(K):
        for b in range(nb):
            p = mvn_fit_plain(thetas[k][idx[k, b].long()], boot_w,
                              dim=dims[k], **statics[k])
            out["center"][k, b] = p["center"]
            out["prec"][k, b] = p["prec"]
            out["logdet"][k, b] = p["logdet"]
            out["thetas_c"][k, b, :n] = p["thetas_c"][:n]
            out["quad"][k, b, :n] = p["quad"][:n]
    return out


def bootstrap_density_plain(thetas: torch.Tensor, weights: torch.Tensor,
                            fit: dict, state: torch.Tensor,
                            chunk: int = 1024) -> torch.Tensor:
    """Plain PyTorch version of the density + CV -> partial (K, blocks, 2):
    per fitted particle the log-density under each bootstrap fit over its
    first n components (the expanded Mahalanobis form of K3), shifted by
    its maximum, the CV std / mean (ddof 0, 0 where the mean is not > 0),
    then ``w cv`` and ``w`` summed over each block of 256 particles."""
    K, n_cap, d = thetas.shape
    nb = fit["logdet"].shape[1]
    nblk = n_blocks(n_cap)
    partial = torch.zeros(K, nblk, 2, dtype=torch.float32,
                          device=thetas.device)
    _lo, _hi, n, done, _s = (int(v) for v in state.tolist())
    if done:
        return partial
    n = max(0, min(n, n_cap))
    for k in range(K):
        ld = torch.empty(nb, n_cap, dtype=torch.float32,
                         device=thetas.device)
        for b in range(nb):
            thc = fit["thetas_c"][k, b, :n]
            quad = fit["quad"][k, b, :n]
            for j0 in range(0, n_cap, chunk):
                u = thetas[k, j0:j0 + chunk] - fit["center"][k, b]
                Pu = u @ fit["prec"][k, b].T
                maha = ((u * Pu).sum(1)[:, None] - 2.0 * (Pu @ thc.T)
                        + quad[None, :])
                ld[b, j0:j0 + chunk] = (-0.5 * fit["logdet"][k, b]
                                        + torch.logsumexp(-0.5 * maha, 1))
        partial[k] = cv_partial_plain(ld, weights[k])
    return partial


def cv_partial_plain(ld: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Per fitted particle the CV over the bootstraps of its densities
    ``ld (nb, n_cap)`` shifted by their maximum (std / mean, ddof 0, 0
    where the mean is not > 0), then ``w cv`` and ``w`` summed over each
    block of 256 particles -> ``(blocks, 2)``."""
    n_cap = ld.shape[1]
    nblk = n_blocks(n_cap)
    dens = torch.exp(ld - ld.max(0, keepdim=True).values)
    mean = dens.mean(0)
    std = dens.std(0, unbiased=False)
    cv = torch.where(mean > 0, std / mean, torch.zeros_like(mean))
    wcv = torch.where(w != 0, w * cv, torch.zeros_like(w))
    both = torch.nn.functional.pad(torch.stack([wcv, w], 1),
                                   (0, 0, 0, nblk * DENSITY_THREADS - n_cap))
    return both.reshape(nblk, DENSITY_THREADS, 2).sum(1)


def _local_shapes(K: int, nb: int, n_cap: int, d: int) -> dict:
    """The stacked buffers of a probe's LocalTransition fits."""
    kb = K * nb
    return {"thetas": (kb, n_cap, d), "weights": (kb, n_cap),
            "cdf": (kb, n_cap), "covs": (kb, n_cap, d, d),
            "cnt": (kb, n_cap), "chols": (kb, n_cap, d, d),
            "precs": (kb, n_cap, d, d), "logdets": (kb, n_cap),
            "lconst": (kb, n_cap)}


def local_fit_buffers(K: int, nb: int, n_cap: int, d: int, device) -> dict:
    """Zeroed buffers for K nb LocalTransition fits of n_cap rows (K12's
    field and K13's factors), reused by every probe of a bisection."""
    return {k: torch.zeros(s, dtype=torch.int32 if k == "cnt"
                           else torch.float32, device=device)
            for k, s in _local_shapes(K, nb, n_cap, d).items()}


def bootstrap_local_gather_plain(thetas: torch.Tensor, idx: torch.Tensor,
                                 state: torch.Tensor):
    """Plain PyTorch version of the gather -> (rows (K nb, n_cap, d),
    boot_w (n_cap,), go (int32))."""
    K, nb, n_cap = idx.shape
    d = thetas.shape[2]
    _lo, _hi, n, done, _s = (int(v) for v in state.tolist())
    n = max(0, min(n, n_cap))
    rows = torch.zeros(K * nb, n_cap, d, dtype=thetas.dtype,
                       device=thetas.device)
    boot_w = torch.zeros(n_cap, dtype=torch.float32, device=thetas.device)
    if not done:
        for k in range(K):
            rows[k * nb:(k + 1) * nb] = thetas[k][idx[k].long()]
        one = torch.ones((), dtype=torch.float32, device=thetas.device)
        boot_w[:n] = one / torch.full_like(one, float(max(n, 1)))
    go = torch.tensor(0 if done else 1, dtype=torch.int32,
                      device=thetas.device)
    return rows, boot_w, go


def bootstrap_local_density_plain(thetas: torch.Tensor,
                                  weights: torch.Tensor, fits: dict,
                                  state: torch.Tensor,
                                  want_ld: bool = False):
    """Plain PyTorch version of the local density + CV -> partial (K,
    blocks, 2) [and ld (K nb, n_cap), 0 where a particle has no weight]:
    each fitted particle's log-density under each bootstrap's mixture (K14's
    plain version), then ``cv_partial_plain``."""
    K, n_cap, _d = thetas.shape
    nb = fits["thetas"].shape[0] // K
    partial = torch.zeros(K, n_blocks(n_cap), 2, dtype=torch.float32,
                          device=thetas.device)
    ld_all = torch.zeros(K * nb, n_cap, dtype=torch.float32,
                         device=thetas.device)
    if int(state[DONE]):
        return (partial, ld_all) if want_ld else partial
    for k in range(K):
        ld = torch.stack([local_logpdf_plain(
            thetas[k], {key: fits[key][k * nb + b] for key in
                        ("thetas", "precs", "lconst", "weights")})
            for b in range(nb)])
        live = weights[k] != 0
        ld_all[k * nb:(k + 1) * nb] = torch.where(live, ld,
                                                  torch.zeros_like(ld))
        partial[k] = cv_partial_plain(torch.where(live, ld,
                                                  torch.zeros_like(ld)),
                                      weights[k])
    return (partial, ld_all) if want_ld else partial


def bootstrap_bisect_plain(partial: torch.Tensor, state: torch.Tensor,
                           cvs: torch.Tensor, *,
                           model_p: torch.Tensor | None,
                           target: float) -> None:
    """Plain PyTorch version of one bisect step (in place on ``state`` and
    ``cvs``), summing the blocks in order in float32 as the kernel does."""
    lo, hi, probe, done, step = (int(v) for v in state.tolist())
    if done:
        return
    f32 = torch.float32
    dev = partial.device
    K, nblk, _ = partial.shape
    zero = torch.zeros((), dtype=f32, device=dev)
    psum = zero
    if model_p is not None:
        for k in range(K):
            psum = psum + model_p[k]
        psum = torch.where(psum < 1e-38, torch.full_like(psum, 1e-38), psum)
    tot = zero
    for k in range(K):
        a, ws = zero, zero
        for i in range(nblk):
            a = a + partial[k, i, 0]
            ws = ws + partial[k, i, 1]
        ws = torch.where(ws < 1e-38, torch.full_like(ws, 1e-38), ws)
        cv = a / ws
        if model_p is None:
            tot = tot + cv
        else:
            p = model_p[k]
            tot = tot + torch.where(p > 0, p / psum * cv, zero)
    if step < MAX_PROBES:
        cvs[step] = tot
    # compared in float32, as the kernel compares them
    tot, target = np.float32(float(tot)), np.float32(target)
    if step == 0:
        done = int(tot > target)
    elif tot <= target:
        hi = probe
    else:
        lo = probe + 1
    if not done:
        if lo < hi:
            probe = (lo + hi) // 2
        else:
            done = 1
    state.copy_(torch.tensor([lo, hi, probe, done, step + 1],
                             dtype=torch.int32))


# --------------------------------------------------------------- wrapper
class BootstrapCV(Kernel):
    name = "bootstrap_cv"
    source = "pyabc_tpu_torch/csrc/bootstrap_cv.cu"
    replaces = "pyabc_tpu/transition/util.py:150"
    #: the entries, as ``mode_launches`` counts them: the MVN's four and
    #: LocalTransition's gather and density
    ENTRIES = ("draw", "fit", "density", "bisect", "local_gather",
               "local_density")
    #: each entry's TPU counterpart
    ENTRY_REPLACES = {
        "draw": "pyabc_tpu/transition/util.py:164",
        "fit": "pyabc_tpu/transition/util.py:172",
        "density": "pyabc_tpu/transition/util.py:150",
        "bisect": "pyabc_tpu/transition/util.py:189",
        "local_gather": "pyabc_tpu/transition/util.py:167",
        "local_density": "pyabc_tpu/transition/util.py:176"}

    def __init__(self):
        super().__init__()
        self.mode_launches = {e: 0 for e in self.ENTRIES}

    def _launched(self, err: int, entry: str) -> None:
        _build.check(err, f"{self.name}:{entry}")
        self.launches += 1
        self.mode_launches[entry] += 1

    @staticmethod
    def _state_ok(state: torch.Tensor) -> None:
        Kernel.expect(state, "state", torch.int32, (5,))

    def draw(self, cdf: torch.Tensor, *, n_boot: int, seed: int,
             generation: int, max_rounds: int, min_n: int, max_n: int):
        """``cdf (K, n_cap)`` -> (idx (K, n_boot, n_cap) int32, state)."""
        if not 0 < n_boot <= MAX_BOOTSTRAP:
            raise ValueError(f"{self.name}: n_bootstrap {n_boot} outside "
                             f"1..{MAX_BOOTSTRAP}")
        if self.on_cpu(cdf):
            return bootstrap_draw_plain(
                cdf, n_boot=n_boot, seed=seed, generation=generation,
                max_rounds=max_rounds, min_n=min_n, max_n=max_n)
        K, n = cdf.shape
        if not 0 < K <= MAX_MODELS:
            raise ValueError(f"{self.name}: {K} models (cap {MAX_MODELS})")
        self.expect(cdf, "cdf", torch.float32, (K, n))
        dev = cdf.device
        idx = torch.empty(K, n_boot, n, dtype=torch.int32, device=dev)
        state = torch.empty(5, dtype=torch.int32, device=dev)
        k0, k1 = seed_key(seed)
        err = _build.library().pyabc_boot_draw(
            cdf.data_ptr(), K, n_boot, n, k0, k1, int(generation) & MASK32,
            BOOT, int(max_rounds), int(min_n), int(max_n), idx.data_ptr(),
            state.data_ptr(), _build.stream_ptr(dev))
        self._launched(err, "draw")
        return idx, state

    def fit(self, thetas: torch.Tensor, idx: torch.Tensor,
            state: torch.Tensor, *, dims, statics) -> dict:
        """``thetas (K, n_cap, d)``, ``idx (K, n_boot, n_cap)``; ``dims``
        and ``statics`` (``scaling``, ``bandwidth_selector``) per model ->
        ``center``, ``prec``, ``logdet``, ``thetas_c``, ``quad`` stacked
        over (model, bootstrap)."""
        if self.on_cpu(thetas, idx, state):
            return bootstrap_fit_plain(thetas, idx, state, dims=dims,
                                       statics=statics)
        K, nb, n = idx.shape
        d = thetas.shape[2]
        if d > MAX_DIM or len(dims) != K or len(statics) != K:
            raise ValueError(f"{self.name}: dim {d} (cap {MAX_DIM}) or "
                             f"the statics do not match {K} models")
        sel = [SELECTORS.get(getattr(st["bandwidth_selector"], "__name__",
                                     "")) for st in statics]
        if None in sel:
            raise NotImplementedError(
                f"{self.name}: a bandwidth rule has no kernel (scott or "
                f"silverman)")
        f32 = torch.float32
        self.expect(thetas, "thetas", f32, (K, n, d))
        self.expect(idx, "idx", torch.int32, (K, nb, n))
        self._state_ok(state)
        dev = thetas.device
        out = {k: torch.empty(s, dtype=f32, device=dev)
               for k, s in _fit_shapes(K, nb, n, d).items()}

        def arr(ctype, vals):
            return (ctype * K)(*vals)

        c_int, c_float = ctypes.c_int, ctypes.c_float
        err = _build.library().pyabc_boot_fit(
            thetas.data_ptr(), idx.data_ptr(), state.data_ptr(), K, nb, n, d,
            arr(c_int, [int(x) for x in dims]),
            arr(c_float, [float(st["scaling"]) for st in statics]),
            arr(c_int, sel),
            arr(c_float, [(4 / (x + 2)) ** (1 / (x + 4)) for x in dims]),
            arr(c_float, [-1.0 / (x + 4) for x in dims]),
            *(out[k].data_ptr() for k in ("center", "prec", "logdet",
                                          "thetas_c", "quad")),
            _build.stream_ptr(dev))
        self._launched(err, "fit")
        return out

    def density(self, thetas: torch.Tensor, weights: torch.Tensor,
                fit: dict, state: torch.Tensor) -> torch.Tensor:
        """``thetas (K, n_cap, d)``, ``weights (K, n_cap)`` of the refit
        and the bootstrap fits -> ``partial (K, blocks, 2)``."""
        if self.on_cpu(thetas, weights, state, fit["quad"]):
            return bootstrap_density_plain(thetas, weights, fit, state)
        K, n, d = thetas.shape
        nb = fit["logdet"].shape[1]
        f32 = torch.float32
        self.expect(thetas, "thetas", f32, (K, n, d))
        self.expect(weights, "weights", f32, (K, n))
        self._state_ok(state)
        for key, shape in _fit_shapes(K, nb, n, d).items():
            self.expect(fit[key], key, f32, shape)
        dev = thetas.device
        partial = torch.empty(K, n_blocks(n), 2, dtype=f32, device=dev)
        err = _build.library().pyabc_boot_density(
            thetas.data_ptr(), weights.data_ptr(), state.data_ptr(), K, nb,
            n, d, *(fit[k].data_ptr() for k in ("center", "prec", "logdet",
                                                "thetas_c", "quad")),
            partial.data_ptr(), _build.stream_ptr(dev))
        self._launched(err, "density")
        return partial

    def bisect(self, partial: torch.Tensor, state: torch.Tensor,
               cvs: torch.Tensor, *, model_p: torch.Tensor | None,
               target: float) -> None:
        """One bisection step in place on ``state`` (and the probe's CV in
        ``cvs``); ``model_p`` the new model probabilities, None for one
        model."""
        extra = [model_p] if model_p is not None else []
        if self.on_cpu(partial, state, cvs, *extra):
            bootstrap_bisect_plain(partial, state, cvs, model_p=model_p,
                                   target=target)
            return
        K, nblk, _ = partial.shape
        f32 = torch.float32
        self.expect(partial, "partial", f32, (K, nblk, 2))
        self.expect(cvs, "cvs", f32, (MAX_PROBES,))
        self._state_ok(state)
        if model_p is not None:
            self.expect(model_p, "model_p", f32, (K,))
        err = _build.library().pyabc_boot_bisect(
            partial.data_ptr(), K, nblk, self.ptr(model_p), state.data_ptr(),
            cvs.data_ptr(), float(target), _build.stream_ptr(partial.device))
        self._launched(err, "bisect")


    def local_gather(self, thetas: torch.Tensor, idx: torch.Tensor,
                     state: torch.Tensor):
        """LocalTransition's mode: ``thetas (K, n_cap, d)`` of the refit and
        the ancestors ``idx (K, nb, n_cap)`` -> (rows ``(K nb, n_cap, d)``,
        the bootstrap weights ``(n_cap,)``, ``go`` int32: the probe's K12
        and K13 flag)."""
        if self.on_cpu(thetas, idx, state):
            return bootstrap_local_gather_plain(thetas, idx, state)
        K, nb, n = idx.shape
        d = thetas.shape[2]
        if d > MAX_LOCAL_DIM or not 0 < K <= MAX_MODELS:
            raise ValueError(f"{self.name}: dim {d} (cap {MAX_LOCAL_DIM}) "
                             f"or {K} models (cap {MAX_MODELS})")
        f32 = torch.float32
        self.expect(thetas, "thetas", f32, (K, n, d))
        self.expect(idx, "idx", torch.int32, (K, nb, n))
        self._state_ok(state)
        dev = thetas.device
        rows = torch.empty(K * nb, n, d, dtype=f32, device=dev)
        boot_w = torch.empty(n, dtype=f32, device=dev)
        go = torch.empty((), dtype=torch.int32, device=dev)
        err = _build.library().pyabc_boot_local_gather(
            thetas.data_ptr(), idx.data_ptr(), state.data_ptr(), K, nb, n, d,
            rows.data_ptr(), boot_w.data_ptr(), go.data_ptr(),
            _build.stream_ptr(dev))
        self._launched(err, "local_gather")
        return rows, boot_w, go

    def local_density(self, thetas: torch.Tensor, weights: torch.Tensor,
                      fits: dict, state: torch.Tensor,
                      want_ld: bool = False):
        """LocalTransition's mode: ``thetas (K, n_cap, d)``, ``weights (K,
        n_cap)`` of the refit and the probe's bootstrap fits (stacked ``(K
        nb, n_cap, ...)``) -> ``partial (K, blocks, 2)``; with ``want_ld``
        also each live particle's log-densities ``(K nb, n_cap)`` (a check
        entry; 0 where a particle has no weight on the plain version, not
        written on the card)."""
        keys = ("thetas", "precs", "lconst", "weights")
        if self.on_cpu(thetas, weights, state, *(fits[k] for k in keys)):
            return bootstrap_local_density_plain(thetas, weights, fits,
                                                 state, want_ld)
        K, n, d = thetas.shape
        kb = fits["thetas"].shape[0]
        if d > MAX_LOCAL_DIM or kb % K or not 0 < kb // K <= MAX_BOOTSTRAP:
            raise ValueError(f"{self.name}: dim {d} (cap {MAX_LOCAL_DIM}) "
                             f"or {kb} fits over {K} models")
        f32 = torch.float32
        self.expect(thetas, "thetas", f32, (K, n, d))
        self.expect(weights, "weights", f32, (K, n))
        self._state_ok(state)
        shapes = _local_shapes(K, kb // K, n, d)
        for key in keys:
            self.expect(fits[key], key, f32, shapes[key])
        dev = thetas.device
        partial = torch.empty(K, n_blocks(n), 2, dtype=f32, device=dev)
        ld = (torch.zeros if want_ld else torch.empty)(kb, n, dtype=f32,
                                                        device=dev)
        tickets = torch.zeros(K, n_blocks(n), dtype=torch.int32, device=dev)
        err = _build.library().pyabc_boot_local_density(
            thetas.data_ptr(), weights.data_ptr(), state.data_ptr(), K,
            kb // K, n, d, *(fits[k].data_ptr() for k in keys),
            partial.data_ptr(), ld.data_ptr(), tickets.data_ptr(),
            _build.stream_ptr(dev))
        self._launched(err, "local_density")
        return (partial, ld) if want_ld else partial


bootstrap_cv = BootstrapCV()


def local_fit(rows: torch.Tensor, boot_w: torch.Tensor, go: torch.Tensor,
              state: torch.Tensor, fits: dict, *, dims, configs) -> dict:
    """A probe's LocalTransition fits: for model k and bootstrap b, K12
    then K13 (every row factorized) on ``rows[k nb + b]`` with the
    bootstrap weights, both reading ``go``, into ``fits``' views
    (``local_fit_buffers``); ``configs[k]`` is model k's K12 arguments
    (``LocalTransition.field_config``). On the CPU a finished probe
    returns at once (a host read costs nothing there)."""
    K = len(dims)
    nb = rows.shape[0] // K
    if rows.device.type == "cpu" and int(state[DONE]):
        return fits
    for k in range(K):
        for b in range(nb):
            kb = k * nb + b
            field = local_cov(
                rows[kb], boot_w, flag=go, mode="bootstrap",
                out={key: fits[key][kb] for key in ("thetas", "weights",
                                                    "cdf", "covs", "cnt")},
                **configs[k])
            local_factor(
                field, None, dim=int(dims[k]), incremental=False, flag=go,
                mode="bootstrap",
                out={key: fits[key][kb] for key in ("chols", "precs",
                                                    "logdets", "lconst")})
    return fits


def local_probe(thetas: torch.Tensor, weights: torch.Tensor,
                idx: torch.Tensor, state: torch.Tensor, fits: dict, *,
                dims, configs) -> torch.Tensor:
    """One probe of LocalTransition's mode at the state's n: the gather,
    K12 and K13 for every model and bootstrap (``local_fit``), the local
    density -> the ``(K, blocks, 2)`` partial sums the bisect reads."""
    rows, boot_w, go = bootstrap_cv.local_gather(thetas, idx, state)
    local_fit(rows, boot_w, go, state, fits, dims=dims, configs=configs)
    return bootstrap_cv.local_density(thetas, weights, fits, state)


def required_nr(thetas: torch.Tensor, weights: torch.Tensor,
                cdf: torch.Tensor, *, dims, statics, seed: int,
                generation: int, max_rounds: int, target_cv: float,
                min_n: int, max_n: int, n_bootstrap: int,
                model_p: torch.Tensor | None = None,
                local: list | None = None) -> dict:
    """K16 on stacked refit params (``thetas (K, n_cap, d)``, ``weights``
    and ``cdf (K, n_cap)``): one draw, then a fixed number of probes ->
    ``n_next`` (a 0-dim int32 view of the state, in device memory), the
    ``state`` and each probe's aggregate CV (``cvs``). ``local``: each
    model's K12 arguments (``LocalTransition.field_config``; ``statics``
    unused) for LocalTransition's mode (gather, K12 and K13, local
    density, bisect)."""
    idx, state = bootstrap_cv.draw(
        cdf, n_boot=n_bootstrap, seed=seed, generation=generation,
        max_rounds=max_rounds, min_n=min_n, max_n=max_n)
    cvs = torch.zeros(MAX_PROBES, dtype=torch.float32, device=thetas.device)
    fits = (None if local is None else local_fit_buffers(
        len(dims), n_bootstrap, thetas.shape[1], thetas.shape[2],
        thetas.device))
    for _ in range(n_probes(min_n, max_n)):
        if local is None:
            fit = bootstrap_cv.fit(thetas, idx, state, dims=dims,
                                   statics=statics)
            partial = bootstrap_cv.density(thetas, weights, fit, state)
        else:
            partial = local_probe(thetas, weights, idx, state, fits,
                                  dims=dims, configs=local)
        bootstrap_cv.bisect(partial, state, cvs, model_p=model_p,
                            target=target_cv)
    return {"n_next": state[HI], "state": state, "cvs": cvs, "idx": idx}
