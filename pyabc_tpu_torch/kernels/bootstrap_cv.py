"""K16: the bootstrap CV of the refit KDE and its bisection over n (the
in-kernel ``AdaptivePopulationSize``).

Counterpart of ``pyabc_tpu/transition/util.py::{device_mean_cv,
device_required_nr}`` with ``MultivariateNormalTransition``'s statics
(``multivariatenormal.py:222, :236``), as ``inference/util.py:2094-2150``
calls them after the refit; the CUDA kernels are ``csrc/bootstrap_cv.cu``.
One wrapper with four entries, each counted in ``launches`` and in
``mode_launches``:

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
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from . import _build
from .base import Kernel
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
    pad = nblk * DENSITY_THREADS - n_cap
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
        dens = torch.exp(ld - ld.max(0, keepdim=True).values)
        mean = dens.mean(0)
        std = dens.std(0, unbiased=False)
        cv = torch.where(mean > 0, std / mean, torch.zeros_like(mean))
        w = weights[k]
        wcv = torch.where(w != 0, w * cv, torch.zeros_like(w))
        both = torch.nn.functional.pad(torch.stack([wcv, w], 1),
                                       (0, 0, 0, pad))
        partial[k] = both.reshape(nblk, DENSITY_THREADS, 2).sum(1)
    return partial


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
    #: the four entries, as ``mode_launches`` counts them
    ENTRIES = ("draw", "fit", "density", "bisect")
    #: each entry's TPU counterpart
    ENTRY_REPLACES = {
        "draw": "pyabc_tpu/transition/util.py:164",
        "fit": "pyabc_tpu/transition/util.py:172",
        "density": "pyabc_tpu/transition/util.py:150",
        "bisect": "pyabc_tpu/transition/util.py:189"}

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


bootstrap_cv = BootstrapCV()


def required_nr(thetas: torch.Tensor, weights: torch.Tensor,
                cdf: torch.Tensor, *, dims, statics, seed: int,
                generation: int, max_rounds: int, target_cv: float,
                min_n: int, max_n: int, n_bootstrap: int,
                model_p: torch.Tensor | None = None) -> dict:
    """K16 on stacked refit params (``thetas (K, n_cap, d)``, ``weights``
    and ``cdf (K, n_cap)``): one draw, then a fixed number of probes ->
    ``n_next`` (a 0-dim int32 view of the state, in device memory), the
    ``state`` and each probe's aggregate CV (``cvs``)."""
    idx, state = bootstrap_cv.draw(
        cdf, n_boot=n_bootstrap, seed=seed, generation=generation,
        max_rounds=max_rounds, min_n=min_n, max_n=max_n)
    cvs = torch.zeros(MAX_PROBES, dtype=torch.float32, device=thetas.device)
    for _ in range(n_probes(min_n, max_n)):
        fit = bootstrap_cv.fit(thetas, idx, state, dims=dims,
                               statics=statics)
        partial = bootstrap_cv.density(thetas, weights, fit, state)
        bootstrap_cv.bisect(partial, state, cvs, model_p=model_p,
                            target=target_cv)
    return {"n_next": state[HI], "state": state, "cvs": cvs, "idx": idx}
