"""K23 fit (the MLP plan): the boundary refit of an MLP learned summary
statistic, and the Adam steps of ``MLPPredictor.fit``.

Counterpart of ``pyabc_tpu/ops/fit.py::mlp_fit_steps`` behind
``keep_if_finite``, as ``inference/util.py:1777-1811`` runs it at a
chunk's last active generation; the CUDA kernel is ``csrc/mlp_fit.cu``.

``mlp_fit(x, y, w, counters, old, lr=, n_steps=, need=, standardize=)``:
``x`` the reservoir's raw statistics ``(n_cap, S)``, ``y`` its thetas
``(n_cap, C')``, ``w`` the weights (``exp`` of the normalized log weights,
0 off the kept rows), ``counters`` the generation's round counters in
device memory and ``old`` the transform in effect (``{"layers": [{"w",
"b"}, ...], "mu", "sd", "ymu", "ysd"}``) -> ``(params, flags)``: the new
transform (its layers views of one packed buffer) and int32 ``flags =
[ok, fit]``. The decision and the flags are the linear fit's
(``ops/fit.py::fit_decision``, ``csrc/fit_common.cuh``): the fit runs when
the generation completed and its kept rows reach ``need``; else, or when a
leaf of the fit is not finite, the old transform comes back. ``n_steps``
Adam steps warm-start from the old layers with zero moments.
``standardize=False`` keeps the old ``mu``, ``sd``, ``ymu``, ``ysd`` (the
host seed fit passes rows it standardized in float64, with mu 0 and sd 1).
``mlp_fit.gradient(x, y, w, counters, params, need=)`` -> the loss's
gradient at ``params`` on the same rows, packed (P,): one step of the same
kernels at lr 0 (a check of the step kernel; counted in ``mode_launches``).

The kernels' caps (:func:`caps_reason`): at most three hidden layers of at
most 128, S <= 160, C' <= 8, and the step kernel's tile within a block's
shared memory; the default ``hidden=(64, 64)`` at S 128 takes 85 KB.
"""
from __future__ import annotations

import ctypes

import torch

from ..ops.fit import (MLP_KEYS, fit_decision, fit_outcome, keep_if_finite,
                       mlp_fit_rows, mlp_fit_steps, mlp_layout,
                       mlp_loss_grad, mlp_sizes, pack_layers, param_leaves,
                       unpack_layers)
from ..utils import not_ported
from . import _build
from .base import Kernel

#: the network the kernels take: layers (hidden + 1), the widest input, a
#: hidden layer's width, the learned features
MAX_DEPTH, MAX_IN, MAX_HIDDEN, MAX_C = 4, 160, 128, 8
#: kept rows a block of the step kernel takes (csrc/mlp_fit.cu kTileRows)
TILE_ROWS = 32
#: rows a block of the column passes sums (csrc/fit_common.cuh kRows)
COL_ROWS = 256
#: a block's shared memory on the H100 (its opt-in limit)
SMEM_BYTES = 232448
#: the transform's per-warp buffers (csrc/mlp_sumstat.cu: 8 warps, two
#: buffers of max(MAX_IN, MAX_HIDDEN) floats each)
TRANSFORM_BUFFERS = 8 * 2 * max(MAX_IN, MAX_HIDDEN)


def _odd(n: int) -> int:
    return n | 1


def step_smem_bytes(sizes) -> int:
    """The step kernel's shared memory: the padded layers and a tile's
    activations of every width."""
    w = sum(fi * _odd(fo) + fo for fi, fo in zip(sizes[:-1], sizes[1:]))
    return 4 * (w + TILE_ROWS * sum(_odd(s) for s in sizes))


def transform_smem_bytes(sizes) -> int:
    """The transform's shared memory: the packed layers, mu, sd, ymu, ysd,
    s0 and the warps' buffers."""
    P = mlp_layout(sizes)[1]
    return 4 * (P + 2 * sizes[0] + 2 * sizes[-1] + MAX_C + TRANSFORM_BUFFERS)


def caps_reason(sizes) -> str | None:
    """Why the kernels cannot take a network of ``sizes`` (S, H_1, ...,
    C'), or None."""
    S, hidden, C = sizes[0], sizes[1:-1], sizes[-1]
    if len(sizes) - 1 > MAX_DEPTH:
        return (f"an MLP of {len(hidden)} hidden layers on the card (at most "
                f"{MAX_DEPTH - 1})")
    if any(not 0 < h <= MAX_HIDDEN for h in hidden):
        return (f"MLP hidden widths {tuple(hidden)} on the card (at most "
                f"{MAX_HIDDEN}: a warp's lanes hold four outputs each)")
    if not 0 < S <= MAX_IN:
        return (f"an MLP of {S} raw statistics on the card (at most "
                f"{MAX_IN})")
    if not 0 < C <= MAX_C:
        return (f"learned statistics of {C} features on the card (the "
                f"transform keeps at most {MAX_C} in registers)")
    need = max(step_smem_bytes(sizes), transform_smem_bytes(sizes))
    if need > SMEM_BYTES:
        return (f"an MLP of sizes {tuple(sizes)} on the card (its layers "
                f"and a tile take {need} bytes of a block's {SMEM_BYTES})")
    return None


def check_caps(sizes) -> None:
    reason = caps_reason(tuple(sizes))
    if reason is not None:
        raise not_ported(reason, "14")


def widths_arg(sizes):
    """The C entry's host array of widths (keep it alive over the call)
    and its address."""
    arr = (ctypes.c_int * len(sizes))(*sizes)
    return arr, ctypes.addressof(arr)


def mlp_fit_plain(x, y, w, counters, old: dict, *, lr: float, n_steps: int,
                  need: int, standardize: bool = True):
    """Plain PyTorch version -> (params, flags)."""
    mask, fit = fit_decision(counters, x.shape[0], need)
    new, ok = keep_if_finite(
        mlp_fit_steps(old, x, y, w, mask, lr=lr, n_steps=n_steps,
                      standardize=standardize), old)
    return fit_outcome(new, ok, fit, old)


def mlp_gradient_plain(x, y, w, counters, params: dict, *, need: int,
                       standardize: bool = True) -> torch.Tensor:
    """Plain PyTorch version of ``mlp_fit.gradient`` (the gradient of the
    kept rows' loss whatever the decision; the kernel's is 0 where no fit
    would run)."""
    mask, _fit = fit_decision(counters, x.shape[0], need)
    xs, ys, wts, n, _stats = mlp_fit_rows(params, x, y, w, mask,
                                          standardize)
    grads = mlp_loss_grad(params["layers"], xs, ys, wts, n)[1]
    return pack_layers(grads)


class MlpFit(Kernel):
    name = "mlp_fit"
    source = "pyabc_tpu_torch/csrc/mlp_fit.cu"
    replaces = "pyabc_tpu/ops/fit.py:112"

    def __init__(self):
        super().__init__()
        self.mode_launches = {"gradient": 0}

    def __call__(self, x, y, w, counters, old: dict, *, lr: float,
                 n_steps: int, need: int, standardize: bool = True):
        if self.on_cpu(x, y, w, counters, *param_leaves(old)):
            return mlp_fit_plain(x, y, w, counters, old, lr=lr,
                                 n_steps=n_steps, need=need,
                                 standardize=standardize)
        return self._launch(x, y, w, counters, old, lr, n_steps, need,
                            standardize)

    def gradient(self, x, y, w, counters, params: dict, *, need: int,
                 standardize: bool = True) -> torch.Tensor:
        if self.on_cpu(x, y, w, counters, *param_leaves(params)):
            return mlp_gradient_plain(x, y, w, counters, params, need=need,
                                      standardize=standardize)
        P = mlp_layout(mlp_sizes(params["layers"]))[1]
        grad = torch.zeros(P, dtype=torch.float32, device=x.device)
        self._launch(x, y, w, counters, params, 0.0, 1, need, standardize,
                     grad)
        self.mode_launches["gradient"] += 1
        return grad

    def _launch(self, x, y, w, counters, old, lr, n_steps, need,
                standardize, grad=None):
        stats = [old[k] for k in MLP_KEYS]
        sizes = mlp_sizes(old["layers"])
        check_caps(sizes)
        n_cap, S = x.shape
        C = sizes[-1]
        f32 = torch.float32
        self.expect(x, "x", f32, (n_cap, sizes[0]))
        self.expect(y, "y", f32, (n_cap, C))
        self.expect(w, "w", f32, (n_cap,))
        self.expect(counters, "counters", torch.int32, (5,))
        for k, n in zip(MLP_KEYS, (S, S, C, C)):
            self.expect(old[k], k, f32, (n,))
        flat_old = pack_layers(old["layers"])
        P = flat_old.numel()
        dev = x.device
        flat = torch.empty(P, dtype=f32, device=dev)
        out = {k: torch.empty_like(old[k]) for k in MLP_KEYS}
        flags = torch.empty(2, dtype=torch.int32, device=dev)
        part = torch.empty(-(-n_cap // TILE_ROWS) * P, dtype=f32, device=dev)
        cols = torch.empty(-(-n_cap // COL_ROWS) * max(S, C),
                           dtype=torch.float64, device=dev)
        mom = torch.empty(2 * P, dtype=f32, device=dev)
        wfin = torch.empty(2, dtype=f32, device=dev)
        arr, widths = widths_arg(sizes)
        err = _build.library().pyabc_mlp_fit(
            x.data_ptr(), y.data_ptr(), w.data_ptr(), n_cap, widths,
            len(sizes) - 1, counters.data_ptr(), int(need), float(lr),
            int(n_steps), int(bool(standardize)), flat_old.data_ptr(),
            *(t.data_ptr() for t in stats), flat.data_ptr(),
            *(out[k].data_ptr() for k in MLP_KEYS), flags.data_ptr(),
            part.data_ptr(), cols.data_ptr(), mom.data_ptr(),
            wfin.data_ptr(), self.ptr(grad), _build.stream_ptr(dev))
        del arr
        _build.check(err, self.name)
        self.launches += 1
        return {"layers": unpack_layers(flat, sizes), **out}, flags


mlp_fit = MlpFit()
