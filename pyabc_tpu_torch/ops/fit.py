"""Fits of learned summary statistics, plain PyTorch
(``pyabc_tpu/ops/fit.py`` counterpart, the linear plan).

The Fearnhead-Prangle transform s(x) = E[theta | x] is learned by
regressing accepted thetas on raw summary statistics. These are the
functions the JAX package traces into its multigen kernel: the weighted
ridge fit of ``LinearPredictor`` on masked reservoir rows
(:func:`ridge_fit`), the blown-fit guard (:func:`keep_if_finite`) and
the operands of the transformed-space prefix bound of segmented early
reject (:func:`linear_bound_prepare`; the bound's fold and test are K18's
plain ``lin_bound_fold`` and ``lin_exceeds``). On the card the
port runs them as kernels: K23's fit (``kernels/ridge_fit.py``), K23's
transform (``kernels/linear_sumstat.py``) and K18's transformed mode
(``kernels/linear_bound.py``, ``kernels/segment_round.py``); the kernels'
plain versions call these.

Declared difference: the normal equations are formed and solved in
float64 (the JAX package: float32 and LU). The Gram of S = 128 correlated
statistics has a condition number of 1e4 and more, where a float32 solve
loses all but three digits; in float64 the fit is the same on the card, on
the CPU and in any summation order, and within the JAX suite's 2e-4 of the
JAX package's float32 fit.

The MLP plan: the forward of the tanh network (:func:`mlp_forward`), its
weighted squared loss and gradient by the explicit chain rule
(:func:`mlp_loss_grad`, tanh' = 1 - h^2: no autograd, so it mirrors the
kernel step for step), one Adam update (:func:`adam_update`) and the
boundary fit of warm-started full-batch Adam steps
(:func:`mlp_fit_steps`). On the card they run as K23's MLP fit
(``kernels/mlp_fit.py``) and the MLP transform
(``kernels/mlp_sumstat.py``). A transform's parameters are the JAX
package's structure ``{"layers": [{"w", "b"}, ...], "mu", "sd", "ymu",
"ysd"}``; the kernels read the layers packed in that order
(:func:`pack_layers`).

The GP transform of the host-refit mode (:func:`gp_predict`,
``GPPredictor.device_predict``) runs on the card as the GP kernel
(``kernels/gp_sumstat.py``).
"""
from __future__ import annotations

import numpy as np
import torch

#: floor below which a standardization scale counts as constant
#: (``predictor._standardize_fit``: sd <= 1e-12 -> 1.0)
SD_FLOOR = 1e-12

#: relative eigenvalue threshold under which a direction of the
#: remaining-segments Gram counts as unreachable (numerically null)
NULL_EIG_RTOL = 1e-6

#: the keys of a linear transform's parameters, in the packed order
LINEAR_KEYS = ("W", "b", "mu", "sd")
#: the keys of an MLP transform's parameters beside its ``layers``
MLP_KEYS = ("mu", "sd", "ymu", "ysd")
#: the keys of a GP transform's parameters (``GPPredictor.device_params``)
GP_KEYS = ("X", "a", "ls", "mu", "sd", "ymu")
#: Adam's constants (``pyabc_tpu/ops/fit.py::mlp_fit_steps``, optax's
#: defaults)
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
#: the counters' slots a boundary fit's decision reads
#: (``inference/context.py``)
N_ACC, N_TARGET = 0, 4


def masked_standardize(x: torch.Tensor, mask: torch.Tensor):
    """Per-column (mu, sd) of the masked rows of ``x`` (n, S): the biased
    /n standard deviation with the sd floor, two passes (never E[x^2] -
    mu^2), summed in float64 -> ((S,), (S,)) float32."""
    m = mask.to(torch.float64)
    n = torch.clamp(m.sum(), min=1.0)
    xd = x.to(torch.float64)
    mu = (xd * m[:, None]).sum(0) / n
    var = (((xd - mu.to(torch.float32).to(torch.float64)) ** 2)
           * m[:, None]).sum(0) / n
    sd = torch.sqrt(var).to(torch.float32)
    sd = torch.where(sd > SD_FLOOR, sd, torch.ones_like(sd))
    return mu.to(torch.float32), sd


def ridge_fit(x, y, w, mask, alpha: float) -> dict:
    """Weighted ridge fit on masked rows (``LinearPredictor.fit``'s math):
    weights renormalized to sum n, inputs standardized by the masked (mu,
    sd), ``W = (Xs' diag(w) Xs + alpha I)^-1 Xs' diag(w) (y - ym)``, ``b =
    ym`` the weighted target mean. Rows outside ``mask`` contribute
    nothing. ``x`` (n, S), ``y`` (n, d), ``w`` (n,) nonnegative, ``mask``
    (n,) bool -> ``{"W": (S, d), "b": (d,), "mu": (S,), "sd": (S,)}``
    float32 (the standardized rows in float32, as the JAX package forms
    them; the normal equations and the solve in float64)."""
    x = x.to(torch.float32)
    S = x.shape[1]
    m = mask.to(torch.float32)
    n = torch.clamp(mask.to(torch.float64).sum(), min=1.0)
    mu, sd = masked_standardize(x, mask)
    xs = (((x - mu) / sd) * m[:, None]).to(torch.float64)
    wd = torch.clamp(w.to(torch.float64), min=0.0) * mask.to(torch.float64)
    wd = wd * n / torch.clamp(wd.sum(), min=1e-30)
    yd = y.to(torch.float64)
    A = xs.T @ (xs * wd[:, None]) + alpha * torch.eye(
        S, dtype=torch.float64, device=x.device)
    ym = (wd @ yd) / n
    B = xs.T @ (wd[:, None] * ((yd - ym) * mask.to(torch.float64)[:, None]))
    W = torch.linalg.solve(A, B)
    return {"W": W.to(torch.float32), "b": ym.to(torch.float32), "mu": mu,
            "sd": sd}


def fit_decision(counters: torch.Tensor, n_cap: int, need: int):
    """A boundary fit's decision from the round counters (no host read)
    -> (the kept-row mask (n_cap,), fit): the kept rows are the first
    min(n_acc, n_target); the fit runs when the generation completed
    (n_acc >= min(n_target, n_cap)) and its kept rows reach ``need``."""
    n_acc, n_tgt = counters[N_ACC], counters[N_TARGET]
    n_keep = torch.minimum(n_acc, n_tgt)
    mask = torch.arange(n_cap, device=counters.device) < n_keep
    fit = (n_acc >= torch.clamp(n_tgt, max=n_cap)) & (n_keep >= need)
    return mask, fit


def fit_outcome(new: dict, ok, fit, old: dict):
    """A boundary fit's outcome -> (params, flags): ``new`` (already
    through :func:`keep_if_finite`) where the fit ran, else ``old``; int32
    flags ``[ok, fit]``, ok 1 where no fit ran (K23's flags)."""
    params = param_map(lambda a, b: torch.where(fit, a, b), new, old)
    ok = torch.where(fit, ok, torch.ones_like(ok))
    return params, torch.stack([ok, fit]).to(torch.int32)


def param_map(fn, *trees: dict) -> dict:
    """``fn`` over the leaves of transform parameters of one structure
    (linear ``{"W", "b", "mu", "sd"}`` or MLP ``{"layers", "mu", "sd",
    "ymu", "ysd"}``) -> the same structure."""
    if "layers" in trees[0]:
        layers = [{k: fn(*(t["layers"][i][k] for t in trees))
                   for k in ("w", "b")}
                  for i in range(len(trees[0]["layers"]))]
        return {"layers": layers,
                **{k: fn(*(t[k] for t in trees)) for k in MLP_KEYS}}
    return {k: fn(*(t[k] for t in trees)) for k in LINEAR_KEYS}


def param_leaves(params: dict) -> list:
    """The tensors of transform parameters, layers first."""
    if "layers" in params:
        return ([t for layer in params["layers"] for t in (layer["w"],
                                                          layer["b"])]
                + [params[k] for k in MLP_KEYS])
    return [params[k] for k in LINEAR_KEYS]


def keep_if_finite(new: dict, old: dict):
    """``(params, ok)``: ``new`` when every tensor of it is finite, else
    ``old``; ``ok`` a 0-dim bool tensor (no host read). Every leaf counts,
    an MLP's ``ysd`` too."""
    ok = None
    for leaf in param_leaves(new):
        f = torch.isfinite(leaf).all()
        ok = f if ok is None else ok & f
    return param_map(lambda a, b: torch.where(ok, a, b), new, old), ok


def linear_predict(x: torch.Tensor, params: dict) -> torch.Tensor:
    """``LinearPredictor.device_predict`` over rows: ((x - mu) / sd) @ W +
    b; (n, S) -> (n, C') or (S,) -> (C',)."""
    xs = (x - params["mu"]) / params["sd"]
    return xs @ params["W"] + params["b"]


#: the (rows, cap, S) differences :func:`gp_predict` forms at once, at most
GP_CHUNK_ELEMS = 1 << 24


def gp_predict(x: torch.Tensor, params: dict) -> torch.Tensor:
    """``GPPredictor.device_predict`` over rows: ``xs = (x - mu) / sd``,
    ``k_j = exp(-sum_s (xs_s - X_js)^2 / (2 ls^2))``, then ``k @ a + ymu``;
    (n, S) -> (n, C') or (S,) -> (C',). The squared distances are summed
    from direct differences, a block of rows at a time."""
    single = x.dim() == 1
    xs = (x.reshape(-1, x.shape[-1]) - params["mu"]) / params["sd"]
    X, a = params["X"], params["a"]
    two_ls2 = 2 * params["ls"] ** 2
    step = max(1, GP_CHUNK_ELEMS // max(X.numel(), 1))
    out = torch.cat([
        torch.exp(-((xs[i:i + step, None, :] - X[None]) ** 2).sum(-1)
                  / two_ls2) @ a
        for i in range(0, xs.shape[0], step)]
        or [xs.new_zeros(0, a.shape[1])]) + params["ymu"]
    return out[0] if single else out


def bound_rows(w: torch.Tensor, params: dict) -> torch.Tensor:
    """``At[c, :] = (W[c, :] / sd[c]) * w``: the weighted transformed
    difference is ``(x - x0)^T At`` (the shift cancels)."""
    return (params["W"] / params["sd"][:, None]) * w[None, :]


def null_projector(G: torch.Tensor) -> torch.Tensor:
    """The projector onto the numerically null eigenspace of a symmetric
    ``G``: eigenvalues <= NULL_EIG_RTOL max(lambda_max, 1e-30) count as
    null."""
    lam, Q = torch.linalg.eigh(G)
    lam_max = torch.clamp(lam[-1], min=1e-30)
    null = (lam <= NULL_EIG_RTOL * lam_max).to(G.dtype)
    return (Q * null[None, :]) @ Q.T


def linear_bound_prepare(w: torch.Tensor, params: dict, imap) -> dict:
    """The per-generation operands of the transformed-space prefix bound
    (``pyabc_tpu/ops/fit.py::linear_bound_prepare``; the math is there):
    ``At`` (S, C') and the (n_seg + 1, C', C') projectors onto the null
    spaces of the suffix Grams ``G_j = At[imap[j:]]^T At[imap[j:]]``
    (``G_{n_seg} = 0``: the identity). The Grams and their eigenvectors in
    float64, the projectors returned in float32."""
    At = bound_rows(w, params)
    imap = (imap.cpu().numpy() if isinstance(imap, torch.Tensor)
            else np.asarray(imap))
    n_seg, C = imap.shape[0], At.shape[1]
    Ad = At.to(torch.float64)
    projs = []
    for j in range(n_seg + 1):
        cols = imap[j:].reshape(-1)
        if cols.size:
            rows = Ad[torch.as_tensor(cols, dtype=torch.int64,
                                      device=At.device)]
            G = rows.T @ rows
        else:
            G = torch.zeros(C, C, dtype=torch.float64, device=At.device)
        projs.append(null_projector(G))
    return {"At": At, "proj": torch.stack(projs).to(torch.float32)}


# ------------------------------------------------------------ the MLP plan
def mlp_sizes(layers: list) -> tuple:
    """``(S, H_1, ..., C')`` of a layer stack."""
    return (int(layers[0]["w"].shape[0]),
            *(int(layer["w"].shape[1]) for layer in layers))


def mlp_layout(sizes) -> tuple[list, int]:
    """Where each layer sits in the packed parameters -> ([(offset of w,
    offset of b, fan_in, fan_out), ...], P): every layer's ``w`` (fan_in,
    fan_out) row-major, then its ``b``."""
    out, off = [], 0
    for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
        out.append((off, off + fan_in * fan_out, fan_in, fan_out))
        off += fan_in * fan_out + fan_out
    return out, off


def unpack_layers(flat: torch.Tensor, sizes) -> list:
    """The layer stack as views of the packed parameters ``flat`` (P,)."""
    spots, _p = mlp_layout(sizes)
    return [{"w": flat[ow:ob].view(fi, fo), "b": flat[ob:ob + fo]}
            for ow, ob, fi, fo in spots]


def pack_layers(layers: list) -> torch.Tensor:
    """The packed parameters (P,) float32 of a layer stack: the buffer
    itself where the layers are its views in the packed order (every stack
    the port builds), else a copy."""
    leaves = [t for layer in layers for t in (layer["w"], layer["b"])]
    base = leaves[0]._base
    if (base is not None and base.dim() == 1 and base.is_contiguous()
            and base.dtype == torch.float32):
        spots, P = mlp_layout(mlp_sizes(layers))
        offs = [o for ow, ob, _fi, _fo in spots for o in (ow, ob)]
        if base.numel() == P and all(
                t._base is base and t.is_contiguous()
                and t.storage_offset() - base.storage_offset() == o
                for t, o in zip(leaves, offs)):
            return base
    return torch.cat([t.reshape(-1).to(torch.float32) for t in leaves])


def mlp_forward(layers: list, x: torch.Tensor) -> torch.Tensor:
    """``_mlp_forward``: tanh hidden layers, a linear head; (n, S) ->
    (n, C')."""
    h = x
    for layer in layers[:-1]:
        h = torch.tanh(h @ layer["w"] + layer["b"])
    last = layers[-1]
    return h @ last["w"] + last["b"]


def mlp_predict(x: torch.Tensor, params: dict) -> torch.Tensor:
    """``MLPPredictor.device_predict``: ((x - mu) / sd) through the
    network, then ``* ysd + ymu``; (n, S) -> (n, C') or (S,) -> (C',)."""
    xs = (x - params["mu"]) / params["sd"]
    return mlp_forward(params["layers"], xs) * params["ysd"] + params["ymu"]


def mlp_loss_grad(layers: list, xs, ys, wts, n):
    """The loss ``sum(wts (pred - ys)^2) / (n C')`` of ``mlp_fit_steps``
    and its gradient by the chain rule -> (loss, [{"w", "b"}, ...]).
    ``xs`` (r, S) and ``ys`` (r, C') standardized rows, ``wts`` (r,) their
    weights (0 off the kept rows), ``n`` the kept rows' count (a number or
    a 0-dim tensor). The output gradient is ``(wts 2 / (n C')) (pred -
    ys)``; a hidden layer's ``g_z = (g @ w_next^T) (1 - h^2)``, ``dw = h_in^T
    g_z``, ``db`` the column sums of ``g_z``."""
    hs = [xs]
    for layer in layers[:-1]:
        hs.append(torch.tanh(hs[-1] @ layer["w"] + layer["b"]))
    pred = hs[-1] @ layers[-1]["w"] + layers[-1]["b"]
    C = ys.shape[1]
    n64 = torch.as_tensor(n, dtype=torch.float64, device=xs.device)
    coef = (2.0 / (n64 * C)).to(torch.float32)
    diff = pred - ys
    loss = (wts[:, None] * (diff * diff)).sum() / (
        n64 * C).to(torch.float32)
    g = (wts * coef)[:, None] * diff
    grads = [None] * len(layers)
    for li in range(len(layers) - 1, -1, -1):
        grads[li] = {"w": hs[li].T @ g, "b": g.sum(0)}
        if li:
            h = hs[li]
            g = (g @ layers[li]["w"].T) * (1.0 - h * h)
    return loss, grads


def adam_update(p: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                g: torch.Tensor, t: int, lr: float):
    """One Adam step of ``mlp_fit_steps`` on a tensor -> (p, m, v): the
    moments ``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2) g g``, then
    ``p - lr (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)``, float32 (t
    counts from 1)."""
    f32 = torch.float32
    tt = torch.tensor(float(t), dtype=f32, device=p.device)
    b1 = torch.tensor(ADAM_B1, dtype=f32, device=p.device)
    b2 = torch.tensor(ADAM_B2, dtype=f32, device=p.device)
    m = b1 * m + (1.0 - ADAM_B1) * g
    v = b2 * v + ((1.0 - ADAM_B2) * g) * g
    corr1 = 1.0 - b1 ** tt
    corr2 = 1.0 - b2 ** tt
    p = p - (lr * (m / corr1)) / (torch.sqrt(v / corr2) + ADAM_EPS)
    return p, m, v


def mlp_fit_rows(params: dict, x, y, w, mask, standardize: bool = True):
    """The rows a fit trains on -> (xs, ys, wts, n, {"mu", "sd", "ymu",
    "ysd"}): the inputs and targets standardized by the masked rows
    (``standardize=False``: by the carried ``mu``, ``sd``, ``ymu``,
    ``ysd``, as the host seed fit passes rows it standardized) and zero off
    them, the weights ``max(w, 0)`` on the kept rows normalized to mean 1
    over them, and their count n (at least 1)."""
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    m = mask.to(torch.float32)
    if standardize:
        mu, sd = masked_standardize(x, mask)
        ymu, ysd = masked_standardize(y, mask)
    else:
        mu, sd, ymu, ysd = (params[k] for k in MLP_KEYS)
    xs = ((x - mu) / sd) * m[:, None]
    ys = ((y - ymu) / ysd) * m[:, None]
    n = torch.clamp(m.sum(), min=1.0)
    wts = torch.clamp(w.to(torch.float32), min=0.0) * m
    denom = torch.clamp(wts.to(torch.float64).sum() / n.to(torch.float64),
                        min=1e-30).to(torch.float32)
    return xs, ys, wts / denom, n, {"mu": mu, "sd": sd, "ymu": ymu,
                                    "ysd": ysd}


def mlp_fit_steps(params: dict, x, y, w, mask, *, lr: float, n_steps: int,
                  standardize: bool = True) -> dict:
    """``n_steps`` full-batch Adam steps on the MLP, warm-started from
    ``params`` (``{"layers", "mu", "sd", "ymu", "ysd"}``), on the masked
    rows (:func:`mlp_fit_rows`) -> the same structure; the moments start at
    zero."""
    xs, ys, wts, n, stats = mlp_fit_rows(params, x, y, w, mask, standardize)
    layers = [{k: layer[k].to(torch.float32).clone() for k in ("w", "b")}
              for layer in params["layers"]]
    mo = [{k: torch.zeros_like(layer[k]) for k in ("w", "b")}
          for layer in layers]
    ve = [{k: torch.zeros_like(layer[k]) for k in ("w", "b")}
          for layer in layers]
    for i in range(n_steps):
        _loss, grads = mlp_loss_grad(layers, xs, ys, wts, n)
        for layer, gl, ml, vl in zip(layers, grads, mo, ve):
            for k in ("w", "b"):
                layer[k], ml[k], vl[k] = adam_update(
                    layer[k], ml[k], vl[k], gl[k], i + 1, lr)
    return {"layers": layers, **stats}
