"""K21b: the per-generation pdf-norm and temperature update of noisy ABC.

Counterpart of ``pyabc_tpu/inference/util.py::DeviceContext.
_stochastic_gen_update`` (the host pair ``StochasticAcceptor._update_norm``
and ``Temperature._set``); the CUDA kernel is
``csrc/temperature_update.cu``, one block fed by device tensors only.

From the generation's accepted kernel values it updates the running
maximum found and the pdf norm (the kernel's ``pdf_max`` where it has one,
else the running maximum; ScaledPDFNorm caps it at the alpha-quantile of
the accepted values plus log(factor), numpy's linear interpolation). Then
every scheme proposes a temperature: the acceptance-rate scheme by a
60-step bisection of log10 T over the record ring, each record reweighted
to the next proposal by exp(clip(logq_new - logq, +-60)); the ESS scheme
by the same bisection over the accepted set; the others in closed form
(Daly's contraction state ``k`` carried). The least proposal wins, clamped
to at most the previous temperature and at least 1, and the final
generation of a known horizon gets T = 1.

The same kernel gives the initial temperature from the calibration
sample (``initial``): the initial scheme over the calibration rows with
uniform weights, no previous temperature (a non-finite proposal falls back
to 1e4, as ``Temperature._set`` does), and the norm from the calibration's
kernel values alone.
"""
from __future__ import annotations

import math

import torch

from . import _build
from .base import Kernel

#: scheme name -> the kernel's code; each scheme has up to 4 parameters
SCHEME_CODES = {
    "acceptance_rate": 0, "exp_decay_fixed_iter": 1,
    "poly_decay_fixed_iter": 2, "exp_decay_fixed_ratio": 3,
    "friel_pettitt": 4, "daly": 5, "ess": 6, "constant": 7,
}
N_PARAMS = 4
BISECT_STEPS = 60
#: the initial temperature when its scheme proposes nothing finite
FALLBACK_T0 = 1e4


def scheme_tables(schemes, device) -> tuple[torch.Tensor, torch.Tensor]:
    """``(name, *params)`` tuples -> int32 codes ``(n,)`` and float32
    parameters ``(n, 4)`` on ``device`` (built once per run)."""
    codes = torch.tensor([SCHEME_CODES[s[0]] for s in schemes],
                         dtype=torch.int32, device=device)
    params = torch.zeros(len(schemes), N_PARAMS, dtype=torch.float32)
    for i, s in enumerate(schemes):
        params[i, :len(s) - 1] = torch.tensor(s[1:], dtype=torch.float64)
    return codes, params.to(device)


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _log_values(v: torch.Tensor, lin: bool) -> torch.Tensor:
    return torch.log(v.clamp_min(1e-30)) if lin else v


def _bisect(ok_at, device) -> torch.Tensor:
    """log10 T bisection on [0, 12]: the upper end after BISECT_STEPS."""
    lo = torch.zeros((), dtype=torch.float32, device=device)
    hi = torch.full((), 12.0, dtype=torch.float32, device=device)
    for _ in range(BISECT_STEPS):
        mid = 0.5 * (lo + hi)
        if bool(ok_at(torch.pow(10.0, mid))):
            hi = mid
        else:
            lo = mid
    return hi


def pdf_norm_plain(res_distance, k_mask, pdf_norm, max_found, *, lin: bool,
                   pdf_max: float | None, pdf_scaled: tuple | None):
    """The norm recursion -> (pdf_norm_next, max_found_next)."""
    logv = _log_values(res_distance, lin)
    mx = torch.where(k_mask, logv, torch.full_like(logv, -math.inf)).max()
    max_found_next = torch.maximum(max_found, mx)
    if pdf_max is not None:
        pdf_norm_next = _f32(pdf_max, logv)
    else:
        pdf_norm_next = torch.maximum(pdf_norm, max_found_next)
    if pdf_scaled is not None:
        factor, q_alpha = pdf_scaled
        svals = torch.sort(torch.where(k_mask, logv,
                                       torch.full_like(logv, math.inf)))[0]
        n_accd = k_mask.sum().clamp_min(1)
        pos = q_alpha * (n_accd - 1).to(torch.float32)
        lo_i, hi_i = torch.floor(pos).long(), torch.ceil(pos).long()
        frac = pos - lo_i.to(torch.float32)
        quant = svals[lo_i] * (1.0 - frac) + svals[hi_i] * frac
        pdf_norm_next = torch.minimum(
            pdf_norm_next, quant + torch.log(_f32(factor, logv)))
    return pdf_norm_next, max_found_next


def record_weights_plain(rec_valid, rec_logq, logq_new) -> torch.Tensor:
    """Normalized record weights: uniform over the valid records, or each
    reweighted to the next proposal (uniform again if all weigh 0)."""
    w_unif = rec_valid.to(torch.float32) / rec_valid.sum().clamp_min(1).to(
        torch.float32)
    if rec_logq is None:
        return w_unif
    lw = logq_new - rec_logq
    lw = torch.where(torch.isnan(lw), lw, lw.clamp(-60.0, 60.0))
    w = torch.where(rec_valid, torch.exp(lw), torch.zeros_like(lw))
    w_sum = w.sum()
    return torch.where(w_sum > 0, w / w_sum.clamp_min(1e-38), w_unif)


def temperature_update_plain(*, rec_distance, rec_valid, rec_logq, logq_new,
                             res_distance, k_mask, w_norm, pdf_norm,
                             max_found, daly_k, temp, acc_rate,
                             schemes: tuple, t_next: int, max_np: int,
                             pdf_max: float | None, lin: bool,
                             pdf_scaled: tuple | None,
                             fallback: float | None = None):
    """Plain PyTorch version -> (temp_next, pdf_norm_next, max_found_next,
    daly_k_next). ``rec_logq`` None: uniform record weights;
    ``fallback`` None: a non-finite proposal keeps ``temp``."""
    pdf_norm_next, max_found_next = pdf_norm_plain(
        res_distance, k_mask, pdf_norm, max_found, lin=lin, pdf_max=pdf_max,
        pdf_scaled=pdf_scaled)
    daly_k_next = daly_k
    if not schemes:
        return temp, pdf_norm_next, max_found_next, daly_k_next
    t_n = float(t_next)
    dev = res_distance.device
    one = torch.ones((), dtype=torch.float32, device=dev)
    props = []
    for sch in schemes:
        name = sch[0]
        if name == "acceptance_rate":
            w_rec = record_weights_plain(rec_valid, rec_logq, logq_new)
            diff = _log_values(rec_distance, lin) - pdf_norm_next

            def rate_at(T, w_rec=w_rec, diff=diff):
                return (w_rec * torch.minimum(
                    one, torch.exp(diff / T))).sum()

            hi = _bisect(lambda T, tgt=sch[1]: rate_at(T) >= tgt, dev)
            prop = torch.where(rate_at(one) >= sch[1], one,
                               torch.pow(10.0, hi))
        elif name == "exp_decay_fixed_iter":
            t_to_go = _f32(max_np - t_n, temp)
            prop = torch.where(
                t_to_go <= 1.0, one,
                temp ** ((t_to_go - 1.0) / t_to_go.clamp_min(1.0)))
        elif name == "poly_decay_fixed_iter":
            t_to_go = _f32(max_np - t_n, temp)
            frac = (t_to_go - 1.0) / t_to_go.clamp_min(1.0)
            prop = torch.where(t_to_go <= 1.0, one,
                               1.0 + (temp - 1.0) * frac ** sch[1])
        elif name == "exp_decay_fixed_ratio":
            a0, min_r, max_r = (_f32(x, temp) for x in sch[1:4])
            a_eff = torch.where(acc_rate < min_r, torch.sqrt(a0),
                                torch.where(acc_rate > max_r, a0 * a0, a0))
            prop = torch.maximum(one, a_eff * temp)
        elif name == "friel_pettitt":
            beta = ((_f32(t_n, temp) + 1.0) / max_np) ** 2
            prop = 1.0 / beta.clamp_min(1e-12)
        elif name == "daly":
            alpha, min_r = sch[1], sch[2]
            daly_k_next = torch.where(acc_rate < min_r, alpha * daly_k,
                                      alpha * torch.minimum(daly_k, temp))
            prop = torch.maximum(one, temp - daly_k_next)
        elif name == "ess":
            prop = _ess_proposal(res_distance, k_mask, w_norm, temp, lin,
                                 sch[1])
        elif name == "constant":
            prop = _f32(sch[1], temp)
        else:
            raise ValueError(f"unknown temperature scheme {name!r}")
        props.append(prop.to(torch.float32).reshape(()))
    props = torch.stack(props)
    props = torch.where(torch.isfinite(props), props,
                        torch.full_like(props, math.inf))
    temp_next = props.min()
    keep = temp if fallback is None else _f32(fallback, temp)
    temp_next = torch.where(torch.isfinite(temp_next), temp_next, keep)
    temp_next = torch.maximum(torch.minimum(temp_next, temp), one)
    if max_np > 0 and t_n >= max_np - 1:
        temp_next = one.clone()
    return temp_next, pdf_norm_next, max_found_next, daly_k_next


def _ess_proposal(res_distance, k_mask, w_norm, temp, lin: bool,
                  target: float) -> torch.Tensor:
    logv = _log_values(res_distance, lin)
    zero = torch.zeros_like(w_norm)
    w_acc = torch.where(k_mask, w_norm, zero)
    w_acc = w_acc / w_acc.sum().clamp_min(1e-38)
    beta_old = 1.0 / temp
    n_accd = k_mask.sum().clamp_min(1).to(torch.float32)

    def rel_ess(T):
        lw = (1.0 / T - beta_old) * logv
        lw = lw - torch.where(k_mask, lw, torch.full_like(lw,
                                                          -math.inf)).max()
        ww = w_acc * torch.where(k_mask, torch.exp(lw), zero)
        s = ww.sum()
        wn = ww / s.clamp_min(1e-38)
        ess = 1.0 / (wn ** 2).sum().clamp_min(1e-38) / n_accd
        return torch.where(s > 0, ess, torch.zeros_like(ess))

    one = torch.ones((), dtype=torch.float32, device=logv.device)
    hi = _bisect(lambda T: rel_ess(T) >= target, logv.device)
    return torch.where(rel_ess(one) >= target, one, torch.pow(10.0, hi))


class TemperatureUpdate(Kernel):
    name = "temperature_update"
    source = "pyabc_tpu_torch/csrc/temperature_update.cu"
    replaces = "pyabc_tpu/inference/util.py:3089"

    def update(self, *, rec: dict, logq_new, res_distance, k_mask, w_norm,
               pdf_norm, max_found, daly_k, temp, acc_rate, tables,
               t_next: int, config):
        """One generation's update from the record ring ``rec``
        (``distance``, ``valid``, ``logq``) and the reservoir; ``tables``
        from :func:`scheme_tables` of ``config.schemes``."""
        if config.needs_logq_new and logq_new is None:
            raise ValueError(f"{self.name}: the acceptance-rate scheme "
                             f"needs logq_new")
        # the ring's proposal densities matter only to the acceptance-rate
        # scheme's reweighting, the one reader of logq_new
        rec_logq = rec.get("logq") if logq_new is not None else None
        return self._run(
            rec["distance"], rec["valid"], rec_logq, logq_new,
            res_distance, k_mask, w_norm, (pdf_norm, max_found, daly_k, temp,
                                           acc_rate),
            config.schemes, tables, t_next, config, calibration=False)

    def initial(self, *, res_distance, k_mask, tables, config):
        """(T0, pdf_norm0, max_found0) from the calibration sample's kernel
        values; ``tables`` from :func:`scheme_tables` of
        ``(config.initial,)``."""
        temp, pdf_norm, max_found, _k = self._run(
            res_distance, k_mask, None, None, res_distance, k_mask, None,
            None, (config.initial,), tables, 0, config, calibration=True)
        return temp, pdf_norm, max_found

    def _run(self, rec_distance, rec_valid, rec_logq, logq_new, res_distance,
             k_mask, w_norm, carry, schemes, tables, t_next, config, *,
             calibration: bool):
        if calibration:
            inf = _f32(math.inf, res_distance)
            zero = torch.zeros((), dtype=torch.float32,
                               device=res_distance.device)
            carry = (-inf, -inf, inf, inf, zero)
            rec_logq = logq_new = None
            w_norm = torch.zeros_like(res_distance)
        pdf_norm, max_found, daly_k, temp, acc_rate = carry
        kw = dict(schemes=schemes, t_next=t_next, max_np=config.max_np,
                  pdf_max=config.pdf_max, lin=config.lin,
                  pdf_scaled=config.pdf_scaled)
        opt = [t for t in (rec_logq, logq_new) if t is not None]
        if self.on_cpu(rec_distance, rec_valid, res_distance, k_mask, w_norm,
                       *carry, *tables, *opt):
            return temperature_update_plain(
                rec_distance=rec_distance, rec_valid=rec_valid,
                rec_logq=rec_logq, logq_new=logq_new,
                res_distance=res_distance, k_mask=k_mask, w_norm=w_norm,
                pdf_norm=pdf_norm, max_found=max_found, daly_k=daly_k,
                temp=temp, acc_rate=acc_rate,
                fallback=FALLBACK_T0 if calibration else None, **kw)
        f32, b8 = torch.float32, torch.bool
        R, n = rec_distance.shape[0], res_distance.shape[0]
        self.expect(rec_distance, "rec_distance", f32, (R,))
        self.expect(rec_valid, "rec_valid", b8, (R,))
        if (rec_logq is None) != (logq_new is None):
            raise ValueError(f"{self.name}: rec_logq and logq_new go "
                             f"together")
        if rec_logq is not None:
            self.expect(rec_logq, "rec_logq", f32, (R,))
            self.expect(logq_new, "logq_new", f32, (R,))
        self.expect(res_distance, "res_distance", f32, (n,))
        self.expect(k_mask, "k_mask", b8, (n,))
        self.expect(w_norm, "w_norm", f32, (n,))
        if not calibration:
            for t, what in zip(carry, ("pdf_norm", "max_found", "daly_k",
                                       "temp", "acc_rate")):
                self.expect(t, what, f32, ())
        codes, params = tables
        self.expect(codes, "codes", torch.int32, (len(schemes),))
        self.expect(params, "params", f32, (len(schemes), N_PARAMS))
        dev = res_distance.device
        out = torch.empty(4, dtype=f32, device=dev)
        scratch = torch.empty(2 * R + 2 * n, dtype=f32, device=dev)
        scaled = config.pdf_scaled or (1.0, 0.5)
        pdf_max = config.pdf_max
        ptr = self.ptr
        err = _build.library().pyabc_temperature_update(
            R, rec_distance.data_ptr(), rec_valid.data_ptr(), ptr(rec_logq),
            ptr(logq_new), n, res_distance.data_ptr(), k_mask.data_ptr(),
            w_norm.data_ptr(), *(None if calibration else t.data_ptr()
                                 for t in carry),
            len(schemes), codes.data_ptr(), params.data_ptr(),
            float(t_next), int(config.max_np), int(pdf_max is not None),
            float(pdf_max if pdf_max is not None else 0.0),
            int(bool(config.lin)), int(config.pdf_scaled is not None),
            float(scaled[0]), float(scaled[1]), int(calibration),
            scratch.data_ptr(), out.data_ptr(), _build.stream_ptr(dev))
        _build.check(err, self.name)
        self.launches += 1
        return out[0], out[1], out[2], out[3]


temperature_update = TemperatureUpdate()
