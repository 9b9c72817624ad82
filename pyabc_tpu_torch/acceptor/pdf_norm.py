"""pdf normalization strategies for the stochastic acceptor
(``pyabc_tpu/acceptor/pdf_norm.py`` counterpart, a copy of its numpy code).

The host functions compute the norm from a calibration sample or a
generation's accepted kernel values; on the device path the same recursion
runs in the K21b kernel (``kernels/temperature_update.py``). All values are
on log scale.
"""
from __future__ import annotations

import numpy as np


def pdf_norm_from_kernel(kernel_val=None, pdf_max=None, max_found=None,
                         prev_pdf_norm=None) -> float:
    """Use the kernel's analytic maximum density (requires pdf_max)."""
    if pdf_max is None:
        raise ValueError("kernel provides no analytic pdf_max")
    return float(pdf_max)


def pdf_norm_max_found(kernel_val=None, pdf_max=None, max_found=None,
                       prev_pdf_norm=None) -> float:
    """Normalize by the maximum kernel value found so far (reference default).

    Uses the analytic maximum when available and finite, otherwise the
    running max over all evaluated kernel values (never decreasing).
    """
    candidates = []
    if pdf_max is not None and np.isfinite(pdf_max):
        candidates.append(float(pdf_max))
    if max_found is not None and np.isfinite(max_found):
        candidates.append(float(max_found))
    if prev_pdf_norm is not None and np.isfinite(prev_pdf_norm):
        candidates.append(float(prev_pdf_norm))
    if not candidates:
        return 0.0
    # analytic max dominates if present; otherwise monotone running max
    if pdf_max is not None and np.isfinite(pdf_max):
        return float(pdf_max)
    return float(max(candidates))


class ScaledPDFNorm:
    """Down-scale the norm when acceptance would be pathologically rare
    (pyabc ScaledPDFNorm): uses max_found minus an offset once the plain
    max-found norm would imply acceptance rates below ``target``.
    """

    def __init__(self, factor: float = 10.0, alpha: float = 0.5):
        self.factor = float(factor)
        self.alpha = float(alpha)

    def __call__(self, kernel_val=None, pdf_max=None, max_found=None,
                 prev_pdf_norm=None) -> float:
        base = pdf_norm_max_found(
            kernel_val=kernel_val, pdf_max=pdf_max, max_found=max_found,
            prev_pdf_norm=prev_pdf_norm,
        )
        if kernel_val is None or len(np.atleast_1d(kernel_val)) == 0:
            return base
        vals = np.asarray(kernel_val, np.float64)
        quant = np.quantile(vals, self.alpha)
        offsetted = quant + np.log(self.factor)
        return float(min(base, offsetted)) if offsetted < base else float(base)

    @property
    def __name__(self):
        return "ScaledPDFNorm"
