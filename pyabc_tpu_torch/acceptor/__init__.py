from .acceptor import StochasticAcceptor, UniformAcceptor
from .pdf_norm import ScaledPDFNorm, pdf_norm_from_kernel, pdf_norm_max_found

__all__ = ["ScaledPDFNorm", "StochasticAcceptor", "UniformAcceptor",
           "pdf_norm_from_kernel", "pdf_norm_max_found"]
