"""Regression predictors for learned summary statistics
(``pyabc_tpu/predictor/`` counterpart)."""
from .predictor import (GPPredictor, LassoPredictor, LinearPredictor,
                        MLPPredictor, ModelSelectionPredictor, Predictor)

__all__ = ["GPPredictor", "LassoPredictor", "LinearPredictor",
           "MLPPredictor", "ModelSelectionPredictor", "Predictor"]
