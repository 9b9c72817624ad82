from .base import (ConstantEpsilon, Epsilon, ListEpsilon, MedianEpsilon,
                   QuantileEpsilon)
from .temperature import (AcceptanceRateScheme, DalyScheme, EssScheme,
                          ExpDecayFixedIterScheme, ExpDecayFixedRatioScheme,
                          FrielPettittScheme, ListTemperature,
                          PolynomialDecayFixedIterScheme, Temperature,
                          TemperatureScheme)

__all__ = ["AcceptanceRateScheme", "ConstantEpsilon", "DalyScheme",
           "Epsilon", "EssScheme", "ExpDecayFixedIterScheme",
           "ExpDecayFixedRatioScheme", "FrielPettittScheme", "ListEpsilon",
           "ListTemperature", "MedianEpsilon",
           "PolynomialDecayFixedIterScheme", "QuantileEpsilon", "Temperature",
           "TemperatureScheme"]
