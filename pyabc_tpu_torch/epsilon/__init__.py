from .base import (ConstantEpsilon, Epsilon, ListEpsilon, MedianEpsilon,
                   QuantileEpsilon)

__all__ = ["ConstantEpsilon", "Epsilon", "ListEpsilon", "MedianEpsilon",
           "QuantileEpsilon"]
