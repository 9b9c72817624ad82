from .parameters import ParameterSpace
from .population import Population
from .random_variables import (RV, Distribution, LowerBoundDecorator, RVBase,
                               RVDecorator, ScipyRV)
from .sumstat_spec import SumStatSpec

__all__ = ["ParameterSpace", "Population", "RV", "RVBase", "RVDecorator",
           "LowerBoundDecorator", "ScipyRV", "Distribution", "SumStatSpec"]
