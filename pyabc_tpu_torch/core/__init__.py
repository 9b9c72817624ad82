from .parameters import ParameterSpace
from .population import Population
from .random_variables import RV, Distribution
from .sumstat_spec import SumStatSpec

__all__ = ["ParameterSpace", "Population", "RV",
           "Distribution", "SumStatSpec"]
