from . import nsga2  # noqa: F401
from .optimizer import Search, prune_by_sensitivity  # noqa: F401
from .space import SearchSpace  # noqa: F401
