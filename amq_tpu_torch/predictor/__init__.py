from .factory import get_predictor  # noqa: F401
from .mlp import MLP  # noqa: F401
from .rbf import RBF  # noqa: F401
