from . import data, metrics, sensitivity  # noqa: F401
from .evaluator import Evaluator  # noqa: F401
from .metrics import get_bits_usage, get_correlation  # noqa: F401
