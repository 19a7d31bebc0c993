from .timer import Timer  # noqa: F401
from .recorder import Recorder  # noqa: F401
