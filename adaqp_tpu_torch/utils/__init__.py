from .timer import Timer, span  # noqa: F401
from .recorder import Recorder  # noqa: F401
