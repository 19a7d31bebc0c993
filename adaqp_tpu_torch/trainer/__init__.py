from .config import RunConfig  # noqa: F401
from .trainer import Trainer, setup_logger  # noqa: F401
