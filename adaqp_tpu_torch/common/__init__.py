from .types import (  # noqa: F401
    GNNType,
    Mode,
    Scheme,
    AggregatorType,
    BITS_SET,
)
from .backend import default_device, resolve_device  # noqa: F401
