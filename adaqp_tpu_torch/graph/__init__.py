from .partition import partition_graph  # noqa: F401
from .layout import build_layout, PartitionLayout, ExchangePlan  # noqa: F401
