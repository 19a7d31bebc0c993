from .spmm_fast import ell_from_csr  # noqa: F401
from .spmm_strip import run_strip, strip_layout, strip_spmm  # noqa: F401
