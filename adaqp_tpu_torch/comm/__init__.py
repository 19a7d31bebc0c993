from .exchange import variance_proxy  # noqa: F401
