from .gnn import apply_gnn, init_params, params_from_numpy  # noqa: F401
