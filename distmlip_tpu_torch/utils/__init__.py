from .checkpoint import as_list, load_params, params_from_numpy

__all__ = ["as_list", "load_params", "params_from_numpy"]
