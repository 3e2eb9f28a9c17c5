from .checkpoint import AsyncSaver, as_list, load_params, params_from_numpy, save_params

__all__ = ["AsyncSaver", "as_list", "load_params", "params_from_numpy", "save_params"]
