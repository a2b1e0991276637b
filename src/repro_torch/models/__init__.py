from .convert import params_from_reference, tree_to_numpy
from .model import Model
from .params import init_params, param_count

__all__ = ["Model", "init_params", "param_count", "params_from_reference", "tree_to_numpy"]
