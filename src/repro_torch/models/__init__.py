from .bridge import params_from_numpy
from .transformer import Model

__all__ = ["Model", "params_from_numpy"]
