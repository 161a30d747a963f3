from .convert import params_from_jax, params_to_jax
from .model import Model
from .transformer import Stage, layer_kind, stages

__all__ = ["Model", "Stage", "layer_kind", "stages", "params_from_jax",
           "params_to_jax"]
