from . import cnn, layers, transformer
from .cnn import cnn_apply, cnn_init, cnn_loss
from .config import ModelConfig
from .transformer import (decode_step, forward, init_caches, init_model,
                          loss_fn, model_param_specs, prefill,
                          stack_cache_specs, token_ce)

__all__ = ["ModelConfig", "cnn", "cnn_apply", "cnn_init", "cnn_loss", "decode_step",
           "forward", "init_caches", "init_model", "layers", "loss_fn",
           "model_param_specs", "prefill", "stack_cache_specs", "token_ce",
           "transformer"]
