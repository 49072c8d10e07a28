"""Model substrate of the port: decoders of global and sliding-window
attention and RG-LRU and RWKV6 recurrent layers, dense or MoE."""
from repro_torch.models.transformer import (check_supported, check_trainable,
                                            forward_decode, forward_prefill,
                                            forward_train, init_cache,
                                            init_params, set_loss_dtype)

__all__ = ["check_supported", "check_trainable", "forward_prefill",
           "forward_decode", "forward_train", "init_cache", "init_params",
           "set_loss_dtype"]
