"""Model substrate of the port: decoders of global and sliding-window
attention and RG-LRU and RWKV6 recurrent layers, dense or MoE, with or
without a stub frontend."""
from repro_torch.models.transformer import (check_supported, forward_decode,
                                            forward_prefill, forward_train,
                                            init_cache, init_params,
                                            set_loss_dtype)

__all__ = ["check_supported", "forward_prefill", "forward_decode",
           "forward_train", "init_cache", "init_params", "set_loss_dtype"]
