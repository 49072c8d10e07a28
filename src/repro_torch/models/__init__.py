"""Model substrate of the port: global-attention decoders, dense or MoE."""
from repro_torch.models.transformer import (check_supported, forward_decode,
                                            forward_prefill, forward_train,
                                            init_cache, init_params,
                                            set_loss_dtype)

__all__ = ["check_supported", "forward_prefill", "forward_decode",
           "forward_train", "init_cache", "init_params", "set_loss_dtype"]
