"""Model substrate of the port: global-attention decoders, dense or MoE."""
from repro_torch.models.transformer import (check_supported, forward_decode,
                                            forward_prefill, init_cache,
                                            init_params)

__all__ = ["check_supported", "forward_prefill", "forward_decode",
           "init_cache", "init_params"]
