from repro_torch.hw.specs import (AsicSpec, ChipSpec, GpuSpec, H100_SXM,
                                  SISA_ASIC, TPU_BASELINE_ASIC, TPU_V5E)

__all__ = ["TPU_V5E", "H100_SXM", "SISA_ASIC", "TPU_BASELINE_ASIC",
           "ChipSpec", "GpuSpec", "AsicSpec"]
