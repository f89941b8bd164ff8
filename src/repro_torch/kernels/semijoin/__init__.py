from repro_torch.kernels.semijoin.ops import (semi_mask, semijoin_build,
                                              semijoin_probe)

__all__ = ["semijoin_build", "semijoin_probe", "semi_mask"]
