from repro_torch.configs.base import (DEFAULT_ISP_STAGES, EncodingConfig,
                                     ISPConfig, SNNConfig, TuneConfig)

__all__ = ["DEFAULT_ISP_STAGES", "EncodingConfig", "ISPConfig", "SNNConfig",
           "TuneConfig"]
