from repro_torch.configs.base import (DEFAULT_ISP_STAGES, EncodingConfig,
                                     FaultConfig, FleetConfig, ISPConfig,
                                     SNNConfig, SupervisorConfig, TuneConfig)

__all__ = ["DEFAULT_ISP_STAGES", "EncodingConfig", "FaultConfig",
           "FleetConfig", "ISPConfig", "SNNConfig", "SupervisorConfig",
           "TuneConfig"]
