"""The optimizer of SNN training, the counterpart of ``repro.optim``."""
from repro_torch.optim.adamw import (AdamWConfig, adamw_init,  # noqa: F401
                                     adamw_update, global_norm)
from repro_torch.optim.schedule import warmup_cosine  # noqa: F401
