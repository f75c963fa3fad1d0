from repro_torch.optim.optimizer import (SGD, Adam, AdamW, Optimizer,
                                        clip_by_global_norm, global_norm)
from repro_torch.optim.schedules import (TimeScales, constant, constant_ttur,
                                        equal_timescale, power_decay)

__all__ = ["Optimizer", "SGD", "Adam", "AdamW", "global_norm",
           "clip_by_global_norm", "TimeScales", "constant", "power_decay",
           "equal_timescale", "constant_ttur"]
