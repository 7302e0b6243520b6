from repro_torch.optim.optimizers import (
    Optimizer, adam, apply_updates, clip_by_global_norm, constant_schedule,
    sgd,
)
