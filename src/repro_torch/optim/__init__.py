from repro_torch.optim.optimizers import (
    Optimizer, adam, adamw, apply_updates, clip_by_global_norm,
    constant_schedule, cosine_schedule, sgd, warmup_cosine,
)
