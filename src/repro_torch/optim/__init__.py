"""Optimizer and LR schedules (port of ``repro/optim``)."""
from repro_torch.optim.adamw import (  # noqa: F401
    AdamWState, adamw_init, adamw_update, decay_mask, global_norm,
)
from repro_torch.optim.schedule import cosine_schedule, linear_warmup  # noqa: F401
