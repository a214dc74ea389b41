from repro_torch.optim.optimizers import (  # noqa: F401
    OptState, init_opt_state, apply_updates, make_schedule, global_norm,
)
