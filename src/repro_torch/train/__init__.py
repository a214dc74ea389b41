from repro_torch.train.steps import (  # noqa: F401
    TrainState, init_train_state, make_train_step, make_prefill_step,
    make_decode_step, dirty_block_stats,
)
