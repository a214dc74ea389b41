from repro_torch.train.steps import (  # noqa: F401
    make_prefill_step, make_decode_step,
)
