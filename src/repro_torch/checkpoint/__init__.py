from repro_torch.checkpoint.store import (  # noqa: F401
    save_checkpoint, restore_checkpoint, latest_step, AsyncCheckpointer,
)
from repro_torch.checkpoint.incremental import (  # noqa: F401
    IncrementalCheckpointer,
)
