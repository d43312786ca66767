from repro_torch.checkpoint.store import (  # noqa: F401
    latest_step,
    restore,
    restore_resharded,
    save,
)
