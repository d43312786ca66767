from repro_torch.data.pipeline import (
    DataState,
    SyntheticLM,
    make_batch_fn,
    pinned,
    prefetch_iter,
    to_device,
)

__all__ = ["DataState", "SyntheticLM", "make_batch_fn", "pinned", "prefetch_iter",
           "to_device"]
