"""Sharding of the LM over a (pod, data, model) mesh: the logical rules
(``sharding``), the model's layout hints (``ctx``) and the int8 gradient
all-reduce (``compression``)."""
from repro_torch.distributed.sharding import (  # noqa: F401
    LOGICAL_RULES,
    batch_axes,
    cache_spec,
    input_sharding,
    make_rules,
    named_sharding_tree,
    params_sharding,
)
