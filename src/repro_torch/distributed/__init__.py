"""Sharding of the LM over a (pod, data, model) mesh: the logical rules
(``sharding``), the model's layout hints (``ctx``) and the int8 gradient
all-reduce (``compression``)."""
