"""Plain version of the flash-attention kernel.

Re-exports the model's unchunked O(S^2) reference: the kernel must match
this math (same masking semantics: causal + sliding window + GQA +
``q_offset``).
"""
from __future__ import annotations

from repro_torch.models.attention import attention_reference  # noqa: F401
