"""``rescore_ms.drivers`` in ``cnn4-sweep-kernel``, whose end-to-end metric besides
``setup_s`` is ``device_ms_per_search``: the same reader."""
from bench.harness.spec import Spec

read = Spec().reader("rescore_ms.drivers")
