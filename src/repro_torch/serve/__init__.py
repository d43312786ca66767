from repro_torch.serve.steps import make_decode_step, make_prefill_step  # noqa: F401


def __getattr__(name):
    # on first use: serve.dse / serve.cache pull in the whole search stack,
    # which LM serving (serve.engine, serve.steps) does not need
    if name in ("AsyncDSEService", "DSEService", "RetryPolicy", "ServiceStats",
                "paper_request_mix"):
        from repro_torch.serve import dse

        return getattr(dse, name)
    if name in ("CacheStats", "ResultCache", "request_key"):
        from repro_torch.serve import cache

        return getattr(cache, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
