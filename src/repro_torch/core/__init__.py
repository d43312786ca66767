"""The paper's contribution: joint hardware-workload DSE for IMC chips.

* ``space``       the ~1.9e7-config hardware search space and genome codec
* ``ga``          SBX + polynomial-mutation GA, batched over searches
* ``objectives``  f(E_w, L_w, A) s.t. A <= A_constr families
* ``engine``      SearchRequest -> plan -> dispatch / harvest (the
                  implementation behind every search driver)
* ``search``      joint / separate driver wrappers, cross-rescoring
* ``distributed`` searches and populations split over a mesh of ranks
* ``prng``        the JAX package's threefry streams

The names below are the exports of the JAX package's ``core``.  They load
on first use: ``imc.cost`` imports ``core.space``, and the engine imports
``imc.cost``, so importing the engine here would re-enter a module that
is still initializing.
"""
import importlib

__all__ = [
    "EDFPolicy", "GAResult", "OBJECTIVES", "OBJECTIVE_WEIGHTS", "POLICIES",
    "PriorityPolicy", "RequestMeta", "SchedulingPolicy", "SearchEngine", "SearchRequest",
    "SearchResult", "batched_search", "get_policy", "joint_search", "joint_search_batched",
    "make_objective", "make_weighted_objective", "plan_batch", "rescore_designs",
    "run_ga", "run_ga_batched", "run_search", "seed_population",
    "seed_population_batched", "separate_search", "space",
]


def __getattr__(name):
    if name not in __all__:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    if name == "space":
        return importlib.import_module(f"{__name__}.space")
    for sub in ("engine", "ga", "objectives", "search"):
        mod = importlib.import_module(f"{__name__}.{sub}")
        if name in vars(mod):
            return vars(mod)[name]
    raise AttributeError(name)
