# Version of the IMC cost model's math (term structure and the constants in
# its formulas; TechParams travel with each request).  The same value as the
# JAX package's: the port computes the same model.  Bump it with any change
# that can move a result bit for identical inputs: the service's result
# cache (``serve.cache.request_key``) hashes it, so a disk tier never serves
# a result of an older model.
COST_MODEL_VERSION = "2"

from repro_torch.imc.tech import TECH, TechParams  # noqa: E402,F401
from repro_torch.imc.cost import (  # noqa: E402,F401
    DesignArrays,
    design_valid,
    evaluate_designs,
    evaluate_one,
)

# repro_torch.imc.tables (the factorized grid-table cost model) is imported
# by its users, never here, as in the JAX package.
