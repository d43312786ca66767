"""The search kernels' wrappers cache their technology constants per call
site's arguments (``imc_eval`` per TechParams; ``ga_gen_step`` per
(TechParams, sbx_prob, n_genes)).  A cache keyed by less than the whole
value would hand one tech's constants to another: every field must key it."""
from __future__ import annotations

import pytest

from repro_torch.core.ga import SBX_PROB
from repro_torch.imc.tech import TECH, TechParams
from repro_torch.kernels.ga_gen_step import ops as gops
from repro_torch.kernels.imc_eval import ops as iops

WRAPPERS = {
    "imc_eval": (iops.consts, iops.build_consts),
    "ga_gen_step": (lambda t: gops.consts(t, SBX_PROB, 9),
                    lambda t: gops.build_consts(t, SBX_PROB, 9)),
}


def _bumped(tech: TechParams, field: str) -> TechParams:
    v = getattr(tech, field)
    return tech._replace(**{field: v + 1 if isinstance(v, int) else v * 1.25 + 0.01})


@pytest.mark.parametrize("field", TechParams._fields)
@pytest.mark.parametrize("wrapper", sorted(WRAPPERS))
def test_cached_consts_follow_every_tech_field(wrapper, field):
    cached, build = WRAPPERS[wrapper]
    other = _bumped(TECH, field)
    a, b = cached(TECH), cached(other)
    assert cached(TECH) is a and cached(other) is b  # one array per tech
    assert b is not a
    assert list(a) == list(build(TECH))  # the cached values are a fresh build's
    assert list(b) == list(build(other))


def test_ga_gen_step_consts_key_on_sbx_prob_and_genes():
    a = gops.consts(TECH, SBX_PROB, 9)
    for args in ((0.5, 9), (SBX_PROB, 8)):
        b = gops.consts(TECH, *args)
        assert b is not a and list(b) == list(gops.build_consts(TECH, *args))
        assert list(b) != list(a)
