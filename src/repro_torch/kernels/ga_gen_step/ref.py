"""Plain PyTorch version of the ga_gen_step kernel: the port's own
table-backend generation step (``core.ga.plain_gen_step`` scored by the
factorized tables and the indexed objective), re-exported here so the
kernel and its plain version sit side by side."""
from __future__ import annotations

import torch

from repro_torch.core.ga import MUT_ETA, SBX_ETA, SBX_PROB, plain_gen_step
from repro_torch.core.objectives import make_indexed_objective
from repro_torch.imc.tables import WorkloadTables, evaluate_genomes_tables
from repro_torch.imc.tech import TECH, TechParams

_OBJECTIVE = make_indexed_objective()


def table_scores(genomes: torch.Tensor, tables: WorkloadTables,
                 kind: torch.Tensor, area: torch.Tensor,
                 tech: TechParams = TECH) -> torch.Tensor:
    """Indexed-objective scores (B, P) of genomes (B, P, n) on per-search
    tables (B, W, ...), kind (B,) int and area (B,) float."""
    return _OBJECTIVE(evaluate_genomes_tables(genomes, tables, tech), kind, area)


def ga_gen_step_ref(pop, scores, u, tables, kind, area, *, tech=TECH,
                    sbx_prob=SBX_PROB, sbx_eta=SBX_ETA, mut_eta=MUT_ETA):
    """One generation: ``(new_pop, new_scores, children, child_scores)``."""
    return plain_gen_step(
        pop, scores, u,
        lambda g, ctx: table_scores(g, *ctx, tech), (tables, kind, area),
        sbx_prob=sbx_prob, sbx_eta=sbx_eta, mut_eta=mut_eta,
    )
