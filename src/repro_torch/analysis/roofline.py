"""Roofline model for one NVIDIA H100 SXM (the port's
``src/repro/analysis/roofline.py``, with the card's constants in place of
the TPU's).

Three terms per (arch x shape x mesh) cell, all in seconds:

    compute    = FLOPs_per_device            / PEAK_FLOPS
    memory     = bytes_per_device            / HBM_BW
    collective = collective_bytes_per_device / LINK_BW

The dry-run (``launch/dryrun.py``) traces one rank of the mesh, so its
FLOPs, bytes and collective bytes are already per card.  The collective
term takes NVLink's 450 GB/s each way per card: that holds inside one
host's 8 cards, and is optimistic for an axis wider than a host, whose
traffic crosses the slower network between hosts.

The useful-compute ratio compares the analytic model FLOPs (6·N_active·D
for training, 2·N_active·tokens for inference, plus attention) against the
counted total: remat's recomputation and work repeated across ranks show
as a ratio below 1.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.analysis.census import CollectiveStats

# ---- hardware constants (NVIDIA H100 SXM data sheet, dense, 700 W) ----------
PEAK_FLOPS = 989e12          # bf16 FLOP/s per card (tensor cores, dense)
HBM_BW = 3.35e12             # HBM3 bytes/s per card
LINK_BW = 450e9              # NVLink 4 bytes/s per card, each way (900 GB/s both)
HBM_GB = 80.0                # HBM capacity per card


@dataclasses.dataclass
class Roofline:
    cell: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes: float
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    model_flops_global: float      # analytic 6ND / 2ND
    useful_ratio: float            # model_flops / (counted flops x chips)
    peak_fraction: float           # t_compute / max(all terms)
    mem_per_device_gb: float = 0.0
    collectives: Optional[Dict[str, int]] = None

    def table_row(self) -> str:
        return (
            f"| {self.cell} | {self.mesh} | {self.t_compute*1e3:.2f} | "
            f"{self.t_memory*1e3:.2f} | {self.t_collective*1e3:.2f} | "
            f"{self.bottleneck} | {self.useful_ratio:.2f} | "
            f"{self.peak_fraction:.2%} |"
        )


def roofline_terms(
    *,
    cell: str,
    mesh_name: str,
    chips: int,
    flops: float,
    bytes_accessed: float,
    coll: CollectiveStats,
    model_flops_global: float,
    mem_per_device: float = 0.0,
) -> Roofline:
    t_c = flops / PEAK_FLOPS
    t_m = bytes_accessed / HBM_BW
    t_x = coll.total_bytes / LINK_BW
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    bottleneck = max(terms, key=terms.get)
    worst = max(terms.values())
    useful = model_flops_global / max(flops * chips, 1.0)
    return Roofline(
        cell=cell,
        mesh=mesh_name,
        chips=chips,
        flops_per_device=flops,
        bytes_per_device=bytes_accessed,
        collective_bytes=coll.total_bytes,
        t_compute=t_c,
        t_memory=t_m,
        t_collective=t_x,
        bottleneck=bottleneck,
        model_flops_global=model_flops_global,
        useful_ratio=useful,
        peak_fraction=t_c / worst if worst > 0 else 0.0,
        mem_per_device_gb=mem_per_device / 1e9,
        collectives=dict(coll.by_kind),
    )


def model_flops(cfg, shape) -> float:
    """Analytic 'useful' FLOPs per step for the cell (global, not per card),
    the JAX package's arithmetic:

    train:    6 * N_active * tokens   (fwd 2ND + bwd 4ND)
    prefill:  2 * N_active * tokens
    decode:   2 * N_active * batch    (one token per sequence)
    plus attention-score FLOPs where attention exists (often dominant at 32k).
    """
    n_act = cfg.active_param_count()
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        tokens, mult = B * S, 6.0
    elif shape.kind == "prefill":
        tokens, mult = B * S, 2.0
    else:
        tokens, mult = B * 1, 2.0
    base = mult * n_act * tokens

    # attention score+value FLOPs: 2 * 2 * H * Dh * Sq * Skv_eff per layer
    n_attn = sum(1 for m, _ in cfg.layer_plan() if m == "attn") * cfg.n_blocks
    if cfg.is_encdec:
        n_attn += cfg.encoder_layers + cfg.n_layers  # enc self + dec cross
    if n_attn and cfg.n_heads:
        H, Dh = cfg.n_heads, cfg.head_dim_
        if shape.kind == "train" or shape.kind == "prefill":
            skv = min(S, cfg.sliding_window) if cfg.sliding_window else S
            # causal halves the average effective kv length
            att = 4.0 * H * Dh * S * (skv / 2 if not cfg.sliding_window else skv) * B
            att *= 3.0 if shape.kind == "train" else 1.0
        else:
            skv = min(S, cfg.sliding_window) if cfg.sliding_window else S
            att = 4.0 * H * Dh * 1 * skv * B
        base += att * n_attn
    return base
