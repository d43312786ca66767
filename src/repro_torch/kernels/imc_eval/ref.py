"""Plain PyTorch version of the imc_eval kernel.

Per-(design, layer) closed-form cost terms, identical in math to
``repro_torch.imc.cost.evaluate_designs_arrays`` but laid out as the
(designs x layers) grid the kernel walks, for every workload of every
search at once:

    energy, latency, demand (B, W, P)  =  sums over the (masked) layers.

The leakage term (area x latency) and the fits/valid verdicts are
design-global and stay outside (see ``ops.py``).  The JAX package's
counterpart is ``eval_one_workload`` in its ``kernels/imc_eval/ref.py``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.imc.cost import _rdiv, _true_div
from repro_torch.imc.tech import TECH, TechParams


def eval_workloads(
    designs: torch.Tensor,  # (..., P, 9) decoded design values (space.FIELDS order)
    feats: torch.Tensor,  # (..., W, L, 6) layer features (M, K, N, A_in, A_out, G)
    mask: torch.Tensor,  # (..., W, L) validity
    tech: TechParams = TECH,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (energy_pj, latency_ns, xbar_demand), each (..., W, P)."""
    # designs (..., 1, P, 1) against layers (..., W, 1, L)
    rows, cols, _cpt, _tpr, g_chip, v_op, bits, t_cyc, glb_mb = (
        designs.to(torch.float32)[..., None, :, None, :].unbind(-1))
    M, K, N, Ain, Aout, G = feats.to(torch.float32)[..., :, None, :, :].unbind(-1)
    mk = mask.to(torch.float32)[..., :, None, :]

    phases = float(tech.input_bits)
    cpw = torch.ceil(_rdiv(float(tech.weight_bits), bits))
    ncol = torch.ceil(N * cpw / cols)
    nrow = torch.ceil(K / rows)
    xb = nrow * ncol * G  # (..., W, P, L)
    demand = (xb * mk).sum(-1)

    bytes_l = Ain + Aout
    l_comp = M * phases * tech.adc_share * t_cyc
    l_comm = bytes_l / (g_chip * tech.router_flit_bytes) * t_cyc
    spill = torch.clamp_min(bytes_l - glb_mb * float(1 << 20), 0.0)
    l_dram = _true_div(spill, tech.dram_bw_bytes_per_ns)
    latency = ((l_comp + l_comm + l_dram) * mk).sum(-1)

    e_cell = v_op * v_op * tech.g_avg_s * t_cyc * 1e3
    cells = K * (N * cpw) * G
    e_analog = M * phases * cells * e_cell
    e_adc = M * phases * (N * cpw) * G * tech.adc_energy_pj
    e_dac = M * phases * K * ncol * G * tech.dac_energy_pj
    e_route = bytes_l * tech.router_energy_pj_per_byte
    e_buf = bytes_l * (tech.tile_buf_energy_pj_per_byte + tech.glb_energy_pj_per_byte)
    e_dram = spill * tech.dram_energy_pj_per_byte
    energy = ((e_analog + e_adc + e_dac + e_route + e_buf + e_dram) * mk).sum(-1)

    return energy, latency, demand


def eval_one_workload(designs, feats, mask, tech: TechParams = TECH):
    """One workload: designs (P, 9), feats (L, 6), mask (L,) -> (P,) each."""
    e, l, x = eval_workloads(designs, feats[None], mask[None], tech)
    return e[0], l[0], x[0]
