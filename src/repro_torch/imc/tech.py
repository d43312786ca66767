"""Technology constants for the IMC analytical cost model.

32 nm CMOS + RRAM devices following the paper's stated stack (Sec. III-B):
RRAM from NeuroSim (HfO2 1T1R), ISAAC-style tile/router hierarchy,
CIMLoop/Accelergy-class component energies.  Same fields, defaults and
derived quantities as the JAX package's ``imc/tech.py``; a frozen,
hashable NamedTuple so it can key caches and group requests.

Units: pJ, ns and mm^2 throughout.
"""
from __future__ import annotations

from typing import NamedTuple


class TechParams(NamedTuple):
    # ---- RRAM device (NeuroSim: HfO2 RRAM, 1T1R) ---------------------------
    r_on_ohm: float = 6.0e3          # LRS resistance
    r_off_ohm: float = 1.0e5         # HRS resistance
    cell_area_f2: float = 12.0       # 1T1R cell, in F^2
    feature_nm: float = 32.0         # CMOS node

    # ---- data / precision (paper Sec. IV) -----------------------------------
    weight_bits: int = 8             # 8-bit quantized weights
    input_bits: int = 8              # 8-bit inputs, bit-serial 1b DAC
    adc_bits: int = 8                # fixed 8-bit ADC

    # ---- peripheral circuits (ISAAC / NeuroSim scaled to 32nm) --------------
    adc_energy_pj: float = 2.0       # 8-bit SAR conversion
    adc_area_mm2: float = 3.0e-3     # 8-bit SAR @32nm
    adc_share: int = 32              # columns muxed per ADC
    dac_energy_pj: float = 0.05      # 1-bit row driver per row per phase
    driver_area_mm2_per_row: float = 2.0e-6

    # ---- interconnect (ISAAC-style shared routers) --------------------------
    router_energy_pj_per_byte: float = 1.6
    router_area_mm2: float = 0.05
    router_flit_bytes: float = 4.0           # bytes moved per router per cycle

    # ---- buffers (CACTI-class SRAM @32nm) -----------------------------------
    tile_buf_energy_pj_per_byte: float = 1.0
    glb_energy_pj_per_byte: float = 3.0
    sram_area_mm2_per_mb: float = 1.4
    tile_buf_kb: float = 8.0                 # per-tile IO buffer

    # ---- off-chip (LPDDR4-class) --------------------------------------------
    dram_energy_pj_per_byte: float = 32.0
    dram_bw_bytes_per_ns: float = 25.6       # 25.6 GB/s

    # ---- leakage --------------------------------------------------------------
    leak_mw_per_mm2: float = 5.0

    # ---- voltage/frequency coupling ------------------------------------------
    # alpha-power delay model: t_min(V) = K * V / (V - Vth)^alpha, normalized
    # so that t_min(0.9 V) = 1.0 ns  (i.e. 1 GHz max at nominal voltage).
    v_nominal: float = 0.9
    v_th: float = 0.35
    alpha_power: float = 1.3

    @property
    def g_avg_s(self) -> float:
        """Average cell conductance (Siemens): mid between LRS/HRS."""
        return 0.5 * (1.0 / self.r_on_ohm + 1.0 / self.r_off_ohm)

    @property
    def cell_area_mm2(self) -> float:
        f_m = self.feature_nm * 1e-9
        return self.cell_area_f2 * (f_m ** 2) * 1e6  # m^2 -> mm^2

    def t_min_ns(self, v: float) -> float:
        """Minimum cycle time at operating voltage v (alpha-power law)."""
        k = 1.0 * (self.v_nominal - self.v_th) ** self.alpha_power / self.v_nominal
        return k * v / (v - self.v_th) ** self.alpha_power

    def cell_read_energy_pj(self, v: float, t_pulse_ns: float) -> float:
        """E = V^2 * G * t per active cell per 1-bit phase (pJ):
        V^2 [V^2] * G [S] * t [ns] is 1e-9 J, and the 1e3 factor makes pJ."""
        return (v ** 2) * self.g_avg_s * t_pulse_ns * 1e3


TECH = TechParams()
