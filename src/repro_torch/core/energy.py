"""Analytical gate-level energy model (a copy of ``repro.core.energy``: the
parts the gateway charges and the SC power's component shares).

Calibrated to the paper's Table 3 (65nm): SC energy ``P_sc(b) * T(b)`` with
``T(b) = T(8) * 2^(b-8)``; binary energy quadratic in the datapath width.
``scaled_report`` projects the model onto another first-layer geometry.
The constants and the float order of operations are those of the reference,
so the ledger agrees with it bit for bit.
"""
from __future__ import annotations

import dataclasses

BITS = tuple(range(2, 9))  # supported precisions, 2..8

T_FRAME_8BIT_US = 16.383  # µs per frame at 8-bit (543.42 nJ / 33.17 mW)
P_SC0_MW = 33.17          # SC power plateau (mW)
_ALPHA = {8: 1.0, 7: 1.0115, 6: 1.0027, 5: 0.9952, 4: 1.0009, 3: 0.9032,
          2: 0.8547}
E_BIN0_NJ, E_BIN1_NJ, E_BIN2_NJ = 19.373, 76.446, 0.6825
A_BIN0, A_BIN1, A_BIN2 = 0.036929, 0.092905, 0.0083095
A_SC0, A_SC1 = 0.9666, 0.0437

N_UNITS = 784            # parallel dot-product units (one per output pixel)
N_KERNELS = 32           # first-layer kernels (weight passes per frame)
K_WINDOW = 25            # 5x5 window -> K products per dot product
# nominal 65nm switching energies (fJ per gate per cycle): relative weights
# that split the SC power into component shares
_FJ = {"and": 1.0, "tff": 6.0, "counter_bit": 4.0, "sng_bit": 5.0}


@dataclasses.dataclass(frozen=True)
class EnergyReport:
    bits: int
    frame_time_us: float
    sc_power_mw: float
    sc_energy_nj: float
    bin_power_mw: float
    bin_energy_nj: float
    sc_area_mm2: float
    bin_area_mm2: float

    @property
    def efficiency_gain(self) -> float:
        """Binary-over-SC energy ratio (paper: 9.8x at 4-bit, ~1x at 8-bit)."""
        return self.bin_energy_nj / self.sc_energy_nj


def frame_time_us(bits: int) -> float:
    return T_FRAME_8BIT_US * 2.0 ** (bits - 8)


def sc_power_mw(bits: int) -> float:
    return P_SC0_MW * _ALPHA[bits]


def sc_energy_nj(bits: int) -> float:
    return sc_power_mw(bits) * frame_time_us(bits)  # mW * µs = nJ


def bin_energy_nj(bits: int) -> float:
    return E_BIN0_NJ + E_BIN1_NJ * bits + E_BIN2_NJ * bits * bits


def bin_power_mw(bits: int) -> float:
    return bin_energy_nj(bits) / frame_time_us(bits)


def sc_area_mm2(bits: int) -> float:
    return A_SC0 + A_SC1 * bits


def bin_area_mm2(bits: int) -> float:
    return A_BIN0 + A_BIN1 * bits + A_BIN2 * bits * bits


def report(bits: int) -> EnergyReport:
    if not 2 <= bits <= 8:
        raise ValueError("model calibrated for 2..8 bits")
    return EnergyReport(
        bits=bits,
        frame_time_us=frame_time_us(bits),
        sc_power_mw=sc_power_mw(bits),
        sc_energy_nj=sc_energy_nj(bits),
        bin_power_mw=bin_power_mw(bits),
        bin_energy_nj=bin_energy_nj(bits),
        sc_area_mm2=sc_area_mm2(bits),
        bin_area_mm2=bin_area_mm2(bits),
    )


def component_shares(bits: int) -> dict[str, float]:
    """Split SC power into gate-class shares (relative 65nm weights)."""
    depth_leaves = 1 << (K_WINDOW - 1).bit_length()   # the tree's leaves
    n_and = 2 * K_WINDOW * N_UNITS
    n_tff = 2 * (depth_leaves - 1) * N_UNITS
    n_cnt_bits = 2 * bits * N_UNITS
    n_sng_bits = bits * (K_WINDOW + 1)      # weight SNG bank, amortized
    raw = {
        "and_multipliers": n_and * _FJ["and"],
        "tff_adders": n_tff * _FJ["tff"],
        "counters": n_cnt_bits * _FJ["counter_bit"],
        "sng_bank": n_sng_bits * _FJ["sng_bit"],
    }
    total = sum(raw.values())
    return {k: v / total for k, v in raw.items()}


def scaled_report(bits: int, k_window: int, n_units: int, n_kernels: int
                  ) -> EnergyReport:
    """Project the calibrated model onto another first-layer geometry."""
    base = report(bits)
    gate_scale = (k_window * n_units) / float(K_WINDOW * N_UNITS)
    pass_scale = n_kernels / float(N_KERNELS)
    return EnergyReport(
        bits=bits,
        frame_time_us=base.frame_time_us * pass_scale,
        sc_power_mw=base.sc_power_mw * gate_scale,
        sc_energy_nj=base.sc_energy_nj * gate_scale * pass_scale,
        bin_power_mw=base.bin_power_mw * gate_scale,
        bin_energy_nj=base.bin_energy_nj * gate_scale * pass_scale,
        sc_area_mm2=base.sc_area_mm2 * gate_scale,
        bin_area_mm2=base.bin_area_mm2 * gate_scale,
    )
