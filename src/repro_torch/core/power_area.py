"""Structural power/area model (22 nm FDSOI @ 100 MHz, §6.1; port of
``repro/core/power_area.py``, the same constants and inventories, so every
row equals the JAX package's).

Calibration policy (DESIGN.md §5): the per-unit constants below are fixed
against exactly two published anchors —

  (1) the spatio-temporal power split of Fig. 2(a): 29% comm-config /
      19% compute-config / 15% router, and
  (2) Plaid 2×2 fabric area = 33,366 µm² (§7) with the Fig. 13 split
      (≈40% communication, ≈50% compute+config, remainder registers).

Every headline ratio (−43% power, −46%/−48% area, spatial power parity) is
then *derived* from module inventories, not fitted; derived-vs-published
deltas are printed by benchmarks/bench_power_area.py.

Inventories:
  ST PE     : 64-bit config word (38 comm + 26 comp) × 16 entries, 6×5
              crossbar (30 crosspoints), 1 ALU, 8 × 16-bit registers.
  Plaid PCU : 120-bit config word (66 comm + 54 comp) × 16 entries
              (§4.3), local router 24 xp + global router 36 xp, 3 ALUs +
              1 ALSU (1.4× ALU), 10 registers.
  Spatial PE: ST fabric, config clock-gated after load (leakage only),
              register activity ≈ 1/3 (values pinned in place), small
              dataflow-handshake control adder.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

# ---- absolute anchors -----------------------------------------------------
ST_PE_POWER_UW = 175.0  # assumed HyCUBE-class 4x4 fabric = 2.8 mW total
PLAID_FABRIC_AREA_UM2 = 33_366.0  # published (§7)

# ---- per-unit area constants (µm²) — solved from anchors (see DESIGN.md) --
A_CFG_BIT = 1.9304
A_XPOINT = 21.63
A_ALU = 569.0
A_REG = 83.4

# ---- per-unit power constants (µW @100MHz) — solved from Fig. 2(a) --------
P_CFG_READ_BIT = 0.919  # per word-bit read each cycle
P_CFG_LEAK_BIT = 0.0246  # per stored bit
P_XPOINT = 0.875
P_ALU = 38.5
P_REG = 3.28


@dataclass(frozen=True)
class Inventory:
    cfg_word_comm: int
    cfg_word_comp: int
    cfg_entries: int
    xpoints: int
    alus: float  # ALSU counts 1.4
    regs: int
    tiles: int
    cfg_read_active: bool = True  # spatial clock-gates reads
    reg_activity: float = 1.0
    ctrl_uw: float = 0.0  # dataflow handshake (spatial)
    area_factor: float = 1.0


def inventory(arch_name: str) -> Inventory:
    if arch_name in ("st4x4", "spatio_temporal", "st"):
        return Inventory(38, 26, 16, 30, 1.0, 8, 16)
    if arch_name == "st6x6":
        return Inventory(38, 26, 16, 30, 1.0, 8, 36)
    if arch_name in ("spatial4x4", "spatial"):
        return Inventory(38, 26, 16, 30, 1.0, 8, 16,
                         cfg_read_active=False, reg_activity=1 / 3,
                         ctrl_uw=5.8, area_factor=1.04)
    if arch_name in ("plaid2x2", "plaid"):
        return Inventory(66, 54, 16, 24 + 36, 3 + 1.4, 10, 4)
    if arch_name == "plaid3x3":
        return Inventory(66, 54, 16, 24 + 36, 3 + 1.4, 10, 9)
    if arch_name == "st4x4_ml":  # REVAMP-style pruned ST (§7.3)
        return Inventory(38, 18, 16, 30, 0.6, 8, 16)
    if arch_name == "plaid_ml":  # 4 hardwired PCUs: no local router,
        return Inventory(30, 54, 16, 36, 3 + 1.4, 10, 4)  # comm cfg 66->30
    raise ValueError(arch_name)


def tile_power_uw(inv: Inventory) -> Dict[str, float]:
    word = inv.cfg_word_comm + inv.cfg_word_comp
    read = P_CFG_READ_BIT * word if inv.cfg_read_active else 0.0
    leak = P_CFG_LEAK_BIT * word * inv.cfg_entries
    comm_frac = inv.cfg_word_comm / word
    cfg_comm = (read + leak) * comm_frac
    cfg_comp = (read + leak) * (1 - comm_frac)
    router = P_XPOINT * inv.xpoints
    alu = P_ALU * inv.alus
    regs = P_REG * inv.regs * inv.reg_activity
    return {
        "cfg_comm": cfg_comm,
        "cfg_comp": cfg_comp,
        "router": router,
        "alu": alu,
        "regs": regs + inv.ctrl_uw,
    }


def fabric_power_uw(arch_name: str) -> Dict[str, float]:
    inv = inventory(arch_name)
    per = tile_power_uw(inv)
    out = {k: v * inv.tiles for k, v in per.items()}
    out["total"] = sum(out.values())
    return out


def tile_area_um2(inv: Inventory) -> Dict[str, float]:
    word = inv.cfg_word_comm + inv.cfg_word_comp
    bits = word * inv.cfg_entries
    comm_frac = inv.cfg_word_comm / word
    cfg = A_CFG_BIT * bits
    return {
        "cfg_comm": cfg * comm_frac,
        "cfg_comp": cfg * (1 - comm_frac),
        "router": A_XPOINT * inv.xpoints,
        "alu": A_ALU * inv.alus,
        "regs": A_REG * inv.regs,
    }


def fabric_area_um2(arch_name: str) -> Dict[str, float]:
    inv = inventory(arch_name)
    per = tile_area_um2(inv)
    out = {k: v * inv.tiles * inv.area_factor for k, v in per.items()}
    out["total"] = sum(out.values())
    return out


def energy_uj(arch_name: str, cycles: int, freq_hz: float = 100e6) -> float:
    p_uw = fabric_power_uw(arch_name)["total"]
    return p_uw * 1e-6 * cycles / freq_hz * 1e6  # µJ


def energy_sweep(entries: Sequence[Tuple[str, object, int]],
                 sim_iterations: int = 3, freq_hz: float = 100e6,
                 device=None, backend: Optional[str] = None
                 ) -> List[Dict[str, object]]:
    """Verified power/area/energy table over mapped fabrics.

    ``entries`` is a sequence of ``(arch_name, mapping, iterations)``
    rows.  Every mapping in the sweep is cycle-verified through ONE
    batched :func:`repro_torch.sim.batch.simulate_batch` call on
    ``device`` (default ``cuda``; ``backend`` as
    :func:`~repro_torch.sim.batch.select_backend` takes it; a failing
    mapping is a ``verified: False`` row, not an exception), then folded
    with the structural power model into per-fabric energy;
    ``sim_backend`` names what verified each row.  Spatial results have no
    modulo mapping to batch — callers keep using :func:`energy_uj` on
    their analytic cycle counts.
    """
    # lazy: the simulator builds on core
    from repro_torch.sim.batch import simulate_batch

    mappings = [m for _, m, _ in entries]
    verdicts = simulate_batch(mappings, iterations=sim_iterations,
                              device=device, backend=backend)
    out: List[Dict[str, object]] = []
    for (arch_name, m, iters), v in zip(entries, verdicts):
        cycles = m.cycles(iters)
        out.append({
            "arch": arch_name,
            "ii": m.ii,
            "cycles": cycles,
            "verified": bool(v.ok),
            "sim_backend": v.backend,
            "power_uw": fabric_power_uw(arch_name)["total"],
            "area_um2": fabric_area_um2(arch_name)["total"],
            "energy_uj": energy_uj(arch_name, cycles, freq_hz),
        })
    return out


def headline_ratios() -> Dict[str, float]:
    """Derived counterparts of the paper's headline claims."""
    p_st = fabric_power_uw("st4x4")["total"]
    p_plaid = fabric_power_uw("plaid2x2")["total"]
    p_spatial = fabric_power_uw("spatial4x4")["total"]
    a_st = fabric_area_um2("st4x4")["total"]
    a_plaid = fabric_area_um2("plaid2x2")["total"]
    a_spatial = fabric_area_um2("spatial4x4")["total"]
    return {
        "power_plaid_over_st": p_plaid / p_st,  # paper: 0.57
        "area_plaid_over_st": a_plaid / a_st,  # paper: 0.54
        "power_plaid_over_spatial": p_plaid / p_spatial,  # paper: ~1.0
        "area_plaid_over_spatial": a_plaid / a_spatial,  # paper: 0.52
        "plaid_fabric_area_um2": a_plaid,  # paper: 33,366
    }
