"""The paper's Table 1 accelerator memory-shape sets (the port's copy of
``repro.core.accelerators``; same rows, inventories and hyperparameters).

Rows are ``(N_PE, (N_SIMD, D, W))`` exactly as printed in the paper; each row
expands to ``N_PE`` buffers of width ``N_SIMD*W`` bits and depth ``D`` (see
``problem.buffers_from_shape_rows``).

RN101/RN152 shape sets are not listed in the paper ("approximately 2x and 3x
deeper than ResNet-50 ... share the overall structure"); we reconstruct them
by scaling the RN50 row multiplicities by the published total-bits ratios
(derived from Table 4's baseline BRAM counts x efficiencies), which
reproduces the published baseline efficiency to within a fraction of a
percent.  This is recorded as a deviation in docs/DESIGN.md section 8.

``OCM_DEVICES`` adds per-device on-chip-memory inventories (nominal
datasheet BRAM18/URAM288 counts) for the heterogeneous model of
docs/DESIGN.md section 3: ``get_problem(name, device="U50")`` is the
one-liner that packs an accelerator onto mixed BRAM+URAM.
"""
from __future__ import annotations

from .problem import (
    BRAM18,
    URAM288,
    Buffer,
    OCMInventory,
    PackingProblem,
    buffers_from_shape_rows,
)

# ---------------------------------------------------------------- Table 1
TABLE1_ROWS: dict[str, list[tuple[int, tuple[int, int, int]]]] = {
    "CNV-W1A1": [
        (16, (32, 144, 1)),
        (16, (32, 288, 1)),
        (4, (32, 2304, 1)),
        (4, (1, 8192, 1)),
        (1, (32, 18432, 1)),
        (1, (4, 32768, 1)),
        (1, (8, 32768, 1)),
    ],
    "CNV-W2A2": [
        (8, (16, 576, 2)),
        (8, (16, 1152, 2)),
        (4, (1, 8192, 2)),
        (4, (8, 9216, 2)),
        (3, (2, 65536, 2)),
        (1, (8, 73728, 2)),
    ],
    "Tincy-YOLO": [
        (16, (32, 144, 1)),
        (25, (8, 320, 1)),
        (16, (32, 144, 1)),
        (80, (32, 2304, 1)),
    ],
    "DoReFaNet": [
        (136, (45, 72, 1)),
        (64, (34, 108, 1)),
        (32, (64, 108, 1)),
        (68, (3, 144, 1)),
        (8, (8, 64000, 1)),
        (4, (64, 65536, 1)),
        (8, (64, 73728, 1)),
    ],
    "ReBNet": [
        (64, (54, 256, 1)),
        (64, (25, 384, 1)),
        (64, (36, 384, 1)),
        (64, (32, 576, 1)),
        (128, (64, 1152, 1)),
        (40, (50, 2048, 1)),
        (128, (64, 2048, 1)),
    ],
    "RN50-W1A2": [
        (368, (32, 256, 1)),
        (32, (64, 256, 1)),
        (192, (64, 288, 1)),
        (176, (32, 1024, 1)),
        (32, (64, 1024, 1)),
        (96, (64, 1152, 1)),
    ],
}

# RN101/RN152: scale RN50 row multiplicities.  ResNet-101/152 add identical
# bottleneck blocks in stage 3, i.e. more buffers of the *same shapes*; the
# published baseline bits give scale factors 1.86x and 2.52x over RN50.
_RN_SCALES = {"RN101-W1A2": 1.859, "RN152-W1A2": 2.515}
for _name, _scale in _RN_SCALES.items():
    TABLE1_ROWS[_name] = [
        (max(1, round(n_pe * _scale)), shape) for n_pe, shape in TABLE1_ROWS["RN50-W1A2"]
    ]

ACCELERATORS = tuple(TABLE1_ROWS)

# Published results for validation (paper Tables 3 and 4).
PAPER_TABLE4 = {
    # name: (baseline_bram, baseline_eff_pct, intra_bram, intra_eff_pct,
    #        inter_bram, inter_eff_pct)
    "CNV-W1A1": (120, 69.3, 100, 82.3, 96, 86.6),
    "CNV-W2A2": (208, 79.9, 192, 86.6, 188, 88.4),
    "Tincy-YOLO": (578, 63.6, 456, 80.7, 420, 87.6),
    "DoReFaNet": (4116, 78.8, 3797, 85.4, 3794, 85.5),
    "ReBNet": (2880, 64.1, 2363, 78.1, 2352, 78.4),
    "RN50-W1A2": (2064, 57.9, 1440, 82.9, 1374, 86.9),
    "RN101-W1A2": (4240, 52.4, 2748, 80.9, 2616, 84.9),
    "RN152-W1A2": (5904, 50.9, 3758, 80.0, 3584, 83.9),
}

PAPER_TABLE3 = {
    # name: (t_ga_s, t_sa_s, bram_ga_s, bram_sa_s,
    #        t_ga_nfd, t_sa_nfd, bram_ga_nfd, bram_sa_nfd)
    "CNV-W1A1": (0.1, 0.2, 96, 96, 0.1, 0.1, 96, 96),
    "CNV-W2A2": (0.1, 0.1, 188, 190, 0.1, 0.1, 190, 188),
    "Tincy-YOLO": (1.8, 1.7, 420, 428, 0.1, 0.2, 430, 420),
    "DoReFaNet": (1.0, 1.6, 3849, 3823, 0.2, 0.1, 3826, 3794),
    "ReBNet": (40.1, 57.5, 2301, 2313, 2.2, 28.9, 2483, 2352),
    "RN50-W1A2": (239, 290, 1404, 1472, 0.8, 1.7, 1368, 1374),
    "RN101-W1A2": (615, 935, 3055, 2775, 0.9, 3.3, 2616, 2616),
    "RN152-W1A2": (1024, 1354, 3864, 4422, 1.5, 49, 3586, 3584),
}

# GA/SA hyperparameters per accelerator (paper Table 2).
PAPER_TABLE2 = {
    # name: dict(n_pop, n_tour, p_adm_w, p_adm_h, p_mut, sa_t0, sa_rc)
    "CNV-W1A1": dict(n_pop=50, n_tour=5, p_adm_w=0.0, p_adm_h=0.1, p_mut=0.3, sa_t0=30, sa_rc=1.0),
    "CNV-W2A2": dict(n_pop=50, n_tour=5, p_adm_w=0.0, p_adm_h=0.1, p_mut=0.3, sa_t0=30, sa_rc=2.0),
    "Tincy-YOLO": dict(n_pop=75, n_tour=5, p_adm_w=0.0, p_adm_h=0.2, p_mut=0.4, sa_t0=30, sa_rc=1.0),
    "DoReFaNet": dict(n_pop=50, n_tour=5, p_adm_w=0.1, p_adm_h=0.3, p_mut=0.4, sa_t0=30, sa_rc=1.0),
    "ReBNet": dict(n_pop=75, n_tour=5, p_adm_w=1.0, p_adm_h=0.2, p_mut=0.4, sa_t0=30, sa_rc=1.0),
    "RN50-W1A2": dict(n_pop=75, n_tour=5, p_adm_w=0.0, p_adm_h=0.1, p_mut=0.4, sa_t0=40, sa_rc=0.004),
    "RN101-W1A2": dict(n_pop=75, n_tour=5, p_adm_w=0.0, p_adm_h=0.1, p_mut=0.4, sa_t0=40, sa_rc=0.004),
    "RN152-W1A2": dict(n_pop=75, n_tour=5, p_adm_w=0.0, p_adm_h=0.1, p_mut=0.4, sa_t0=40, sa_rc=0.004),
}


# Per-device OCM inventories (nominal datasheet primitive counts; BRAM36
# blocks are modeled as two independent BRAM18s, the finer packing grain).
OCM_DEVICES: dict[str, OCMInventory] = {
    # Zynq UltraScale+ ZU7EV (ZCU104): 312 BRAM36 + 96 URAM288
    "ZU7EV": OCMInventory((BRAM18, URAM288), (624, 96), name="ZU7EV"),
    # Alveo U50 (VU35P, HBM): 1344 BRAM36 + 640 URAM288 — the interesting
    # regime: deep ResNets overflow BRAM alone but fit with URAM offload
    "U50": OCMInventory((BRAM18, URAM288), (2688, 640), name="U50"),
    # Alveo U250 (VU13P): 2688 BRAM36 + 1280 URAM288
    "U250": OCMInventory((BRAM18, URAM288), (5376, 1280), name="U250"),
    # Alveo U280 (VU37P, HBM): 2016 BRAM36 + 960 URAM288
    "U280": OCMInventory((BRAM18, URAM288), (4032, 960), name="U280"),
}


def get_ocm(device: str) -> OCMInventory:
    if device not in OCM_DEVICES:
        raise KeyError(
            f"unknown device {device!r}; options: {tuple(OCM_DEVICES)}"
        )
    return OCM_DEVICES[device]


def get_buffers(name: str) -> list[Buffer]:
    if name not in TABLE1_ROWS:
        raise KeyError(f"unknown accelerator {name!r}; options: {ACCELERATORS}")
    return buffers_from_shape_rows(TABLE1_ROWS[name])


def get_problem(
    name: str, max_items: int = 4, device: str | None = None
) -> PackingProblem:
    """Build a Table-1 problem; ``device`` selects a heterogeneous OCM
    inventory from ``OCM_DEVICES`` (default: unbounded BRAM18, the paper)."""
    return PackingProblem(
        get_buffers(name),
        max_items=max_items,
        name=name if device is None else f"{name}@{device}",
        ocm=get_ocm(device) if device is not None else None,
    )


def hyperparams(name: str) -> dict:
    return dict(PAPER_TABLE2.get(name, PAPER_TABLE2["RN50-W1A2"]))
