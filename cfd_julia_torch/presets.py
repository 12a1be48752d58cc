"""Named reference configurations (counterpart of cfd_julia_tpu/presets.py).

Ported so far: the lid-driven cavity.  Run with
`python -m cfd_julia_torch run <preset>`; any config field can be
overridden on the command line (e.g. --nx 1024).
"""
from __future__ import annotations

import dataclasses

from cfd_julia_torch.models import cavity


@dataclasses.dataclass(frozen=True)
class Preset:
    name: str
    family: str          # cavity
    cfg: object
    reference: str       # reference script this mirrors
    description: str = ""


PRESETS = {
    p.name: p
    for p in [
        Preset("cavity", "cavity", cavity.CavityConfig(),
               "18_NS2D_Lid_Driven_Cavity/lid_driven_cavity.jl",
               "Re=100, 64^2, t=10"),
    ]
}


def get(name: str) -> Preset:
    if name not in PRESETS:
        raise KeyError(
            f"unknown preset {name!r}; available: {', '.join(sorted(PRESETS))}"
        )
    return PRESETS[name]


def with_overrides(preset: Preset, **overrides) -> Preset:
    """Replace config fields (CLI --key value overrides)."""
    if not overrides:
        return preset
    cfg = dataclasses.replace(preset.cfg, **overrides)
    return dataclasses.replace(preset, cfg=cfg)
