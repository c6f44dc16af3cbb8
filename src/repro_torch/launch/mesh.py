"""Hardware constants of the card (the JAX module's per-chip constants).

Only ``HBM_BW`` is ported: the monitor's nominal probe time is measured
against it.  The meshes (`make_production_mesh`, `make_host_mesh`) wait
for the multi-card slice (`distributed/`, ROADMAP.md), and the TPU
constants of `repro.launch.mesh` do not carry over.
"""

from __future__ import annotations

__all__ = ["HBM_BW"]

# NVIDIA H100 SXM5 80 GB: HBM3 at 3.35 TB/s (NVIDIA's H100 datasheet), in
# bytes/s.  A card set below its 700 W power limit may reach less.
HBM_BW = 3.35e12
