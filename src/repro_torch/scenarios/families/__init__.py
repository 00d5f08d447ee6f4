"""Procedural scenario families (copies of ``repro/scenarios/families``).
Importing this package registers every family with
``repro_torch.scenarios.registry``."""
from repro_torch.scenarios.families import (freeform, highway, intersection,
                                            left_turn, merge, pedestrian,
                                            roundabout)

__all__ = ["freeform", "highway", "intersection", "left_turn", "merge",
           "pedestrian", "roundabout"]
