"""Scenario families; importing this package registers them. Only the
freeform family is ported so far (see ROADMAP.md)."""
from repro_torch.scenarios.families import freeform  # noqa: F401
