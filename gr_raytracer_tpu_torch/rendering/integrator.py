"""Integration types: stop codes, budget configuration and the per-ray
result (port of the types in gr_raytracer_tpu/rendering/integrator.py).

Stop-reason priority follows the reference integrator: non-finite position
> horizon > trapped orbit > celestial sphere > non-finite momentum.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

# Stop codes (order encodes render semantics, not priority).
RUNNING = 0
HORIZON = 1  # -> opaque black, Captured
CELESTIAL = 2  # -> celestial texture, Escaped
NAN = 3  # -> degenerate ray, Captured
TRAPPED = 4  # closed orbit -> opaque black, Captured
BUDGET = 5  # max_steps exhausted, no stop reason -> Captured
STEP_FAILED = 6  # shading failure -> default sample
# The march stopped because an opaque object hit saturated the alpha fold:
# everything behind the first event is invisible, so color and ray class are
# exact; only the stop code cannot tell HORIZON from CELESTIAL.
SATURATED = 7


@dataclass(frozen=True)
class IntegrationConfig:
    """Integration budget. step_size and epsilon belong to the adaptive
    RKF45 path; the fixed-step kernel path reads max_radius, max_steps and
    max_events (the event slots of a ray; the render driver re-traces a ray that
    overflows them with more, rendering/raytracer.py)."""

    max_radius: float
    step_size: float
    epsilon: float
    max_steps: int = 20000
    max_events: int = 8


class IntegrationResult(NamedTuple):
    y: torch.Tensor  # [N, 8] final state
    stop_code: torch.Tensor  # [N] int32
    steps: torch.Tensor  # [N] step count
    ev_kind: torch.Tensor  # [N, K] int32 object index, -1 = empty
    ev_data: torch.Tensor  # [N, K, 12] per-event payload
    ev_count: torch.Tensor  # [N]
    ev_overflow: torch.Tensor  # [N] bool — events dropped (buffer full)
