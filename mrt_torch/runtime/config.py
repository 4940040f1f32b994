"""Render configuration (mirrors ``mrt.runtime.config``).

The reference configures everything with compile-time constants and
code edits; mrt makes it a dataclass loaded from CLI flags or JSON,
with the scene picked by name.  The fields, their defaults and the JSON
layout are mrt's, so a config written by either package loads in the
other.  The device is not a field: the CLI's ``--device`` and the
entry points' ``device=`` choose it (None: the CUDA card).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional


@dataclasses.dataclass
class RenderConfig:
    scene: str = "rtiow"
    width: int = 1920                  # 1080p 16:9, as the reference
    height: int = 1080
    max_depth: int = 50
    spp: int = 64
    samples_per_pass: int = 8
    seed: int = 1
    # Animation
    animate: bool = False
    fps: float = 30.0
    animation_seconds: float = 5.0
    samples_per_frame: int = 16
    output: str = "out.png"
    animation_dir: str = "animation"
    checkpoint: Optional[str] = None   # resume path
    denoise: bool = False
    display_mode: str = "default"      # default/denoise/depth/albedo/normal
    # Input record/replay
    read_input: Optional[str] = None
    write_input: Optional[str] = None
    # Multi-device: a (tile, spp) mesh of torch.distributed ranks
    mesh_tile: Optional[int] = None
    mesh_spp: int = 1
    # A torch.profiler trace of the run is written here
    profile_dir: Optional[str] = None
    # Progressive preview: re-export the output PNG after every pass
    preview: bool = False
    # Integrator: ray-regeneration persistent wavefront (fast path) vs
    # the batched loop (the same estimator)
    persistent: bool = True
    # Next-event estimation: direct light sampling with MIS, passed to
    # the scene's constructor (``nee=``), the one way to ask for it
    nee: bool = False
    # Russian roulette start depth (None: off, as the reference)
    rr_depth: Optional[int] = None
    # Lane coherence sorting for the persistent integrator (origin and
    # direction cells, Morton-ordered).  None = auto
    # (Scene.prefers_sorted_rays, on the card only); True/False forces.
    # Permutes lanes only: the estimator and every draw are unchanged.
    sort_rays: Optional[bool] = None
    # Live viewer: a local HTTP page with display-mode keys, PNG export
    # and quick-pass abort
    serve: bool = False
    host: str = "127.0.0.1"
    port: int = 7860
    # Interactive play mode (with serve): browser WASD/space keys feed a
    # per-frame InputCollection into the scene's generate
    play: bool = False

    @property
    def aspect_ratio(self):
        return self.width / self.height

    @property
    def total_frames(self):
        return max(1, int(self.fps * self.animation_seconds))

    @classmethod
    def from_json(cls, path):
        with open(path) as f:
            return cls(**json.load(f))

    def to_json(self, path):
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2)
