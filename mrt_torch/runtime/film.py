"""Progressive accumulation film, tonemapping and display modes (mirrors
``mrt.runtime.film``).

The film is ``(sum, depth_sum, samples)``; merging is addition.  Saving
those three and reloading resumes a progressive render exactly.  The
AOV guides ``albedo`` and ``normal`` (the pre-pass of
``integrator/aov.py``) ride along, None until set; a checkpoint keeps
them, as mrt's does.  They feed the ALBEDO and NORMAL display modes and
the denoiser of the DENOISE mode.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np
import torch

from ..core.device import resolve
from ..math import vec


class DisplayMode(enum.Enum):
    DEFAULT = "default"
    DENOISE = "denoise"
    DEPTH = "depth"
    ALBEDO = "albedo"
    NORMAL = "normal"


@dataclasses.dataclass
class Film:
    sum: torch.Tensor        # (H, W, 3) float32 accumulated radiance
    depth_sum: torch.Tensor  # (H, W) int32 accumulated bounce counts
    samples: int             # samples per pixel accumulated so far
    albedo: Optional[torch.Tensor] = None  # (H, W, 3) AOV guide
    normal: Optional[torch.Tensor] = None  # (H, W, 3) AOV guide

    @classmethod
    def create(cls, width, height, device=None):
        """An empty film on `device` (None: the CUDA card)."""
        device = resolve(device)
        return cls(
            sum=torch.zeros((height, width, 3), device=device),
            depth_sum=torch.zeros((height, width), dtype=torch.int32,
                                  device=device),
            samples=0,
        )

    @property
    def width(self):
        return self.sum.shape[1]

    @property
    def height(self):
        return self.sum.shape[0]

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)

    def merge(self, radiance, bounces):
        """Accumulate one 1-spp pass."""
        return self.replace(sum=self.sum + radiance,
                            depth_sum=self.depth_sum + bounces,
                            samples=self.samples + 1)

    def with_aov(self, albedo, normal):
        return self.replace(albedo=albedo, normal=normal)

    def clear(self):
        """No samples; the guides stay."""
        return self.replace(sum=torch.zeros_like(self.sum),
                            depth_sum=torch.zeros_like(self.depth_sum),
                            samples=0)

    def mean(self):
        return vec.div(self.sum, max(self.samples, 1))

    def to_float_rgb(self, mode: DisplayMode = DisplayMode.DEFAULT,
                     denoiser=None):
        """Per-pixel float RGB in [0, 1]; rows run bottom-up.  DENOISE
        passes DEFAULT's image and the guides to `denoiser` (without one
        it is DEFAULT); ALBEDO and NORMAL are zeros without their guide."""
        if mode in (DisplayMode.DEFAULT, DisplayMode.DENOISE):
            out = torch.clamp(self.mean() ** (1.0 / 2.2), 0.0, 1.0)
            if self.samples == 0:
                out = torch.zeros_like(out)
            if mode is DisplayMode.DENOISE and denoiser is not None:
                out = denoiser(out, self.albedo, self.normal)
            return out
        if mode is DisplayMode.DEPTH:
            # Mean depth normalised by its image maximum.
            max_depth = torch.clamp(torch.max(self.depth_sum), min=1)
            depth = torch.clamp(self.depth_sum / max_depth, 0.0, 1.0)
            if self.samples == 0:
                depth = torch.zeros_like(depth)
            return depth[..., None].expand(*depth.shape, 3)
        if mode is DisplayMode.ALBEDO:
            if self.albedo is None:
                return torch.zeros_like(self.sum)
            return torch.clamp(self.albedo, 0.0, 1.0) ** (1.0 / 2.2)
        if mode is DisplayMode.NORMAL:
            if self.normal is None:
                return torch.zeros_like(self.sum)
            return (self.normal + 1.0) / 2.0
        raise ValueError(f"unknown display mode {mode}")

    def to_rgb_bytes(self, mode: DisplayMode = DisplayMode.DEFAULT,
                     denoiser=None):
        """uint8 RGB, rows bottom-up, truncating like ``(p * 255) as u8``."""
        floats = self.to_float_rgb(mode, denoiser=denoiser).cpu().numpy()
        return (floats * 255.0).astype(np.uint8)

    def save_state(self, path, seed=0):
        """Checkpoint the accumulator so a render can resume.  The archive
        has mrt's layout; a guide that is None is saved empty."""
        guide = lambda x: np.zeros(0) if x is None else x.cpu().numpy()
        np.savez(path, sum=self.sum.cpu().numpy(),
                 depth_sum=self.depth_sum.cpu().numpy(),
                 samples=np.asarray(self.samples, np.int32),
                 seed=np.asarray(seed, np.uint32),
                 albedo=guide(self.albedo), normal=guide(self.normal))

    @classmethod
    def load_state(cls, path, device=None):
        """Returns (film, seed), the film on `device` (None: the CUDA
        card); an empty guide loads as None."""
        device = resolve(device)
        z = np.load(path)
        guide = lambda x: (torch.as_tensor(x, device=device) if x.size
                           else None)
        film = cls(sum=torch.as_tensor(z["sum"], device=device),
                   depth_sum=torch.as_tensor(z["depth_sum"], device=device),
                   samples=int(z["samples"]), albedo=guide(z["albedo"]),
                   normal=guide(z["normal"]))
        return film, int(z["seed"])
