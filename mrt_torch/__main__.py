"""CLI: ``python -m mrt_torch --scene cornell --spp 64 -o cornell.png``.

The flags and defaults of ``python -m mrt``, plus ``--device`` (the
counterpart of JAX_PLATFORMS; default: the CUDA card, raising without
one; ``--device cpu`` renders on the CPU).  ``--mesh-tile`` and
``--mesh-spp`` shard the frame over a (tile, spp) mesh of
``torch.distributed`` ranks; their product must be the world size (one
process, or the ranks a launcher starts:
``torchrun --nproc-per-node 4 -m mrt_torch --mesh-tile 2 --mesh-spp 2``,
rank r on card r, rank 0 writing the PNG).  One flag differs from
mrt's: ``--profile-dir`` writes a ``torch.profiler`` trace.
"""

from __future__ import annotations

import argparse

from . import scenes
from .runtime.config import RenderConfig
from .runtime.driver import run


def build_parser():
    p = argparse.ArgumentParser(
        prog="mrt_torch",
        description="differentiable path tracer, PyTorch/CUDA port")
    p.add_argument("--scene", default="rtiow", choices=scenes.names())
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--spp", type=int, default=64)
    p.add_argument("--max-depth", type=int, default=50)
    p.add_argument("--samples-per-pass", type=int, default=8)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("-o", "--output", default="out.png")
    p.add_argument("--display-mode", default="default",
                   choices=["default", "denoise", "depth", "albedo",
                            "normal"])
    p.add_argument("--denoise", action="store_true")
    p.add_argument("--checkpoint", default=None,
                   help="progressive checkpoint path (resume if exists)")
    p.add_argument("--animate", action="store_true")
    p.add_argument("--fps", type=float, default=30.0)
    p.add_argument("--seconds", type=float, default=5.0,
                   dest="animation_seconds")
    p.add_argument("--samples-per-frame", type=int, default=16)
    p.add_argument("--animation-dir", default="animation")
    p.add_argument("--read-input", default=None)
    p.add_argument("--write-input", default=None)
    p.add_argument("--mesh-tile", type=int, default=None,
                   help="tile-axis size for multi-device rendering "
                        "(torch.distributed ranks)")
    p.add_argument("--mesh-spp", type=int, default=1)
    p.add_argument("--rr-depth", type=int, default=None,
                   help="Russian roulette start bounce (default off)")
    p.add_argument("--nee", action="store_true",
                   help="next-event estimation (direct light sampling), "
                        "asked of the scene's constructor (nee=True)")
    p.add_argument("--sort-rays", dest="sort_rays", default=None,
                   action="store_true",
                   help="force lane coherence sorting (default: auto — "
                        "on the card for large instanced and sphere-BVH "
                        "scenes)")
    p.add_argument("--no-sort-rays", dest="sort_rays",
                   action="store_false")
    p.add_argument("--batched", dest="persistent", action="store_false",
                   help="use the batched integrator instead of the "
                        "persistent ray-regeneration one")
    p.add_argument("--preview", action="store_true",
                   help="rewrite the output PNG after every pass")
    p.add_argument("--serve", action="store_true",
                   help="live progressive viewer (HTTP) with runtime "
                        "display-mode keys, export, quick-pass")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--play", action="store_true",
                   help="with --serve: interactive game loop — browser "
                        "WASD/space drive the scene's InputCollection "
                        "each frame; --write-input records the session")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace here")
    p.add_argument("--config", default=None,
                   help="JSON config file (flags override)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' "
                        "renders on the CPU)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    fields = {k: v for k, v in vars(args).items()
              if k not in ("config", "device")}
    if args.config:
        config = RenderConfig.from_json(args.config)
        defaults = vars(build_parser().parse_args([]))
        for k, v in fields.items():
            if v != defaults.get(k):
                setattr(config, k, v)
    else:
        config = RenderConfig(**fields)
    return run(config, device=args.device)


if __name__ == "__main__":
    main()
