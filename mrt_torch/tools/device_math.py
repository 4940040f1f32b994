"""The card's float32 arithmetic against the CPU's (ROADMAP C20, C22).

    python -m mrt_torch.tools.device_math

On 2^20 float32 inputs in [0, 2 pi): how many results of each function
differ between the card and the CPU, a division by a host number
(``x / 3.0``) beside ``math.vec.div``; then RTIOW's wavefront pass
(``render_sample``) at 256x144, depth 8, samples 0 and 1 on both: the
pixels with another bounce count and with another radiance.  Prints one
JSON line.  Needs a CUDA device.
"""

from __future__ import annotations

import json
import math

import numpy as np
import torch

from ..integrator import wavefront
from ..math import vec
from ..scenes import get

FUNCTIONS = {
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "exp(-x)": lambda x: torch.exp(-x), "log": torch.log,
    "x ** (1 / 2.2)": lambda x: x ** (1 / 2.2), "torch.sqrt": torch.sqrt,
    "vec.sqrt": vec.sqrt, "x / 3.0": lambda x: x / 3.0,
    "vec.div(x, 3.0)": lambda x: vec.div(x, 3.0),
}


def main(width=256, height=144, depth=8):
    dev = torch.device("cuda", 0)
    rs = np.random.default_rng(0)
    x = torch.from_numpy((rs.random(1 << 20) * 2 * math.pi)
                         .astype(np.float32))
    differ = {name: int((fn(x) != fn(x.to(dev)).cpu()).sum())
              for name, fn in FUNCTIONS.items()}
    films = {}
    for where in ("cpu", dev):
        scene, camera = get("rtiow")().generate(device=where)
        films[str(where)] = [
            [t.cpu() for t in wavefront.render_sample(
                scene, camera, width, height, 1, s, max_depth=depth)]
            for s in (0, 1)]
    passes = []
    for (r0, b0), (r1, b1) in zip(films["cpu"], films[str(dev)]):
        passes.append(dict(depth_px=int((b0 != b1).sum()),
                           radiance_px=int((r0 != r1).any(-1).sum()),
                           max_abs=(r0 - r1).abs().max().item()))
    print(json.dumps(dict(card=torch.cuda.get_device_name(0),
                          inputs=x.numel(), differ=differ,
                          render=dict(size=[width, height], depth=depth,
                                      pixels=width * height,
                                      samples=passes))))


if __name__ == "__main__":
    main()
