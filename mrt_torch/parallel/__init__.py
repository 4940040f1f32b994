from .mesh import init_distributed, make_mesh, render_mesh  # noqa: F401
from .render import (gather_film, render_pass_sharded,  # noqa: F401
                     render_pass_sharded_persistent, render_sharded,
                     shard_film)
