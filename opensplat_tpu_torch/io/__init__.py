"""Scene files (.ply, .splat, debug .ply) and training checkpoints."""
from .scene_io import (  # noqa: F401
    load_checkpoint,
    load_ply,
    save_checkpoint,
    save_debug_ply,
    save_ply,
    save_scene,
    save_splat,
)
