from .mesh import make_mesh, replicate, shard_params
from .sharded_train import batched_train_step
