"""A Gaussian in the clip slab (camera depth |z| < clip_thresh, 0.01) is
culled, and the projection evaluates its terms at depth 1: after a
training step every leaf and both Adam moments stay finite, its own
gradient is exactly 0, and every other row comes out bitwise as with
that row moved to depth -1, where it is culled at its own depth. Before
that, a row at depth 0 overflowed the 2D covariance (a * c in float32),
its conic turned NaN, and 0 x NaN gradients put NaN into Adam. The one-
view Trainer step and the batched step of two scenes
(MultiSceneTrainer), on the kernels' plain versions, 48 x 48 px."""
import numpy as np
import pytest
import torch

from opensplat_tpu_torch.config import TrainConfig
from opensplat_tpu_torch.models.gaussians import PARAM_NAMES, init_model
from opensplat_tpu_torch.parallel.multi_scene import MultiSceneTrainer
from opensplat_tpu_torch.train import Trainer

# one intra-op thread per process: the suite runs one pytest-xdist
# worker per core
torch.set_num_threads(1)

H = W = 48
N = 256  # a multiple of 64: the CPU's vector tails fall alike
ROW = 7
CFG = TrainConfig(num_downscales=0, sh_degree=1, capacity_round=64)


class _Cam:
    """The identity pose (OpenGL axes, looking down world -z), moved
    along x by `dx`: camera depth is minus world z, exactly."""

    def __init__(self, dx, image):
        self.cam_to_world = np.eye(4, dtype=np.float32)
        self.cam_to_world[0, 3] = dx
        self.width, self.height = W, H
        self.fx = self.fy = 40.0
        self.cx, self.cy = W / 2, H / 2
        self._image = image

    def get_image(self, factor=1):
        return self._image


def _scene(seed, depth):
    """N Gaussians in front of the camera (depths 3-6) and row ROW at
    camera depth `depth`, beside the axis, with the scales e^(1.5, 1,
    0.5); one camera."""
    rng = np.random.default_rng(seed)
    pts = np.concatenate([rng.uniform(-1, 1, (N, 2)),
                          rng.uniform(-6, -3, (N, 1))], -1)
    state = init_model(pts.astype(np.float32),
                       rng.integers(0, 255, (N, 3)).astype(np.uint8),
                       CFG.sh_degree, capacity=N, seed=seed, device="cpu")
    # placed after init_model's Morton order and nearest-neighbour scales
    state.params.means[ROW] = torch.tensor([0.4, -0.3, -depth])
    state.params.scales[ROW] = torch.tensor([1.5, 1.0, 0.5])
    image = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    return state, [_Cam(0.05 * seed, image)]


def _step(scenes, depth):
    """Each leaf and Adam moment after one step, and each leaf's row ROW
    before it, with a leading scene axis."""
    made = [_scene(s, depth) for s in range(scenes)]
    if scenes == 1:
        tr = Trainer(made[0][0], made[0][1], CFG, device="cpu")
    else:
        tr = MultiSceneTrainer([m[0] for m in made], [m[1] for m in made],
                               CFG, device="cpu")
    row = {k: torch.stack([m[0].params.as_dict()[k][ROW] for m in made])
           for k in PARAM_NAMES}
    tr.run_step(11)
    st = tr.state
    out = {f"row.{k}": v for k, v in row.items()}
    for k in PARAM_NAMES:
        for what, t in (("param", st.params.as_dict()[k]),
                        ("mu", st.opt.mu[k]), ("nu", st.opt.nu[k])):
            out[f"{what}.{k}"] = t if scenes > 1 else t[None]
    return out


_MOVED = {}


def _moved(scenes):
    """The step with the row at depth -1, once a path."""
    if scenes not in _MOVED:
        _MOVED[scenes] = _step(scenes, -1.0)
    return _MOVED[scenes]


@pytest.mark.parametrize("depth", [0.0, 0.005, -0.005])
@pytest.mark.parametrize("scenes", [1, 2], ids=["one_view", "batched2"])
def test_row_in_the_clip_slab_is_finite_and_gets_no_gradient(scenes, depth):
    got, want = _step(scenes, depth), _moved(scenes)
    rest = torch.ones(N, dtype=torch.bool)
    rest[ROW] = False
    for k in PARAM_NAMES:
        for what in ("param", "mu", "nu"):
            t = got[f"{what}.{k}"]
            assert torch.isfinite(t).all(), (what, k)
            assert torch.equal(t[:, rest], want[f"{what}.{k}"][:, rest]), \
                (what, k)
        # no gradient: both moments stay 0 and the row where it was
        assert not got[f"mu.{k}"][:, ROW].any(), k
        assert not got[f"nu.{k}"][:, ROW].any(), k
        assert torch.equal(got[f"param.{k}"][:, ROW], got[f"row.{k}"]), k
