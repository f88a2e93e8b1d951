"""opensplat_tpu_torch's scene files and checkpoints against the JAX
package on the CPU: for the same parameters (a JAX state carried across
with state_from_numpy) the .ply, keep-CRS .ply, .splat and debug .ply
are byte-identical; load_ply of a JAX file gives the JAX load_ply's
state; each package reads the other's checkpoint exactly; a PLY without
its step is rejected."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensplat_tpu import io as jio
from opensplat_tpu.models.gaussians import init_model as jinit
from opensplat_tpu_torch import io as tio
from opensplat_tpu_torch.models.gaussians import PARAM_NAMES, state_from_numpy

# one intra-op thread per process: the suite runs one pytest-xdist
# worker per core, and a full torch thread pool in each of them
# oversubscribes the cores
torch.set_num_threads(1)

N, CAP = 33, 64
SCALE, TRANSLATION = 0.25, np.array([1.0, -2.0, 3.0], np.float32)
STATS = ("xys_grad_norm", "vis_counts", "max_2d_size", "initialized")


@pytest.fixture
def states():
    """A JAX state with every leaf perturbed and a few dead rows among
    the alive ones, and the same state in the port."""
    rng = np.random.default_rng(7)
    pts = rng.standard_normal((N, 3)).astype(np.float32)
    rgb = rng.integers(0, 255, (N, 3)).astype(np.uint8)
    js = jinit(pts, rgb, sh_degree=2, capacity=CAP, seed=1)

    def perturb(tree, s):
        return jax.tree.map(
            lambda x: x + s * jnp.asarray(
                rng.standard_normal(x.shape).astype(np.float32)), tree)

    alive = np.asarray(js.alive).copy()
    alive[[2, 9, 30]] = False
    js = js.replace(
        params=perturb(js.params, 0.3), alive=jnp.asarray(alive),
        opt=js.opt.replace(mu=perturb(js.opt.mu, 1.0),
                           nu=jax.tree.map(jnp.abs, perturb(js.opt.nu, 1.0)),
                           count=js.opt.count + 7),
        stats=js.stats.replace(
            xys_grad_norm=js.stats.xys_grad_norm + 0.5,
            vis_counts=js.stats.vis_counts + 3.0,
            initialized=jnp.asarray(True)))
    return js, state_from_numpy(_to_numpy(js), device="cpu")


def _to_numpy(js):
    return {
        "params": {k: np.asarray(getattr(js.params, k)) for k in PARAM_NAMES},
        "alive": np.asarray(js.alive),
        "mu": {k: np.asarray(getattr(js.opt.mu, k)) for k in PARAM_NAMES},
        "nu": {k: np.asarray(getattr(js.opt.nu, k)) for k in PARAM_NAMES},
        "count": int(js.opt.count),
        "stats": {k: np.asarray(getattr(js.stats, k)) for k in STATS},
    }


def _port_numpy(ts):
    return {
        "params": {k: v.numpy() for k, v in ts.params.as_dict().items()},
        "alive": ts.alive.numpy(),
        "mu": {k: v.numpy() for k, v in ts.opt.mu.items()},
        "nu": {k: v.numpy() for k, v in ts.opt.nu.items()},
        "count": int(ts.opt.count),
        "stats": {k: getattr(ts.stats, k).numpy() for k in STATS},
    }


def _assert_same_state(a, b):
    """a, b: _to_numpy / _port_numpy dicts; equal leaf for leaf."""
    assert a["count"] == b["count"]
    np.testing.assert_array_equal(a["alive"], b["alive"])
    for group in ("params", "mu", "nu", "stats"):
        for k in a[group]:
            x, y = np.asarray(a[group][k]), np.asarray(b[group][k])
            assert x.dtype == y.dtype, (group, k)
            np.testing.assert_array_equal(x, y, err_msg=f"{group} {k}")


WRITERS = {
    "ply": lambda io, p, f: io.save_scene(p.params, p.alive, f + ".ply", 1234),
    "ply_keep_crs": lambda io, p, f: io.save_ply(
        p.params, p.alive, f + ".ply", 5, keep_crs=True, scale=SCALE,
        translation=TRANSLATION),
    "splat": lambda io, p, f: io.save_scene(p.params, p.alive, f + ".splat",
                                            1),
    "splat_keep_crs": lambda io, p, f: io.save_splat(
        p.params, p.alive, f + ".splat", keep_crs=True, scale=SCALE,
        translation=TRANSLATION),
    "debug_ply": lambda io, p, f: io.save_debug_ply(
        p.params, p.alive, f + ".ply", 3, keep_crs=True, scale=SCALE,
        translation=TRANSLATION),
}


@pytest.mark.parametrize("kind", list(WRITERS))
def test_writers_byte_identical(kind, states, tmp_path):
    js, ts = states
    WRITERS[kind](tio, ts, str(tmp_path / "t"))
    WRITERS[kind](jio, js, str(tmp_path / "j"))
    ext = ".splat" if "splat" in kind else ".ply"
    t_bytes = (tmp_path / f"t{ext}").read_bytes()
    assert t_bytes == (tmp_path / f"j{ext}").read_bytes()
    assert len(t_bytes) >= (N - 3) * 15  # the alive rows are in it


@pytest.mark.parametrize("keep_crs", [False, True])
def test_load_ply_of_a_jax_file(keep_crs, states, tmp_path):
    js, _ = states
    p = str(tmp_path / "scene.ply")
    crs = dict(keep_crs=keep_crs, scale=SCALE, translation=TRANSLATION)
    jio.save_ply(js.params, js.alive, p, 777, **crs)
    ts, t_step = tio.load_ply(p, capacity=48, device="cpu", **crs)
    jst, j_step = jio.load_ply(p, capacity=48, **crs)
    assert t_step == j_step == 777
    # fresh moments and stats on both sides, like the reference
    _assert_same_state(_port_numpy(ts), _to_numpy(jst))
    assert int(ts.alive.sum()) == N - 3


def test_checkpoints_cross_read(states, tmp_path):
    js, ts = states
    t_path, j_path = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    tio.save_checkpoint(ts, 999, t_path, sampler_draws=123, seed=5)
    jio.save_checkpoint(js, 999, j_path, sampler_draws=123)
    for path in (t_path, j_path):
        jst, j_step, j_draws = jio.load_checkpoint(path)
        tst, t_step, t_draws = tio.load_checkpoint(path, device="cpu")
        assert j_step == t_step == 999 and j_draws == t_draws == 123
        _assert_same_state(_port_numpy(tst), _to_numpy(js))
        _assert_same_state(_to_numpy(jst), _to_numpy(js))
    # the port's `key` is the raw PRNGKey(seed)
    jst, _, _ = jio.load_checkpoint(t_path)
    np.testing.assert_array_equal(np.asarray(jst.key),
                                  np.asarray(jax.random.PRNGKey(5)))


@pytest.mark.parametrize("comment,match", [
    (b"comment Generated by opensplat", "iteration count"),
    (b"comment made elsewhere", "Invalid PLY"),
])
def test_load_ply_rejects_a_file_without_its_step(comment, match, tmp_path):
    p = str(tmp_path / "bad.ply")
    with open(p, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n" + comment + b"\n")
        f.write(b"element vertex 0\nend_header\n")
    with pytest.raises(RuntimeError, match=match):
        tio.load_ply(p, device="cpu")


def test_oracle_matches_jax(states):
    """The port's numpy oracle: the forward rasterizer equals the JAX
    package's (image and final T), and oracle_render_scene of the same
    scene gives the same image."""
    from opensplat_tpu.oracle import np_oracle as jor
    from opensplat_tpu.oracle import scene_check as jsc
    from opensplat_tpu_torch.oracle import np_oracle as tor
    from opensplat_tpu_torch.oracle import scene_check as tsc

    js, ts = states
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = (0.2, -0.1, 6.0)
    args = (ts.params, ts.alive, c2w, 40.0, 40.0, 16.0, 12.0, 24, 32, 2,
            np.array([0.1, 0.2, 0.3], np.float32))
    img = tsc.oracle_render_scene(*args)
    assert np.ptp(img) > 0.1  # Gaussians in view, not only background
    np.testing.assert_array_equal(
        img, jsc.oracle_render_scene(js.params, js.alive, *args[2:]))

    rng = np.random.default_rng(4)
    n, h, w = 30, 20, 24
    xys = rng.uniform(0, 24, (n, 2)).astype(np.float32)
    cov = rng.uniform(1, 6, (n, 3)).astype(np.float32) * [1, 0.1, 1]
    det = cov[:, 0] * cov[:, 2] - cov[:, 1] ** 2
    conics = np.stack([cov[:, 2], -cov[:, 1], cov[:, 0]], 1) / det[:, None]
    fwd = (w, h, xys, conics, rng.uniform(0, 1, (n, 3)),
           rng.uniform(0.2, 0.95, n), np.array([0.3, 0.2, 0.1]), cov,
           rng.uniform(1, 5, n))
    j_img, j_t, j_px = jor.np_rasterize_forward(*fwd)
    t_img, t_t = tor.np_rasterize_forward(*fwd)
    assert sum(map(len, j_px)) > 0  # Gaussians composited
    np.testing.assert_array_equal(t_img, j_img)
    np.testing.assert_array_equal(t_t, j_t)
