"""Multi-scene training (opensplat_tpu_torch.parallel.multi_scene and
multi_scene_cli) on the CPU.

The port's scene step is train_step_impl on each scene in turn, so the
multi-scene paths are held to independent runs exactly: one
multi_scene_train_step of two scenes against two train_step_impl calls
(tensors equal); MultiSceneTrainer with two scenes of unequal capacity
(aligned to the larger) and camera counts against two Trainers over 9
steps through an alpha reset and a densify (losses equal, alive masks and
parameters equal on the shared rows; the padded rows dead); the
sharded MultiSceneTrainer, one scene on each of 2 gloo ranks, against
the one-process trainer (losses and scenes equal); multi_scene_cli on
two tiny projects in one process and with --sharded on 2 ranks (the
written PLYs byte-equal). 64x64 px (the CLI: 32 px), a few hundred
Gaussians; ranks have one torch thread and a time limit."""
import sys

import numpy as np
import torch

from opensplat_tpu_torch import multi_scene_cli
from opensplat_tpu_torch.config import TrainConfig
from opensplat_tpu_torch.data.dataset import Camera
from opensplat_tpu_torch.models.gaussians import (PARAM_NAMES, init_model,
                                                  state_map)
from opensplat_tpu_torch.parallel.launch import run_ranks
from opensplat_tpu_torch.parallel.multi_scene import (MultiSceneTrainer,
                                                      multi_scene_train_step,
                                                      stack_states,
                                                      unstack_states)
from opensplat_tpu_torch.tools.make_synthetic_project import make_project
from opensplat_tpu_torch.train import Trainer, train_step_impl
from test_torch_parallel import F, H, LR, RANK_ENV, W, _look_at, run_function

# one intra-op thread per process, ranks included (RANK_ENV)
torch.set_num_threads(1)


def _states_equal(a, b):
    """Alive masks equal on b's rows (a's further rows dead), and every
    alive row's parameters, Adam moments and stats equal. Dead rows may
    differ: an alpha reset writes the dead rows a padded capacity already
    has, while capacity grown later starts at zero."""
    rows = b.alive.shape[0]
    assert torch.equal(a.alive[:rows], b.alive)
    assert not a.alive[rows:].any()
    live = b.alive
    for k in PARAM_NAMES:
        assert torch.equal(getattr(a.params, k)[:rows][live],
                           getattr(b.params, k)[live]), k
        assert torch.equal(a.opt.mu[k][:rows][live], b.opt.mu[k][live]), k
        assert torch.equal(a.opt.nu[k][:rows][live], b.opt.nu[k][live]), k
    for k in ("xys_grad_norm", "vis_counts", "max_2d_size"):
        assert torch.equal(getattr(a.stats, k)[:rows][live],
                           getattr(b.stats, k)[live]), k


def _scene_state(seed, n, cap, cap_round=64):
    rng = np.random.default_rng(100 + seed)
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    rgb = rng.integers(0, 255, (n, 3)).astype(np.uint8)
    return init_model(pts, rgb, 1, capacity=cap, capacity_round=cap_round,
                      seed=seed, device="cpu")


def test_multi_scene_step_matches_independent_steps():
    states = [_scene_state(i, 200, 256) for i in range(2)]
    copies = [state_map(lambda x: x.clone(), s) for s in states]
    rng = np.random.default_rng(1)
    c2w = np.stack([_look_at((0.3 * i, 0.4, 4.0)) for i in range(2)])
    gts = rng.uniform(0, 1, (2, H, W, 3)).astype(np.float32)
    new, m = multi_scene_train_step(
        stack_states(states), torch.from_numpy(c2w), [F] * 2, [F] * 2,
        [W / 2] * 2, [H / 2] * 2, torch.from_numpy(gts), LR, H, W, 1,
        TrainConfig(), True)
    assert m["loss"].shape == (2,)
    for i, got in enumerate(unstack_states(new, 2)):
        ref, mi = train_step_impl(copies[i], torch.from_numpy(c2w[i]), F, F,
                                  W / 2, H / 2, torch.from_numpy(gts[i]), LR,
                                  H, W, 1, TrainConfig(), True)
        assert float(m["loss"][i]) == float(mi["loss"])
        assert int(m["n_isects"][i]) == int(mi["n_isects"])
        _states_equal(got, ref)
        assert got.opt.count == ref.opt.count == 1


def _cams(seed, n):
    rng = np.random.default_rng(seed)
    cams = []
    for i in range(n):
        a = 2 * np.pi * i / n
        cam = Camera(width=W, height=H, fx=F, fy=F, cx=W / 2, cy=H / 2,
                     cam_to_world=_look_at((4 * np.sin(a), 0.4,
                                            4 * np.cos(a))),
                     file_path=f"s{seed}_c{i}.png")
        cam.set_image(rng.uniform(0, 1, (H, W, 3)).astype(np.float32))
        cams.append(cam)
    return cams


# refine every 4 past warm-up 2, reset interval 12: step 4 resets alpha,
# step 8 densifies the 3-camera scene (8 > 3 + 4) and not the 5-camera
# one (8 <= 5 + 4): the reset-interval guard sees each scene's count
MS_CFG = TrainConfig(num_iters=200, refine_every=4, warmup_length=2,
                     reset_alpha_every=3, num_downscales=0, sh_degree=1,
                     capacity_round=64)


def test_multi_scene_trainer_matches_trainers_unequal_capacities():
    (st_a, st_b) = _scene_state(1, 60, 64), _scene_state(2, 150, 192)
    cams_a, cams_b = _cams(1, 3), _cams(2, 5)
    copies = [state_map(lambda x: x.clone(), s) for s in (st_a, st_b)]
    msc = MultiSceneTrainer([st_a, st_b], [cams_a, cams_b], MS_CFG,
                            device="cpu")
    assert msc.state.alive.shape == (2, 192)  # aligned to the larger
    refs = [Trainer(s, c, MS_CFG, device="cpu")
            for s, c in zip(copies, (cams_a, cams_b))]
    refined = {}
    for step in range(1, 10):
        out = msc.run_step(step)
        want = [r.run_step(step).loss for r in refs]
        assert out.metrics["loss_per_scene"].tolist() == want
        if msc.refine_metrics is not None:
            refined[step] = msc.refine_metrics
            assert msc.refine_metrics == [r.refine_metrics for r in refs]
            msc.refine_metrics = None
            for r in refs:
                r.refine_metrics = None
    assert sorted(refined) == [4, 8]
    # step 8 densifies the 3-camera scene only
    assert "n_splits" in refined[8][0] and refined[8][1] is None
    for got, ref in zip(msc.scene_states(), refs):
        _states_equal(got, ref.state)


def _sharded_rank(out, steps):
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    sys_path = __import__("sys").path
    sys_path.insert(0, out)
    from opensplat_tpu_torch.parallel.distributed import initialize_from_env
    from opensplat_tpu_torch.parallel.mesh import make_mesh
    from opensplat_tpu_torch.parallel.multi_scene import MultiSceneTrainer
    from ms_scenes import scenes

    initialize_from_env(device="cpu")
    mesh = make_mesh(2, 1)
    cfg, states, cams = scenes()
    r = mesh.index["data"]
    tr = MultiSceneTrainer(states[r:r + 1], cams[r:r + 1], cfg, mesh=mesh,
                           device="cpu")
    losses = [tr.run_step(s).metrics["loss_per_scene"].numpy()
              for s in range(1, steps + 1)]
    arrs = {}
    for i, st in enumerate(tr.scene_states()):
        arrs.update({f"{i}_{k}": v.numpy() for k, v in
                     st.params.as_dict().items()})
        arrs[f"{i}_alive"] = st.alive.numpy()
    np.savez(f"{out}/rank{dist.get_rank()}.npz", losses=np.stack(losses),
             **arrs)


_SCENES_SRC = '''
import numpy as np
from opensplat_tpu_torch.config import TrainConfig
from opensplat_tpu_torch.data.dataset import Camera
from opensplat_tpu_torch.models.gaussians import init_model


def scenes():
    cfg = TrainConfig(num_iters=200, refine_every=4, warmup_length=2,
                      reset_alpha_every=3, num_downscales=0, sh_degree=1,
                      capacity_round=64)
    states, cams = [], []
    for s in range(2):
        rng = np.random.default_rng(s)
        pts = rng.uniform(-1, 1, (100, 3)).astype(np.float32)
        rgb = rng.integers(0, 255, (100, 3)).astype(np.uint8)
        states.append(init_model(pts, rgb, 1, capacity=128 + 64 * s,
                                 capacity_round=64, seed=s, device="cpu"))
        cs = []
        for i in range(4):
            c2w = np.eye(4, dtype=np.float32)
            c2w[:3, 3] = [0.2 * i, 0.1 * s, 4.0]
            cam = Camera(width=64, height=64, fx=57.6, fy=57.6, cx=32.0,
                         cy=32.0, cam_to_world=c2w)
            cam.set_image(rng.uniform(0, 1, (64, 64, 3)).astype(np.float32))
            cs.append(cam)
        cams.append(cs)
    return cfg, states, cams
'''


def test_sharded_multi_scene_two_ranks_matches_one_process(tmp_path):
    """One scene on each of 2 ranks (capacities 128 and 192, aligned over
    the ranks) for 5 steps through the step-4 refine, against one
    process training both: per-scene losses and the gathered scenes
    equal."""
    (tmp_path / "ms_scenes.py").write_text(_SCENES_SRC)
    steps = 5
    run_function(_sharded_rank, 2, str(tmp_path), steps, env=RANK_ENV,
                 timeout=120)
    r0, r1 = (np.load(tmp_path / f"rank{r}.npz") for r in (0, 1))
    for k in r0.files:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    sys.path.insert(0, str(tmp_path))
    try:
        from ms_scenes import scenes
    finally:
        sys.path.remove(str(tmp_path))
    cfg, states, cams = scenes()
    tr = MultiSceneTrainer(states, cams, cfg, device="cpu")
    for s in range(1, steps + 1):
        np.testing.assert_array_equal(
            r0["losses"][s - 1], tr.run_step(s).metrics["loss_per_scene"])
    for i, st in enumerate(tr.scene_states()):
        np.testing.assert_array_equal(r0[f"{i}_alive"], st.alive.numpy())
        for k in PARAM_NAMES:
            np.testing.assert_array_equal(r0[f"{i}_{k}"],
                                          getattr(st.params, k).numpy())


def test_multi_scene_cli_two_projects(tmp_path, capsys):
    """multi_scene_cli on two projects: in this process, and with
    --sharded over 2 ranks (one project each, rank 0 writing both
    PLYs); the files are equal byte for byte."""
    projects = []
    for s in range(2):
        p = str(tmp_path / f"proj{s}")
        make_project(p, cams=4, points=200, res=32, seed=s, device="cpu",
                     verbose=False)
        projects.append(p)
    flags = ["-n", "4", "--cpu", "--sh-degree", "1"]
    assert multi_scene_cli.main(projects + ["-o", str(tmp_path / "one")]
                                + flags) == 0
    out = capsys.readouterr().out
    assert "Step 4: mean loss" in out
    outs = run_ranks([sys.executable, "-m", "opensplat_tpu_torch."
                      "multi_scene_cli", *projects, "-o",
                      str(tmp_path / "two"), "--sharded", *flags], 2,
                     env=RANK_ENV, timeout=120)
    assert "Sharded: 2 scenes over 2 ranks" in outs[0]
    assert "Wrote" in outs[0] and "Wrote" not in outs[1]
    for s in range(2):
        one = (tmp_path / "one" / f"proj{s}.ply").read_bytes()
        assert one == (tmp_path / "two" / f"proj{s}.ply").read_bytes()
