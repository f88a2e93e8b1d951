"""The port's tracer (opensplat_tpu_torch.utils.metrics: span, count,
host_sync, tracing) on the CPU: off, a span is the shared no-op and
records nothing while counters count; on, spans nest by thread. A tiny
Trainer step and a 2-scene MultiSceneTrainer step each record the
step's span tree once a call, and the camera-DP and Gaussian-shard
trainers the same host loop and step spans; the host syncs are counted
by site (every step the same sites) on a CUDA device alone, so the
CPU's are counted here as if they were a card's; the GT cache's hits and misses
match the cameras' get_image calls; the projection's rows and the rows
behind its clip plane are counted, the latter in the stream total's
read, as are the binning's candidates and rows with a candidate, beside
the views and rows it bins. 32 x 32 px, 64 Gaussians a scene."""
import threading
from collections import Counter

import numpy as np
import pytest
import torch

from opensplat_tpu_torch.config import TrainConfig
from opensplat_tpu_torch.models.gaussians import init_model
from opensplat_tpu_torch.parallel.dp_trainer import DPTrainer
from opensplat_tpu_torch.parallel.gaussian_shard import GSTrainer
from opensplat_tpu_torch.parallel.multi_scene import MultiSceneTrainer
from opensplat_tpu_torch.train import Trainer
from opensplat_tpu_torch.utils import metrics

# one intra-op thread per process: the suite runs one pytest-xdist
# worker per core
torch.set_num_threads(1)

H = W = 32
CFG = TrainConfig(num_downscales=0, sh_degree=1, capacity_round=64)

# the span tree of one run_step: (name, parent name), each once a step
# (_want adds the spans a view and a GT miss)
TREE = [
    ("trainer.run_step", None),
    ("trainer.gt", "trainer.run_step"),
    ("sync.pose", "trainer.gt"),
    ("step", "trainer.run_step"),
    ("sync.background", "step"),
    ("step.render", "step"),
    ("render.project", "step.render"),
    ("render.sh", "step.render"),
    ("render.bin", "step.render"),
    ("sync.stream_total", "render.bin"),
    ("render.raster", "step.render"),
    ("step.loss", "step"),
    ("loss.ssim", "step.loss"),
    ("step.backward", "step"),
    ("step.adam", "step"),
    ("step.stats", "step"),
]


class _Cam:
    """A camera whose get_image counts its calls."""

    def __init__(self, i, n, rng, calls):
        a = 2 * np.pi * i / n
        eye = np.array([4 * np.sin(a), 0.4, 4 * np.cos(a)])
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross(fwd, [0, 1, 0])
        right /= np.linalg.norm(right)
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, 0], c2w[:3, 1] = right, np.cross(right, fwd)
        c2w[:3, 2], c2w[:3, 3] = -fwd, eye
        self.cam_to_world = c2w
        self.width, self.height = W, H
        self.fx = self.fy = 0.9 * W
        self.cx, self.cy = W / 2, H / 2
        self._image = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
        self._calls = calls

    def get_image(self, factor=1):
        self._calls[0] += 1
        return self._image


def _scene(seed, n_cams, calls):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, (60, 3)).astype(np.float32)
    rgb = rng.integers(0, 255, (60, 3)).astype(np.uint8)
    state = init_model(pts, rgb, 1, capacity=64, capacity_round=64,
                       seed=seed, device="cpu")
    return state, [_Cam(i, n_cams, rng, calls) for i in range(n_cams)]


def _trainer(cls, *args):
    """A trainer over `args` on the CPU."""
    return cls(*args, CFG, device="cpu")


def _count_cpu(monkeypatch):
    """Count the CPU's host syncs as a CUDA device's."""
    monkeypatch.setattr(metrics, "_waits", lambda device: True)


def _step(trainer, step):
    """One run_step traced: (its spans, the counters it added)."""
    before = metrics.counts()
    metrics.take_spans()
    with metrics.tracing():
        trainer.run_step(step)
    after = metrics.counts()
    return metrics.take_spans(), {k: v - before.get(k, 0)
                                  for k, v in after.items()
                                  if v != before.get(k, 0)}


def _want(views, misses):
    """TREE with loss.ssim once a view and sync.gt_upload once a GT
    cache miss."""
    want = Counter(dict.fromkeys(TREE, 1))
    want[("loss.ssim", "step.loss")] = views
    want[("sync.camera", "render.project")] = 3 * views
    want[("sync.view_cols", "render.project")] = 6
    if misses:
        want[("sync.gt_upload", "trainer.gt")] = misses
    return want


def _tree(spans):
    """Counter of (name, parent's name), all on the calling thread."""
    by_id = {s.id: s for s in spans}
    assert {s.thread for s in spans} == {threading.get_ident()}
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    return Counter((s.name, by_id[s.parent].name if s.parent is not None
                    else None) for s in spans)


def _syncs(views):
    """host_syncs by site of one step of `views` scenes with the
    GT cached: the pose upload, the background, six of each view's
    camera matrices (three uploads, three numbers written into the
    projection matrix), six per-view columns of the projection and the
    stream total."""
    return {"pose": 1, "background": 1, "camera": 6 * views,
            "view_cols": 6, "stream_total": 1}


def _by_site(added):
    sites = {k.split(".", 1)[1]: v for k, v in added.items()
             if k.startswith("host_syncs.")}
    assert added["host_syncs"] == sum(sites.values())
    return sites


def test_tracing_off_records_nothing_counters_count():
    metrics.take_spans()
    a, b = metrics.span("x"), metrics.span("y")
    assert a is b  # the shared no-op
    before = metrics.counts()
    with a, metrics.host_sync("t_off", "cuda:0", 2):
        metrics.count("t.off", 2)
    with metrics.host_sync("t_off", torch.device("cpu")):
        pass  # nothing waits on the CPU: not counted
    assert metrics.take_spans() == []
    after = metrics.counts()
    assert after["t.off"] == before.get("t.off", 0) + 2
    assert after["host_syncs.t_off"] == before.get("host_syncs.t_off", 0) + 2


def test_tracing_switch_and_nesting_by_thread():
    metrics.take_spans()
    t = metrics.tracing()  # a call switches it on
    try:
        with metrics.tracing(False):  # a context restores on exit
            with metrics.span("off"):
                pass
        got = {}

        def other():
            with metrics.span("t.root"):
                with metrics.span("t.leaf"):
                    pass
            got["thread"] = threading.get_ident()

        with metrics.span("main.root"):
            with metrics.span("main.leaf"):
                th = threading.Thread(target=other)
                th.start()
                th.join(timeout=10)
            assert not th.is_alive()
    finally:
        metrics.tracing(t.was_on)
    spans = {s.name: s for s in metrics.take_spans()}
    assert set(spans) == {"main.root", "main.leaf", "t.root", "t.leaf"}
    assert spans["main.leaf"].parent == spans["main.root"].id
    assert spans["t.leaf"].parent == spans["t.root"].id
    # the other thread's root has no parent, though main.leaf was open
    assert spans["t.root"].parent is None
    assert spans["t.root"].thread == got["thread"] != spans["main.root"].thread


def test_trainer_step_tree_syncs_and_gt_counts(monkeypatch):
    _count_cpu(monkeypatch)
    calls = [0]
    state, cams = _scene(0, 3, calls)
    tr = _trainer(Trainer, state, cams)
    before = metrics.counts()
    spans, added = _step(tr, 11)  # a first draw: the GT misses
    assert _tree(spans) == _want(1, 1)
    assert _by_site(added) == dict(_syncs(1), gt_upload=1)
    assert added["trainer.steps"] == added["trainer.scene_steps"] == 1
    spans, added = _step(tr, 20)  # a 10th step: a plain step's syncs
    assert _tree(spans) == _want(1, 1)
    assert _by_site(added) == dict(_syncs(1), gt_upload=1)
    monkeypatch.undo()  # the CPU's own: no host sync is counted
    mid = metrics.counts()
    for step in (21, 22, 23):  # the epoch's last draw, then hits
        tr.run_step(step)
    after = metrics.counts()
    assert all(after[k] == mid.get(k, 0) for k in after
               if k.startswith("host_syncs"))
    gained = {k: after.get(k, 0) - before.get(k, 0)
              for k in ("gt.hits", "gt.misses", "gt.upload_bytes")}
    assert gained["gt.misses"] == calls[0] == 3
    assert gained["gt.hits"] == 5 - calls[0]
    assert gained["gt.upload_bytes"] == 3 * H * W * 3 * 4


def test_multi_scene_step_tree_and_syncs(monkeypatch):
    _count_cpu(monkeypatch)
    calls = [0]
    scenes = [_scene(s, 2, calls) for s in (1, 2)]
    tr = _trainer(MultiSceneTrainer, [s for s, _ in scenes],
                  [c for _, c in scenes])
    spans, added = _step(tr, 11)
    assert _tree(spans) == _want(2, 2)
    assert _by_site(added) == dict(_syncs(2), gt_upload=2)
    assert added["trainer.steps"] == 1 and added["trainer.scene_steps"] == 2
    assert added["gt.misses"] == calls[0] == 2
    spans, added = _step(tr, 30)  # a 10th step: a plain step's syncs
    assert _tree(spans) == _want(2, 2)
    assert _by_site(added) == dict(_syncs(2), gt_upload=2)
    assert added["gt.misses"] == 2 and "gt.hits" not in added
    spans, added = _step(tr, 31)  # a new epoch: both scenes hit
    assert _tree(spans) == _want(2, 0)
    assert _by_site(added) == _syncs(2)
    assert added["gt.hits"] == 2 and calls[0] == 4


@pytest.mark.parametrize("make", [
    lambda state, cams: DPTrainer(state, cams, CFG, d_local=2,
                                  device="cpu"),
    lambda state, cams: GSTrainer(state, cams, CFG, n_model=1,
                                  device="cpu"),
], ids=["dp_1x1_d2", "gs_1x1"])
def test_parallel_trainers_step_spans(make):
    """The camera-DP and Gaussian-shard trainers (1 x 1 meshes, no
    process group) run Trainer's host loop and the shared step: each
    step span once under trainer.run_step, inside the step's."""
    state, cams = _scene(3, 4, [0])
    spans, added = _step(make(state, cams), 11)
    tree = _tree(spans)
    for pair in TREE[:4]:
        assert tree[pair] == 1, pair
    for name in ("step.render", "step.loss", "step.backward", "step.adam",
                 "step.stats"):
        assert tree[(name, "step")] == 1, name
    by_name = {s.name: s for s in spans}
    outer = by_name["step"]
    assert all(outer.end_ns - outer.start_ns
               > by_name[n].end_ns - by_name[n].start_ns
               for n in ("step.render", "step.backward", "step.adam"))
    assert added["trainer.steps"] == added["trainer.scene_steps"] == 1


def test_sh_runs_in_its_own_span(monkeypatch):
    """The render's SH colours run inside render.sh, under step.render,
    and outside render.project."""
    from opensplat_tpu_torch.models import splat_model

    open_at_call = []

    def seen(*args):
        open_at_call.append([s.name for s in metrics._open.stack])
        return real(*args)

    real = splat_model.render_colours
    monkeypatch.setattr(splat_model, "render_colours", seen)
    state, cams = _scene(4, 2, [0])
    _step(_trainer(Trainer, state, cams), 11)
    assert open_at_call == [["trainer.run_step", "step", "step.render",
                             "render.sh"]]


# camera depths of a hand-built scene's rows (identity pose: depth is
# minus world z): behind the clip plane (depth <= 0.01) 4 behind the
# camera, 3 in its plane, 2 in the slab in front, 1 on the plane itself;
# the rest in front
DEPTHS = [-2.0, -1.0, -0.5, -0.01, 0.0, 0.0, 0.0, 0.005, 0.009, 0.01,
          0.011, 0.02]
BEHIND = sum(d <= 0.01 for d in DEPTHS)


def _depth_scene(seed, calls):
    """_scene's 60 points moved 3-6 in front of an identity camera, and
    rows 0-11 at DEPTHS; one camera."""
    state, cams = _scene(seed, 1, calls)
    rng = np.random.default_rng(seed)
    means = state.params.means
    means[:, 2] = torch.from_numpy(rng.uniform(-6, -3, 64).astype(np.float32))
    means[:len(DEPTHS), 2] = -torch.tensor(DEPTHS)
    cams[0].cam_to_world = np.eye(4, dtype=np.float32)
    return state, cams


def test_projection_counts_rows_and_rows_behind_the_clip_plane(monkeypatch):
    # the one-view step, then two scenes in one batched step (V = 2):
    # every row of every view projected, the rows behind the plane of
    # each view summed; the read that takes them is the stream total's,
    # as are the binning's candidates (the stream total) and rows with a
    # candidate tile, summed on the device; the views and rows binned are
    # counted from shapes. So a step makes the same host syncs by site as
    # before the counts
    from opensplat_tpu_torch.ops.kernels import integration

    _count_cpu(monkeypatch)
    seen = {}

    def bin_seen(proj, *args):
        out = real_bin(proj, *args)
        seen["hit"], seen["total"] = proj.num_tiles_hit.clone(), out.n_cands
        return out

    real_bin = integration.bin_gaussians
    monkeypatch.setattr(integration, "bin_gaussians", bin_seen)
    calls = [0]
    one = _trainer(Trainer, *_depth_scene(0, calls))
    scenes = [_depth_scene(s, calls) for s in (1, 2)]
    two = _trainer(MultiSceneTrainer, [s for s, _ in scenes],
                   [c for _, c in scenes])
    for tr, views in ((one, 1), (two, 2)):
        _, added = _step(tr, 11)
        assert added["project.rows"] == views * 64
        assert added["project.clipped"] == views * BEHIND
        assert _by_site(added) == dict(_syncs(views), gt_upload=views)
        hit = seen["hit"]
        assert hit.numel() == views * 64 and added["bin.views"] == views
        assert added["bin.candidates"] == seen["total"] == int(
            hit.long().sum())
        assert 0 < added["bin.rows_hit"] == int((hit > 0).sum()) < views * 64
        assert added["bin.rows"] == views * 64
