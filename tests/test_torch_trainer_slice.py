"""The port's trainer against the JAX package's trainer on the CPU: the slice
as a whole, part 1 (part 2, two trainer epochs, is
tests/test_torch_trainer_epochs.py).

`evaluate` of both trainers on the tracked checkpoint
`workspace/smoke/checkpoints/lidar4d_ep0020_refine` (trained on
configs/synthetic_smoke.txt), carried into the port by `_jax_checkpoint`
(orbax restores the raw tree; `interop.params_from_jax` takes it), on the
scene that config regenerates from seed 0. The port evaluates in a process
of its own that loads no JAX (`PORT_EVAL`), as a user's process does. Both
run with float32 MLPs and the JAX `plane_linear` swapped for an explicit
float32 lerp (as in tests/test_torch_train.py), so that the two frameworks
compute the same float32 function.

Tolerances, and why: the renders agree to float32 rounding: `RENDER_ATOL`
of each map's range (1e-3; measured ray-drop 2.6e-6, depth 8.3e-7,
intensity 7.2e-5: a sample's attributes count only where its weight
exceeds 1e-4, and rounding moves some weights across); the refined
ray-drop probability to the U-Net's float32 rounding: `PROB_ATOL` (5e-4;
measured 6.2e-5). The mask `raydrop > 0.5` could still differ at a pixel
within that of 0.5: the test requires every mask difference to lie within
`PROB_ATOL` of 0.5 and widens the masked meters' tolerances by the share of
such pixels (none on this checkpoint: no pixel within 1e-4 of 0.5, so
accuracy and F1 are compared exactly). valid_loss, RMSE / MedAE / LPIPS /
SSIM / PSNR and CD to `METER_RTOL` (1e-4 relative; measured <= 8.5e-6), the
F-score to 2e-3 (two points in a thousand) plus twice the flipped share.
"""

import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lidar4d_tpu.models.flow_field as jflow_mod
import lidar4d_tpu.models.lidar4d as jlidar_mod
import lidar4d_tpu.models.planes_field as jplanes_mod
from lidar4d_tpu.cli import config as jconfig
from lidar4d_tpu.data import kitti360 as jkitti
from lidar4d_tpu.eval import meters as jmeters
from lidar4d_tpu.ops import mlp as jmlp
from lidar4d_tpu.train import trainer as jtrainer_mod
from lidar4d_tpu_torch import interop
from lidar4d_tpu_torch.cli import config as tconfig
from lidar4d_tpu_torch.data import kitti360 as tkitti
from lidar4d_tpu_torch.data.synthetic import generate_synthetic_sequence
from lidar4d_tpu_torch.models import flow_field as tflow_mod
from lidar4d_tpu_torch.models import lidar4d as tlidar_mod
from lidar4d_tpu_torch.ops import mlp as tmlp
from torch_threads import limit_under_xdist

limit_under_xdist()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "workspace", "smoke", "checkpoints", "lidar4d_ep0020_refine")
SMOKE = os.path.join(ROOT, "configs", "synthetic_smoke.txt")
RENDER_ATOL = 1e-3
PROB_ATOL = 5e-4
METER_RTOL = 1e-4


def _f32_plane_linear(grid, x, coord_grad_lead=0):
    """Explicit float32 lerp with the reference plane_linear's contract."""
    lead = min(coord_grad_lead, grid.shape[0])
    x = jnp.concatenate([jax.lax.stop_gradient(x[:lead]), x[lead:]], axis=0)
    w = grid.shape[2]
    u = jnp.clip(x, 0.0, 1.0) * (w - 1)
    j0 = jnp.clip(jnp.floor(u).astype(jnp.int32), 0, w - 1)
    j1 = jnp.minimum(j0 + 1, w - 1)
    f = (u - j0.astype(jnp.float32))[..., None]
    g0 = jnp.take_along_axis(grid, j0[:, None, :], axis=2).transpose(0, 2, 1)
    g1 = jnp.take_along_axis(grid, j1[:, None, :], axis=2).transpose(0, 2, 1)
    return (1.0 - f) * g0 + f * g1


@pytest.fixture
def f32(monkeypatch):
    """Both packages' MLPs in float32 and the JAX plane_linear a float32
    lerp; the JAX caches cleared after."""
    monkeypatch.setattr(jplanes_mod, "plane_linear", _f32_plane_linear)
    j32 = functools.partial(jmlp.apply_mlp, dtype=jnp.float32)
    monkeypatch.setattr(jlidar_mod, "apply_mlp", j32)
    monkeypatch.setattr(jflow_mod, "apply_mlp", j32)
    t32 = functools.partial(tmlp.apply_mlp, dtype=torch.float32)
    monkeypatch.setattr(tlidar_mod, "apply_mlp", t32)
    monkeypatch.setattr(tflow_mod, "apply_mlp", t32)
    yield
    jax.clear_caches()


def _jax_checkpoint(path):
    """The raw tree of a JAX package checkpoint (orbax, no template): nested
    dicts and lists of numpy arrays, for `interop.params_from_jax`."""
    import orbax.checkpoint as ocp

    with ocp.PyTreeCheckpointer() as ck:
        return ck.restore(os.path.abspath(path))


def _options(argv):
    """(JAX options, port options), near / far scaled as the CLIs scale them."""
    jopt = jconfig.get_arg_parser().parse_args(argv + ["--num_devices", "1"])
    topt = tconfig.get_arg_parser().parse_args(argv + ["--device", "cpu"])
    for opt in (jopt, topt):
        opt.near_lidar *= opt.scale
        opt.far_lidar *= opt.scale
    return jopt, topt


def _record_frames(trainer, out):
    """Keep each evaluated frame's render and refined ray-drop."""
    render, refine = trainer._render_frame, trainer._apply_refine

    def rec_render(*a):
        r = render(*a)
        out.append({"render": [np.asarray(x) for x in r]})
        return r

    def rec_refine(*a):
        r = refine(*a)
        out[-1]["refined"] = np.asarray(r)
        return r

    trainer._render_frame, trainer._apply_refine = rec_render, rec_refine


def _last_eval(trainer):
    with open(trainer.metrics_path) as f:
        return [r for r in map(json.loads, f) if "valid_loss" in r][-1]


# The port's side of the comparison, run in a process of its own that loads
# no JAX, as a user's process does; the frames compared are the first that
# process renders (tests/test_torch_first_render.py holds that first render
# on its own).
PORT_EVAL = r"""
import functools, json, sys
import numpy as np, torch
from lidar4d_tpu_torch.cli import config
from lidar4d_tpu_torch.data.kitti360 import KITTI360Dataset
from lidar4d_tpu_torch.eval import meters
from lidar4d_tpu_torch.models import flow_field, lidar4d
from lidar4d_tpu_torch.ops import mlp
from lidar4d_tpu_torch.train.trainer import Trainer

spec = json.load(open(sys.argv[1]))
lidar4d.apply_mlp = flow_field.apply_mlp = functools.partial(mlp.apply_mlp,
                                                             dtype=torch.float32)
opt = config.get_arg_parser().parse_args(spec["argv"] + ["--device", "cpu"])
opt.near_lidar *= opt.scale
opt.far_lidar *= opt.scale
field = lidar4d.LiDAR4DField(config.build_model_config(opt), device="cpu")
lidar_metrics = [meters.RaydropMeter(ratio=opt.raydrop_ratio),
                 meters.IntensityMeter(scale=opt.intensity_scale),
                 meters.DepthMeter(scale=opt.scale),
                 meters.PointsMeter(scale=opt.scale, intrinsics=opt.fov_lidar)]
trainer = Trainer("lidar4d", opt, field, config.build_loss_config(opt), workspace=spec["ws"],
                  lidar_metrics=lidar_metrics, eval_interval=opt.eval_interval, seed=opt.seed,
                  use_checkpoint="scratch")
trainer.state.params = torch.load(spec["params"])
trainer.epoch, trainer._refine_trained = spec["epoch"], True
dataset = KITTI360Dataset(split="val", root_path=opt.path, sequence_id=opt.sequence_id,
                          scale=opt.scale, offset=opt.offset)
frames = {"render": [], "refined": []}
render, refine = trainer._render_frame, trainer._apply_refine
trainer._render_frame = lambda *a: frames["render"].append(render(*a)) or frames["render"][-1]
trainer._apply_refine = lambda *a: frames["refined"].append(refine(*a)) or frames["refined"][-1]
trainer.evaluate(dataset)
np.savez(spec["out"], render=np.stack([np.stack(r) for r in frames["render"]]),
         refined=np.stack(frames["refined"]))
"""


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-30)))


# ------------------------------------------------ 1. evaluate on the fixture
def test_evaluate_on_tracked_checkpoint_matches_jax(tmp_path, f32):
    root = str(tmp_path / "scene")
    argv = ["--config", SMOKE, "--path", root]
    jopt, topt = _options(argv)
    scale, _ = generate_synthetic_sequence(root, sequence_id=jopt.sequence_id,
                                           num_frames=jopt.num_frames, H=jopt.synthetic_H,
                                           W=jopt.synthetic_W, seed=jopt.synthetic_seed)
    assert scale == pytest.approx(jopt.scale, rel=1e-6)      # the CLI's own check
    kw = dict(split="val", root_path=root, sequence_id=jopt.sequence_id, scale=jopt.scale,
              offset=jopt.offset)
    jds, tds = jkitti.KITTI360Dataset(**kw), tkitti.KITTI360Dataset(**kw)

    def meters(pkg, **dev):
        return [pkg.RaydropMeter(ratio=jopt.raydrop_ratio),
                pkg.IntensityMeter(scale=jopt.intensity_scale, **dev),
                pkg.DepthMeter(scale=jopt.scale, **dev),
                pkg.PointsMeter(scale=jopt.scale, intrinsics=jopt.fov_lidar, **dev)]

    # the port's evaluation runs in its process while the JAX trainer evaluates
    raw = _jax_checkpoint(FIXTURE)
    tfield = tlidar_mod.LiDAR4DField(tconfig.build_model_config(topt), device="cpu")
    spec = {"argv": argv, "ws": str(tmp_path / "tws"), "epoch": int(raw["epoch"]),
            "params": str(tmp_path / "params.pt"), "out": str(tmp_path / "frames.npz")}
    torch.save(interop.params_from_jax(tfield, raw["params"]), spec["params"])
    with open(tmp_path / "spec.json", "w") as f:
        json.dump(spec, f)
    port = subprocess.Popen([sys.executable, "-c", PORT_EVAL, str(tmp_path / "spec.json")],
                            cwd=ROOT)
    try:
        jfield = jlidar_mod.LiDAR4DField(jconfig.build_model_config(jopt))
        # the initial parameters, which the checkpoint replaces, in one compile
        object.__setattr__(jfield, "init", jax.jit(jfield.init))   # a frozen dataclass
        jt = jtrainer_mod.Trainer("lidar4d", jopt, jfield, jconfig.build_loss_config(jopt),
                                  workspace=str(tmp_path / "jws"),
                                  lidar_metrics=meters(jmeters), use_checkpoint=FIXTURE)
        assert jt.epoch == 20 and jt._refine_trained
        j_frames = []
        _record_frames(jt, j_frames)
        jt.evaluate(jds)
        assert jt.use_refine and len(j_frames) == 2
        assert port.wait(timeout=600) == 0
    finally:
        port.kill()
    out = np.load(spec["out"])
    t_frames = [{"render": list(r), "refined": p} for r, p in zip(out["render"], out["refined"])]
    assert len(t_frames) == len(tds) == 2
    with open(os.path.join(spec["ws"], "metrics_lidar4d.jsonl")) as f:
        got = [r for r in map(json.loads, f) if "valid_loss" in r][-1]

    flips = 0
    for jf, tf in zip(j_frames, t_frames):
        for a, b in zip(tf["render"], jf["render"]):
            assert np.abs(a - b).max() <= RENDER_ATOL * max(np.ptp(b), 1e-6)
        assert np.abs(tf["refined"] - jf["refined"]).max() <= PROB_ATOL
        differ = (tf["refined"] > 0.5) != (jf["refined"] > 0.5)
        assert (np.abs(jf["refined"][differ] - 0.5) <= PROB_ATOL).all()
        flips += int(differ.sum())
    share = flips / sum(f["refined"].size for f in j_frames)

    want = _last_eval(jt)
    assert sorted(got) == sorted(want)
    assert got["epoch"] == want["epoch"] == 20
    assert got["depth_lpips_calibrated"] is want["depth_lpips_calibrated"] is False
    assert _rel(got["valid_loss"], want["valid_loss"]) <= METER_RTOL + share
    rd_got, rd_want = got["RaydropMeter"], want["RaydropMeter"]
    assert _rel(rd_got[0], rd_want[0]) <= METER_RTOL
    assert abs(rd_got[1] - rd_want[1]) <= share
    assert abs(rd_got[2] - rd_want[2]) <= 2 * share
    for tag in ("intensity", "depth"):
        assert _rel(got[tag], want[tag]) <= METER_RTOL + share, tag
    assert _rel(got["PointsMeter"][0], want["PointsMeter"][0]) <= METER_RTOL + share
    assert abs(got["PointsMeter"][1] - want["PointsMeter"][1]) <= 2e-3 + 2 * share
    assert np.isfinite(got["PointsMeter"]).all()


