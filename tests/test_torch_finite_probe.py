"""scripts/converge_torch.py's per-step finiteness probe (`--finite-probe`)
on the CPU, port only: a tiny field and scene, finite steps passing through
it untouched, and a NaN put into one parameter stopping the step before its
update, with the dump that replays it and the report of its replays."""

import importlib.util
import json
import math
import random
from pathlib import Path

import numpy as np
import pytest
import torch

from lidar4d_tpu_torch import interop
from lidar4d_tpu_torch.data import kitti360 as tkitti
from lidar4d_tpu_torch.data import synthetic as tsynth
from lidar4d_tpu_torch.models import lidar4d as tl
from lidar4d_tpu_torch.train import flow_cache as tfc
from lidar4d_tpu_torch.train import losses as tlosses
from lidar4d_tpu_torch.train import train_step as tts
from torch_threads import limit_under_xdist

limit_under_xdist()

ROOT = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("converge_torch",
                                               ROOT / "scripts" / "converge_torch.py")
ct = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ct)

H, W, FRAMES, SEQ = 16, 64, 6, "9000"
FOV = (2.0, 26.9)
RAYS, COARSE, FINE, ITERS = 32, 8, 16, 100
TINY = dict(
    base_resolution=8, max_resolution=32, log2_hashmap_size=8, n_levels_hash=2,
    n_features_per_level_hash=8, hash_size_dynamic=(8, 7, 7), n_levels_plane=2,
    min_resolution=8, time_resolution=4, num_frames=FRAMES, flow_n_levels=2,
    flow_n_features=8, flow_log2_hashmap_size=8, flow_base_resolution=8,
    flow_max_resolution=16, plane_hash_scales=1, plane_hash_log2=7,
)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("scene"))
    scale, offset = tsynth.generate_synthetic_sequence(root, sequence_id=SEQ, num_frames=FRAMES,
                                                       H=H, W=W, val_every=3)
    dk = dict(root_path=root, sequence_id=SEQ, scale=scale, offset=offset)
    ds = tkitti.KITTI360Dataset(split="train", **dk)
    random.seed(0)
    cache = tfc.build_flow_cache(tkitti.KITTI360Dataset(split="refine", **dk), scale, FRAMES)
    field = tl.LiDAR4DField(tl.LiDAR4DConfig(**TINY, near_lidar=1.0 * scale,
                                             far_lidar=81.0 * scale), device="cpu")
    return dict(ds=ds, cache=tts.flow_cache_to_device(cache, "cpu"), field=field, scale=scale)


def _step(setup):
    state, opt = tts.init_train_state(setup["field"], lr=1e-2, iters=ITERS)
    loss_cfg = tlosses.LossConfig(scale=setup["scale"], num_frames=FRAMES, iters=ITERS,
                                  urf_loss=True)
    step = tts.make_train_step(setup["field"], opt, loss_cfg, H=H, W=W, fov_lidar=FOV,
                               num_rays=RAYS, num_coarse=COARSE, num_fine=FINE, seed=1)
    return state, step


@pytest.fixture
def one_thread():
    """The plain versions' CPU scatter-adds sum in a thread-dependent order;
    on one thread two runs of a step are bitwise equal."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_finite_steps_pass_through(setup, tmp_path, one_thread):
    """Under the probe, finite steps give the same losses and parameters as
    without it, and write nothing."""
    runs = []
    for probed in (False, True):
        state, step = _step(setup)
        probe = ct.finite_probe(tmp_path, ["--config", "x"])
        with probe if probed else ct.contextlib.nullcontext():
            losses = [float(step(state, setup["ds"].frame(i), setup["cache"])[1]["loss"])
                      for i in range(2)]
        runs.append((losses, interop.tree_to_numpy(state.params)))
    assert runs[0][0] == runs[1][0] and all(map(math.isfinite, runs[0][0]))
    for a, b in zip(interop.tree_leaves(runs[0][1]), interop.tree_leaves(runs[1][1])):
        np.testing.assert_array_equal(a, b)
    assert not list(tmp_path.iterdir())


def test_nan_stops_the_step_and_dumps_it(setup, tmp_path):
    """A NaN in one density-head weight: the step raises NonFiniteStep
    before its update; the dump holds the pre-step parameters, the draws,
    the frame and its index, the step count and the step's shape, and
    rebuilds the same non-finite step; the report names the loss and every
    leaf the NaN reaches and the first operator that made one, in the
    port's density head, on the device and on the CPU."""
    state, step = _step(setup)
    frame = setup["ds"].frame(2)
    state, _ = step(state, setup["ds"].frame(1), setup["cache"])    # one finite step
    with torch.no_grad():
        state.params["sigma"][0][3, 1] = float("nan")
    before = interop.tree_to_numpy(state.params)
    mu0 = [m.clone() for m in state.opt_state.mu]
    with ct.finite_probe(tmp_path, ["--config", "x"]):
        with pytest.raises(ct.NonFiniteStep, match="step 1"):
            step(state, frame, setup["cache"])
    # no update: the parameters, the Adam state and the step count stay
    assert state.step == 1 and state.opt_state.count == 1
    for a, b in zip(interop.tree_leaves(before), interop.tree_leaves(
            interop.tree_to_numpy(state.params))):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(mu0, state.opt_state.mu):
        assert torch.equal(a, b)

    dump = torch.load(tmp_path / ct.DUMP, weights_only=False)
    assert dump["step"] == 1 and dump["cli_argv"] == ["--config", "x"]
    assert dump["frame_idx"] == ct.frame_index(frame["time"], FRAMES)
    assert dump["key"] == {"H": H, "W": W, "fov_lidar": list(FOV), "num_rays": RAYS,
                           "num_steps": 768, "patch_size": [1, 1], "num_coarse": COARSE,
                           "num_fine": FINE}
    assert "unet" not in dump["params"]
    for k in ("sigma", "hash", "planes", "flow"):
        for a, b in zip(interop.tree_leaves(interop.tree_to_numpy(dump["params"][k])),
                        interop.tree_leaves(before[k])):
            np.testing.assert_array_equal(a, b)
    adam = torch.load(tmp_path / ct.DUMP_ADAM, weights_only=False)
    assert adam["count"] == 1 and all(torch.equal(a, b) for a, b in zip(adam["mu"], mu0))
    assert sorted(dump["draws"]) == ["inds", "t_rand", "u_jitter", "z_jitter"]

    # the dump replays the same step, on the flow cache's frames it kept:
    # the same metrics and non-finite names
    cache = ct.cache_whole(dump["cache"])
    idx = dump["frame_idx"]
    kept = sorted({min(max(idx + s, 0), FRAMES - 1) for s in (0, 1, -1, 2, -2)})
    assert dump["cache"]["frames"] == kept
    for k, v in setup["cache"].items():
        assert torch.equal(cache[k][kept], v[kept]) and cache[k].shape == v.shape, k
    params = {**dump["params"], "unet": state.params["unet"]}
    again = ct.replay_step(step, params, dump["frame"], cache, dump["draws"], dump["step"])

    report = json.loads((tmp_path / ct.REPORT).read_text())
    assert report["step"] == 1 and "loss" in report["nonfinite"]
    assert "sigma.0" in report["nonfinite"] and "urf_loss" in report["nonfinite"]
    assert sorted(report["replays"]) == ["cpu", "device"]
    assert again["metrics"].keys() == report["metrics"].keys()
    for k, v in report["metrics"].items():
        assert again["metrics"][k] == v or (math.isnan(v) and math.isnan(again["metrics"][k])), k
    for replay in (*report["replays"].values(), again):
        assert replay["nonfinite"] == report["nonfinite"]
        first = replay["first_nonfinite_op"]
        assert first["where"].startswith("lidar4d_tpu_torch/"), first
        assert first["nan"] > 0
        assert replay["anatomy"]["weights_nonfinite"] > 0
        assert math.isnan(replay["anatomy"]["head_input_max"])
