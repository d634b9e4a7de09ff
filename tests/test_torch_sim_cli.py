"""The port's simulation CLI (`lidar4d_tpu_torch.cli.main_lidar4d_sim`)
against the JAX package's on the CPU.

The JAX simulation CLI cannot build a field: its `build_model_config` reads
`remat_density`, `density_chunk`, `plane_hash_scales` and `plane_hash_log2`
(`lidar4d_tpu/cli/config.py:213-240`), which `get_sim_arg_parser`
(`lidar4d_tpu/cli/main_lidar4d_sim.py:26-83`) does not define. One test
shows that fault; the comparison patches the four flags into the JAX
parser at the train parser's defaults (the JAX file is not edited), and
give its `init_train_state` a template of the parameters' shapes instead of
an eager init, since the checkpoint supplies every value.

Both CLIs render the tracked checkpoint
`workspace/smoke/checkpoints/lidar4d_ep0020_refine` (copied first, so
nothing is written into the tracked workspace; carried into a port
checkpoint file by `interop.params_from_jax`) along an 8-frame version of
configs/synthetic_smoke.txt's scene at 16x64, shifted and motion-aligned,
32 samples a ray (the config's 96 would only cost time), with the U-Net
refine, each package's MLPs in float32 and the JAX
plane_linear an explicit float32 lerp (as tests/test_torch_trainer_slice.py
does), so that both compute the same float32 function. Each frame's
`points/lidar4d_XXXX.npy` must hold as many points as the JAX one, each
coordinate and intensity within `POINT_ATOL` (measured 2.9e-5 m over the 8
frames, 2.5e-5 at 96 samples; points reach ~80 m, where a float32 step is
7.6e-6). A pixel whose
ray-drop mask differs between the packages would change the point count:
`FLIP_SHARE` bounds such pixels (measured: none).
"""

import functools
import os
import shutil
import warnings
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lidar4d_tpu.cli.main_lidar4d_sim as jsim
import lidar4d_tpu.models.flow_field as jflow_mod
import lidar4d_tpu.models.lidar4d as jlidar_mod
import lidar4d_tpu.models.planes_field as jplanes_mod
import lidar4d_tpu.utils.compile_cache as jcompile_cache
import lidar4d_tpu_torch.cli.main_lidar4d_sim as tsim
import lidar4d_tpu_torch.models.flow_field as tflow_mod
import lidar4d_tpu_torch.models.lidar4d as tlidar_mod
from lidar4d_tpu.cli import config as jconfig
from lidar4d_tpu.data import synthetic as jsynth
from lidar4d_tpu.ops import mlp as jmlp
from lidar4d_tpu_torch import interop
from lidar4d_tpu_torch.cli import config as tconfig
from lidar4d_tpu_torch.data import synthetic as tsynth
from lidar4d_tpu_torch.ops import mlp as tmlp
from lidar4d_tpu_torch.sim.simulator import Simulator, build_novel_rays, shift_trajectory
from test_torch_trainer_slice import _f32_plane_linear, _jax_checkpoint
from torch_threads import limit_under_xdist

limit_under_xdist()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "workspace", "smoke", "checkpoints", "lidar4d_ep0020_refine")
SMOKE = os.path.join(ROOT, "configs", "synthetic_smoke.txt")
FRAMES = 8
SIM = ["--H_lidar", "16", "--W_lidar", "64", "--shift_y", "0.5", "--align_axis"]
MISSING = ("remat_density", "density_chunk", "plane_hash_scales", "plane_hash_log2")
POINT_ATOL = 2.5e-4
FLIP_SHARE = 1e-3
_JAX_SIM_PARSER = jsim.get_sim_arg_parser


def _jax_sim_parser_repaired():
    """The JAX simulation parser with the four flags its build_model_config
    reads, as the JAX train parser defines them."""
    p = _JAX_SIM_PARSER()
    train = {a.dest: a for a in jconfig.get_arg_parser()._actions}
    for dest in MISSING:
        p.add_argument(*train[dest].option_strings, type=train[dest].type,
                       default=train[dest].default)
    return p


def _params_template(field, key):
    """`init_train_state` as the JAX simulation CLI uses it: the parameter
    tree it restores the checkpoint into, here by shape only (every value
    comes from the checkpoint; the eager init would take ~30 s)."""
    return SimpleNamespace(params=jax.eval_shape(field.init, key)), None


def _points(ws):
    d = os.path.join(ws, "points")
    return [np.load(os.path.join(d, n)) for n in sorted(os.listdir(d))]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's renders here on one intra-op thread: the renders are many
    small ops, and beside other busy test processes a thread pool's
    barriers cost far more than the work (each test took minutes instead of
    seconds in a loaded 6-worker run). Restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def sim_run(tmp_path_factory):
    """The scene, the JAX CLI's render of the copied smoke checkpoint, and
    the same checkpoint as a port checkpoint file in a workspace of its own."""
    tmp = tmp_path_factory.mktemp("sim")
    scene = str(tmp / "scene")
    kw = dict(sequence_id="9000", num_frames=FRAMES, H=32, W=256, seed=0)
    assert tsynth.generate_synthetic_sequence(scene, **kw) == \
        jsynth.generate_synthetic_sequence(str(tmp / "jscene"), **kw)
    argv = ["--config", SMOKE, "--path", scene, "--num_steps", "32", *SIM]

    jws = str(tmp / "jws")
    shutil.copytree(FIXTURE, os.path.join(jws, "checkpoints", os.path.basename(FIXTURE)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsim, "get_sim_arg_parser", _jax_sim_parser_repaired)
        mp.setattr(jcompile_cache, "enable_compilation_cache", lambda *a, **k: None)
        mp.setattr(jsim, "init_train_state", _params_template)
        mp.setattr(jplanes_mod, "plane_linear", _f32_plane_linear)
        j32 = functools.partial(jmlp.apply_mlp, dtype=jnp.float32)
        mp.setattr(jlidar_mod, "apply_mlp", j32)
        mp.setattr(jflow_mod, "apply_mlp", j32)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            jsim.main(argv + ["--workspace", jws])
    jax.clear_caches()

    raw = _jax_checkpoint(os.path.join(jws, "checkpoints", os.path.basename(FIXTURE)))
    opt = tconfig.get_arg_parser().parse_args(["--config", SMOKE, "--device", "cpu"])
    field = tlidar_mod.LiDAR4DField(tconfig.build_model_config(opt), device="cpu")
    tws = str(tmp / "tws")
    os.makedirs(os.path.join(tws, "checkpoints"))
    ckpt = os.path.join(tws, "checkpoints", os.path.basename(FIXTURE))
    torch.save({"params": interop.params_from_jax(field, raw["params"]),
                "epoch": int(raw["epoch"])}, ckpt)
    return dict(tmp=tmp, scene=scene, argv=argv, jax_points=_points(jws), tws=tws, ckpt=ckpt)


def _f32_port(mp):
    t32 = functools.partial(tmlp.apply_mlp, dtype=torch.float32)
    mp.setattr(tlidar_mod, "apply_mlp", t32)
    mp.setattr(tflow_mod, "apply_mlp", t32)


@pytest.fixture(scope="module")
def small_scene(tmp_path_factory):
    """A 3-frame scene (2 train, 1 val) for the runs that check only shapes."""
    root = str(tmp_path_factory.mktemp("small"))
    tsynth.generate_synthetic_sequence(root, sequence_id="9000", num_frames=3, H=8, W=32,
                                       val_every=3)
    return root


def _actions(parser):
    return {a.dest: (a.option_strings, a.type, a.default, a.nargs, a.const)
            for a in parser._actions if a.dest != "help"}


def test_parser_flags_match_jax():
    got, want = _actions(tsim.get_sim_arg_parser()), _actions(_JAX_SIM_PARSER())
    assert set(want) - set(got) == {"fp16", "preload"}
    assert set(got) - set(want) == {"device", "plane_hash_scales", "plane_hash_log2"}
    for dest in set(want) & set(got):
        assert got[dest] == want[dest], dest
    train = _actions(tconfig.get_arg_parser())
    for dest in ("device", "plane_hash_scales", "plane_hash_log2"):
        assert got[dest][:4] == train[dest][:4], dest


def test_jax_sim_cli_cannot_build_a_field(monkeypatch, tmp_path):
    """The JAX package's fault: its simulation parser lacks flags its
    build_model_config reads. This fails once the JAX package is repaired."""
    monkeypatch.setattr(jcompile_cache, "enable_compilation_cache", lambda *a, **k: None)
    with pytest.raises(AttributeError, match="|".join(MISSING)):
        jsim.main(["--config", SMOKE, "--workspace", str(tmp_path)])
    opt = _JAX_SIM_PARSER().parse_args(["--config", SMOKE])
    assert [d for d in MISSING if hasattr(opt, d)] == []


@pytest.mark.parametrize("shift_z", [0.0, 0.5])
def test_kitti2nus_preset_matches_jax(shift_z):
    def opt():
        return SimpleNamespace(fov_lidar=[2.0, 26.9], H_lidar=66, W_lidar=1030, far_lidar=81.0,
                               shift_z=shift_z, scale=0.01, use_refine=True)

    got, want = tsim.apply_kitti2nus_preset(opt()), jsim.apply_kitti2nus_preset(opt())
    assert vars(got) == vars(want)
    assert (got.H_lidar, got.W_lidar, got.use_refine) == (32, 1024, False)
    np.testing.assert_allclose(got.shift_z, shift_z + 0.1 * 0.01)


def test_sequence_poses_times_match_jax(tmp_path):
    scale, offset = tsynth.generate_synthetic_sequence(
        str(tmp_path), sequence_id="9000", num_frames=7, H=4, W=16, val_every=3)
    opt = SimpleNamespace(path=str(tmp_path), sequence_id="9000", scale=scale, offset=offset,
                          fov_lidar=[2.0, 26.9])
    got, want = tsim._sequence_poses_times(opt), jsim._sequence_poses_times(opt)
    assert got[0].shape == (7, 4, 4) and got[1].shape == (7,)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(FileNotFoundError):
        tsim._sequence_poses_times(SimpleNamespace(**{**vars(opt), "path": str(tmp_path / "none")}))


def test_cli_matches_jax_on_tracked_checkpoint(sim_run, monkeypatch):
    _f32_port(monkeypatch)
    sim = tsim.main(sim_run["argv"] + ["--workspace", sim_run["tws"], "--device", "cpu"])
    assert sim.use_refine and (sim.H_lidar, sim.W_lidar) == (16, 64)
    got, want = _points(sim_run["tws"]), sim_run["jax_points"]
    assert len(got) == len(want) == FRAMES
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and a.shape[1] == 4
        assert abs(len(a) - len(b)) <= FLIP_SHARE * 16 * 64, i
        assert len(a) == len(b), f"frame {i}: {len(a)} points, JAX {len(b)}"
        err = np.abs(a - b).max()
        assert err <= POINT_ATOL, f"frame {i}: {err}"


def test_cli_equals_simulator_render(sim_run, small_scene, tmp_path):
    """The CLI's clouds (bfloat16 MLPs, the refine) are bitwise those of
    Simulator.render on the checkpoint's parameters and rays built here
    from the CLI's flags (fewer samples a ray than the config's 96, for
    time)."""
    ws = str(tmp_path / "ws")
    shutil.copytree(os.path.join(sim_run["tws"], "checkpoints"), os.path.join(ws, "checkpoints"))
    argv = ["--config", SMOKE, "--path", small_scene, "--device", "cpu", "--num_steps", "16",
            *SIM]
    sim = tsim.main(argv + ["--workspace", ws])
    assert sim.use_refine

    opt = tsim.get_sim_arg_parser().parse_args(argv)
    opt.near_lidar *= opt.scale
    opt.far_lidar *= opt.scale
    field = tlidar_mod.LiDAR4DField(tconfig.build_model_config(opt), device="cpu")
    params = torch.load(sim_run["ckpt"], weights_only=True)["params"]
    poses, times = tsim._sequence_poses_times(opt)
    rays_o, rays_d = build_novel_rays(poses, 16, 64, opt.fov_lidar)
    rays_o = shift_trajectory(rays_o, 0.0, 0.5, 0.0, opt.scale, align_axis=True)
    direct = Simulator("lidar4d", opt, field, params, workspace=str(tmp_path / "direct"),
                       use_refine=True, H_lidar=16, W_lidar=64, device="cpu")
    direct.render(rays_o, rays_d, times, save_img=False, save_video=False)
    got, want = _points(ws), _points(str(tmp_path / "direct"))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_kitti2nus_cli(sim_run, small_scene, tmp_path):
    """--kitti2nus renders the 32x1024 grid without the refine (fewer
    samples a ray than the config's 96, for time)."""
    ws = str(tmp_path / "ws")
    shutil.copytree(os.path.join(sim_run["tws"], "checkpoints"), os.path.join(ws, "checkpoints"))
    sim = tsim.main(["--config", SMOKE, "--path", small_scene, "--workspace", ws,
                     "--device", "cpu", "--num_steps", "4", "--kitti2nus", "--shift_y", "0.5",
                     "--align_axis"])
    assert not sim.use_refine and (sim.H_lidar, sim.W_lidar) == (32, 1024)
    assert sim.opt.fov_lidar == [10.0, 40.0]
    assert sim.opt.far_lidar == pytest.approx(70 * sim.opt.scale)
    clouds = _points(ws)
    assert len(clouds) == 3
    for a in clouds:
        assert a.ndim == 2 and a.shape[1] == 4 and 0 < len(a) <= 32 * 1024
        assert np.isfinite(a).all()


def test_checkpoint_handling(small_scene, tmp_path):
    """An orbax directory raises; a missing checkpoint warns and renders the
    seeded init; cuda without a card raises."""
    argv = ["--config", SMOKE, "--path", small_scene, "--device", "cpu",
            "--H_lidar", "16", "--W_lidar", "64", "--num_steps", "8"]
    with pytest.raises(ValueError, match="orbax"):
        tsim.main(argv + ["--workspace", str(tmp_path / "a"), "--ckpt", FIXTURE])
    with pytest.raises(ValueError, match="orbax"):
        tsim.main(argv + ["--workspace", os.path.join(ROOT, "workspace", "smoke")])
    ws = str(tmp_path / "b")
    with pytest.warns(UserWarning, match="No checkpoint found"):
        sim = tsim.main(argv + ["--workspace", ws])
    want = sim.field.init(seed=0)
    for a, b in zip(interop.tree_leaves(sim.params), interop.tree_leaves(want)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    clouds = _points(ws)
    assert len(clouds) == 3 and all(np.isfinite(c).all() for c in clouds)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tsim.main(argv + ["--workspace", str(tmp_path / "c"), "--device", "cuda"])
