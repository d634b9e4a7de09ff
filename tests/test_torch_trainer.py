"""The port's training entry point on the CPU: checkpoints
(lidar4d_tpu_torch.train.checkpoints), the Trainer's own behaviour, mirroring
tests/test_trainer.py for the JAX package, and the CLI
(lidar4d_tpu_torch.cli.main_lidar4d). The comparisons with the JAX trainer
are in tests/test_torch_trainer_slice.py.

A tiny field (the widths of tests/test_torch_train.py) on a tiny synthetic
scene; every comparison here is within the port, so results are exact.
"""

import copy
import functools
import hashlib
import json
import os
import shutil

import numpy as np
import pytest
import torch

from lidar4d_tpu_torch import interop
from lidar4d_tpu_torch.cli import main_lidar4d
from lidar4d_tpu_torch.cli.config import (
    build_loss_config,
    build_model_config,
    get_arg_parser,
    ranks_to_start,
)
from lidar4d_tpu_torch.data.kitti360 import KITTI360Dataset
from lidar4d_tpu_torch.data.synthetic import generate_synthetic_sequence
from lidar4d_tpu_torch.models import flow_field as flow_field_mod
from lidar4d_tpu_torch.models import lidar4d as lidar4d_mod
from lidar4d_tpu_torch.models.lidar4d import LiDAR4DField
from lidar4d_tpu_torch.ops import mlp
from lidar4d_tpu_torch.train import trainer as trainer_mod
from lidar4d_tpu_torch.train.checkpoints import CheckpointManager
from lidar4d_tpu_torch.train.trainer import Trainer
from torch_threads import limit_under_xdist

limit_under_xdist()

H, W, FRAMES, SEQ = 32, 64, 6, "9000"
TINY = ["--num_rays_lidar", "64", "--num_steps", "24", "--num_coarse", "8", "--num_fine", "16",
        "--base_resolution", "8", "--max_resolution", "32", "--log2_hashmap_size", "8",
        "--n_levels_hash", "2", "--n_features_per_level_hash", "8",
        "--hash_size_dynamic", "8", "7", "7", "--n_levels_plane", "2", "--min_resolution", "8",
        "--time_resolution", "4", "--flow_n_levels", "2", "--flow_n_features", "8",
        "--flow_log2_hashmap_size", "8", "--flow_base_resolution", "8",
        "--flow_max_resolution", "16", "--plane_hash_scales", "1", "--plane_hash_log2", "7"]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """A synthetic scene (4 train frames, 2 val / test frames) and the tiny
    config's options, as the CLI prepares them."""
    root = str(tmp_path_factory.mktemp("trainer_scene"))
    scale, offset = generate_synthetic_sequence(root, sequence_id=SEQ, num_frames=FRAMES, H=H,
                                                W=W, val_every=3)
    argv = ["--config", "/nonexistent", "--dataloader", "synthetic", "--path", root,
            "--sequence_id", SEQ, "--num_frames", str(FRAMES), "--synthetic_H", str(H),
            "--synthetic_W", str(W), "--scale", repr(scale),
            "--offset", *map(repr, offset), "--iters", "8", "--eval_interval", "100",
            "--hier_warmup_iters", "4", "--device", "cpu", "--ckpt", "scratch", *TINY]
    opt = get_arg_parser().parse_args(argv)
    opt.near_lidar *= opt.scale
    opt.far_lidar *= opt.scale
    ds = {split: KITTI360Dataset(split=split, root_path=root, sequence_id=SEQ, scale=scale,
                                 offset=offset, num_rays_lidar=64)
          for split in ("train", "val", "refine")}
    assert len(ds["train"]) == 4 and len(ds["val"]) == 2
    return dict(root=root, argv=argv, opt=opt, ds=ds)


def _trainer(scene, ws, opt=None, **kw):
    opt = opt or scene["opt"]
    field = LiDAR4DField(build_model_config(opt), device="cpu")
    kw.setdefault("use_checkpoint", "scratch")
    return Trainer("lidar4d", opt, field, build_loss_config(opt), workspace=str(ws),
                   lidar_metrics=kw.pop("lidar_metrics", []), eval_interval=100, **kw)


def _leaves(tree):
    return [t.detach().clone() for t in interop.tree_leaves(tree)]


def _equal(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


# ------------------------------------------------------------ checkpoints
def test_checkpoint_names_max_keep_and_resolve(tmp_path):
    """{name}_ep{NNNN} / _best / _ep{NNNN}_refine, max_keep, latest by sorted
    names, and the tree restored as saved."""
    cm = CheckpointManager(str(tmp_path / "ws"), max_keep=2)
    tree = {"params": {"a": torch.arange(3.0), "b": [torch.ones(2, 2)]}, "epoch": 1}
    for epoch in (1, 2, 3):
        cm.save_epoch(dict(tree, epoch=epoch), epoch)
    assert sorted(os.listdir(cm.ckpt_dir)) == ["lidar4d_ep0002", "lidar4d_ep0003"]
    assert cm.latest_path().endswith("lidar4d_ep0003")
    cm.save_refine(tree, 3)
    assert cm.latest_path().endswith("lidar4d_ep0003")
    assert cm.latest_path(include_refine=True).endswith("lidar4d_ep0003_refine")
    assert cm.best_path() is None and cm.resolve("best").endswith("lidar4d_ep0003")
    cm.save_best(tree)
    assert cm.resolve("best").endswith("lidar4d_best")
    assert cm.resolve("scratch") is None and cm.resolve(str(tmp_path / "nothing")) is None
    assert cm.resolve("latest_model", include_refine=True).endswith("_refine")
    got = cm.restore(cm.resolve(cm.latest_path()))
    assert got["epoch"] == 3
    assert torch.equal(got["params"]["a"], tree["params"]["a"])
    assert torch.equal(got["params"]["b"][0], tree["params"]["b"][0])


def test_latest_path_skips_temporaries(tmp_path):
    """A killed writer leaves its temporary behind; 'latest' never resolves
    to it, and a save never leaves one."""
    cm = CheckpointManager(str(tmp_path / "ws"))
    cm.save_epoch({"epoch": 1}, 1)
    with open(os.path.join(cm.ckpt_dir, "lidar4d_ep0002.tmp-123"), "wb") as f:
        f.write(b"partial")
    assert cm.latest_path().endswith("lidar4d_ep0001")
    assert cm.latest_path(include_refine=True).endswith("lidar4d_ep0001")
    cm.save_epoch({"epoch": 3}, 3)
    assert sorted(os.listdir(cm.ckpt_dir)) == ["lidar4d_ep0002.tmp-123", "lidar4d_ep0003"]


def _tree_digest(root):
    """{relative path: sha256} of every file under root."""
    out = {}
    for d, _, files in os.walk(root):
        for name in files:
            path = os.path.join(d, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = hashlib.sha256(f.read()).hexdigest()
    return out


def test_jax_workspace_refused_and_left_as_is(tmp_path, monkeypatch):
    """configs/synthetic_smoke.txt names workspace/smoke, which holds the JAX
    package's orbax checkpoints under the port's names. Run as documented
    without --workspace (in a copy of the repository's fixture), the CLI
    refuses it before it writes anything; an orbax directory given as
    --ckpt is refused too."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    shutil.copytree(os.path.join(repo, "workspace", "smoke"), tmp_path / "workspace" / "smoke")
    os.makedirs(tmp_path / "configs")
    shutil.copy(os.path.join(repo, "configs", "synthetic_smoke.txt"), tmp_path / "configs")
    monkeypatch.chdir(tmp_path)
    before = _tree_digest(tmp_path)
    assert any(k.startswith(os.path.join("workspace", "smoke", "checkpoints")) for k in before)
    with pytest.raises(ValueError, match="orbax"):
        main_lidar4d.main(["--config", "configs/synthetic_smoke.txt", "--device", "cpu"])
    with pytest.raises(ValueError, match="orbax"):
        CheckpointManager("workspace/smoke")
    assert _tree_digest(tmp_path) == before
    cm = CheckpointManager(str(tmp_path / "ws"))
    with pytest.raises(ValueError, match="orbax"):
        cm.resolve(os.path.join("workspace", "smoke", "checkpoints", "lidar4d_ep0020"))


# ---------------------------------------------------------------- trainer
def test_trainer_train_checkpoint_resume(scene, tmp_path):
    trainer = _trainer(scene, tmp_path / "ws")
    ds = scene["ds"]["train"]
    trainer.train_one_epoch(ds, patch_size=1)
    trainer.train_one_epoch(ds, patch_size=1)
    assert trainer.global_step == 2 * len(ds)
    assert trainer.state.ema.num_updates == 2              # the EMA once an epoch
    assert trainer.state.opt_state.count == trainer.state.step == 2 * len(ds)
    trainer.epoch = 2
    trainer.save_checkpoint()

    t2 = _trainer(scene, tmp_path / "ws", use_checkpoint="latest")
    assert (t2.epoch, t2.global_step, t2.state.step) == (2, trainer.global_step, 2 * len(ds))
    assert _equal(_leaves(t2.state.params), _leaves(trainer.state.params))
    assert _equal(_leaves(t2.state.ema.shadow), _leaves(trainer.state.ema.shadow))
    assert t2.state.ema.num_updates == 2
    assert _equal(t2.state.opt_state.mu, trainer.state.opt_state.mu)
    assert _equal(t2.state.opt_state.nu, trainer.state.opt_state.nu)
    assert t2.state.opt_state.count == trainer.state.opt_state.count
    # params + EMA only: the optimizer starts afresh
    t3 = _trainer(scene, tmp_path / "ws")
    t3.load_checkpoint("latest", model_only=True)
    assert (t3.epoch, t3.global_step, t3.state.opt_state.count) == (2, 2 * len(ds), 0)
    assert _equal(_leaves(t3.state.params), _leaves(trainer.state.params))
    assert t3.state.ema.num_updates == 2

    # resumed training continues as uninterrupted training does, bit for bit:
    # with deterministic algorithms the CPU's scatter adds of the table
    # gradients run serially instead of as atomic adds in thread order
    torch.use_deterministic_algorithms(True)
    try:
        for t in (trainer, t2):
            for g in t._generators:
                g.manual_seed(5)
            t._rng = np.random.default_rng(9)
            t.train_one_epoch(ds, patch_size=1)
    finally:
        torch.use_deterministic_algorithms(False)
    assert t2.stats["loss"][-1] == trainer.stats["loss"][-1]
    assert _equal(_leaves(t2.state.params), _leaves(trainer.state.params))


def test_ckpt_interval_skips_intermediate_epochs(scene, tmp_path):
    """ckpt_interval=2 over 3 epochs saves ep2 (interval) and ep3 (last),
    never ep1; max_keep=1 leaves the newest; the warm-up and the patch
    alternation pick the step variants."""
    opt = copy.copy(scene["opt"])
    opt.ckpt_interval = 2
    trainer = _trainer(scene, tmp_path / "ws", opt)
    saved = []
    orig = trainer.ckpt.save_epoch
    trainer.ckpt.save_epoch = lambda tree, epoch, **kw: (saved.append(epoch),
                                                         orig(tree, epoch, **kw))[1]
    ds = scene["ds"]
    trainer.train(ds["train"], ds["val"], ds["refine"], max_epochs=3, run_refine=False)
    assert saved == [2, 3]
    assert sorted(os.listdir(trainer.ckpt.ckpt_dir)) == ["lidar4d_ep0003"]
    # epoch 1 uniform (hier_warmup_iters = one epoch), epoch 2 at patch (2, 8)
    assert sorted(trainer._steps) == [(H, W, (1,), 0, 0), (H, W, (1,), 8, 16),
                                      (H, W, (2, 8), 8, 16)]
    assert trainer.flow_cache is not None and trainer.global_step == 3 * len(ds["train"])
    assert _trainer(scene, tmp_path / "ws", opt, use_checkpoint="latest").epoch == 3


def test_refine_drops_ema(scene, tmp_path, monkeypatch):
    """refine() copies the EMA in and drops it (runner.py:819-821); a fresh
    Trainer loading 'latest' overlays the refine checkpoint, so its eval
    parameters are the refined U-Net, not the EMA's random-init one."""
    trainer = _trainer(scene, tmp_path / "ws")
    trainer.train_one_epoch(scene["ds"]["train"], patch_size=1)
    assert trainer.state.ema.num_updates == 1
    orig = trainer_mod.refine_unet
    monkeypatch.setattr(trainer_mod, "refine_unet",
                        lambda *a, **kw: orig(*a, **dict(kw, steps=2, log_fn=lambda s: None)))
    before = _leaves(trainer.state.ema.shadow["unet"])
    trainer.refine(scene["ds"]["refine"])
    assert trainer.state.ema.num_updates == 0
    assert trainer._eval_params() is trainer.state.params
    refined = _leaves(trainer.state.params["unet"]["params"])
    assert not _equal(refined, before[:len(refined)])
    assert os.path.exists(os.path.join(trainer.ckpt.ckpt_dir, "lidar4d_ep0000_refine"))

    trainer.save_checkpoint()                   # the full state at the refine's epoch
    t2 = _trainer(scene, tmp_path / "ws", use_checkpoint="latest")
    assert _equal(_leaves(t2._eval_params()["unet"]["params"]), refined)
    assert trainer._refine_trained and t2._refine_trained
    assert t2._resolve_use_refine(True) is True
    # an explicit refine checkpoint loads the weights alone
    t3 = _trainer(scene, tmp_path / "ws", use_checkpoint=os.path.join(
        trainer.ckpt.ckpt_dir, "lidar4d_ep0000_refine"))
    assert t3._refine_trained and _equal(_leaves(t3.state.params["unet"]["params"]), refined)


def test_eval_downgrades_refine_when_unet_untrained(scene, tmp_path):
    trainer = _trainer(scene, tmp_path / "ws")
    assert not trainer._refine_trained
    assert trainer._resolve_use_refine(True) is False
    assert trainer._resolve_use_refine(False) is False
    trainer.evaluate(scene["ds"]["val"])
    assert trainer.use_refine is False
    assert len(trainer.stats["valid_loss"]) == 1 and np.isfinite(trainer.stats["valid_loss"][0])


def test_best_checkpoint_rejects_nonfinite(scene, tmp_path):
    trainer = _trainer(scene, tmp_path / "ws")
    trainer.save_checkpoint(best=True)                       # nothing evaluated yet
    assert trainer.ckpt.best_path() is None
    for poisoned in (float("inf"), float("nan")):
        trainer.stats["results"].append(poisoned)
        trainer.save_checkpoint(best=True)
        assert trainer.ckpt.best_path() is None and trainer.stats["best_result"] is None
    trainer.stats["results"].append(1.0)
    trainer.save_checkpoint(best=True)
    assert trainer.ckpt.best_path() is not None and trainer.stats["best_result"] == 1.0
    trainer.stats["results"].append(2.0)
    trainer.save_checkpoint(best=True)
    assert trainer.stats["best_result"] == 1.0
    t2 = _trainer(scene, tmp_path / "ws", use_checkpoint="best")
    assert _equal(_leaves(t2.state.params), _leaves(trainer.state.ema.shadow))


def test_param_finiteness_sentinel(scene, tmp_path):
    trainer = _trainer(scene, tmp_path / "ws")
    trainer._assert_params_finite()
    trainer.state.params["hash"]["static"][0, 0] = float("nan")
    with pytest.raises(RuntimeError, match=r"non-finite parameters.*\['hash.static'\]"):
        trainer._assert_params_finite()


def test_single_device_only(scene):
    """The CLI's device count: --num_devices 0 and 1 mean one device, N
    more ranks; on cuda (NCCL, one card a rank) never more ranks than cards;
    without a process group the Trainer itself takes one device, and more
    needs one."""
    opt = copy.copy(scene["opt"])
    for n in (0, 1):
        opt.num_devices = n
        assert ranks_to_start(opt) == 1
        assert trainer_mod.mesh_from_options(opt) is None
    opt.num_devices = 2
    assert ranks_to_start(opt) == 2
    with pytest.raises(RuntimeError, match="needs a process group"):
        trainer_mod.mesh_from_options(opt)
    opt.device = "cuda"
    opt.num_devices = max(2, torch.cuda.device_count() + 1)
    with pytest.raises(ValueError, match="one card a rank"):
        ranks_to_start(opt)
    opt.device = "cuda:0"
    with pytest.raises(ValueError, match="its own card"):
        ranks_to_start(opt)


# -------------------------------------------------------------------- CLI
def test_cli_train_only_then_test_eval(scene, tmp_path):
    """main(argv) on the CPU: a few steps with --train_only (2 epochs,
    evaluation at epoch 2), then --test_eval --ckpt latest from the same
    workspace; the args dump, logs, metrics and test outputs."""
    ws = str(tmp_path / "ws")
    argv = scene["argv"] + ["--workspace", ws, "--eval_interval", "2"]
    first = main_lidar4d.main(argv + ["--train_only"])
    assert first.epoch == 2 and first.global_step == 8
    assert first.opt.near_lidar == pytest.approx(1.0 * first.opt.scale)
    records = [json.loads(line) for line in open(first.metrics_path)]
    assert [(r["sampler"], r["patch"]) for r in records if "rays_per_sec" in r] == [
        ("uniform", "1"), ("hierarchical", "2x8")]
    evals = [r for r in records if "valid_loss" in r]
    assert len(evals) == 1 and set(evals[0]) >= {"RaydropMeter", "intensity", "depth",
                                                 "PointsMeter", "depth_lpips_calibrated"}
    assert os.path.exists(os.path.join(ws, "args.txt"))
    best = first.stats["best_result"]
    assert best is None or best == evals[0]["PointsMeter"][0]
    assert sorted(os.listdir(first.ckpt.ckpt_dir)) == (["lidar4d_best"] if best else []) + [
        "lidar4d_ep0002"]

    second = main_lidar4d.main(argv + ["--ckpt", "latest", "--test_eval"])
    assert second.epoch == 2 and not second._refine_trained and second.use_refine is False
    assert _equal(_leaves(second.state.params), _leaves(first.state.params))
    records = [json.loads(line) for line in open(second.metrics_path)]
    assert len([r for r in records if "valid_loss" in r]) == 2
    outputs = sorted(os.listdir(os.path.join(ws, "results")))
    assert [f for f in outputs if f.endswith(".npy")] == [
        f"test_lidar4d_ep0002_{i:04d}_depth_lidar.npy" for i in (1, 2)]


def test_cli_refuses_what_it_cannot_run(scene, tmp_path):
    argv = scene["argv"] + ["--workspace", str(tmp_path / "ws")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main_lidar4d.main(argv + ["--device", "cuda"])
    with pytest.raises(SystemExit):      # a flag that would change nothing here
        main_lidar4d.main(argv + ["--fp16", "False"])
    with pytest.raises(SystemExit, match="nuscenes"):
        main_lidar4d.main(argv + ["--dataloader", "nuscenes"])


def _float32_mlps():
    f32 = functools.partial(mlp.apply_mlp, dtype=torch.float32)
    lidar4d_mod.apply_mlp = flow_field_mod.apply_mlp = f32


def _float32_rank_main(rank, argv):
    """The CLI's spawned ranks, with float32 MLPs."""
    _float32_mlps()
    main_lidar4d._rank_main(rank, argv)


def test_cli_two_ranks_equal_one_device(scene, tmp_path, monkeypatch):
    """--num_devices 2 --device cpu: main starts a second rank and returns
    rank 0's Trainer after one epoch (the uniform warm-up's 4 steps, the
    flow loss on), whose parameters are a one-device run's with the same
    seed; rank 0 alone wrote the checkpoint and the logs. Both runs use
    float32 MLPs (in the spawned rank too): a bfloat16 weight gradient summed
    from two halves rounds differently from one over the whole batch."""
    monkeypatch.setattr(lidar4d_mod, "apply_mlp", functools.partial(mlp.apply_mlp,
                                                                   dtype=torch.float32))
    monkeypatch.setattr(flow_field_mod, "apply_mlp", lidar4d_mod.apply_mlp)
    monkeypatch.setattr(main_lidar4d, "_rank_main", _float32_rank_main)
    argv = scene["argv"] + ["--train_only", "--max_epochs", "1"]
    one = main_lidar4d.main(argv + ["--workspace", str(tmp_path / "one")])
    two = main_lidar4d.main(argv + ["--workspace", str(tmp_path / "two"), "--num_devices", "2"])
    assert one.mesh is None and two.mesh.size == 2 and two.mesh.rank == 0
    assert two.global_step == one.global_step == 4
    for a, b in zip(_leaves(two.state.params), _leaves(one.state.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5)
    assert sorted(os.listdir(two.ckpt.ckpt_dir)) == ["lidar4d_ep0001"]
    logs = open(two.log_path).read()
    assert logs.count("==> Epoch 1") == 1 and "ray-parallel over 2 ranks" in logs
    # evaluate and test the checkpoint over two ranks: the frames rendered
    # over both, rank 0's outputs equal to one process's
    ws_one, ws_two = str(tmp_path / "one"), str(tmp_path / "two")
    argv = scene["argv"] + ["--ckpt", "latest", "--test_eval"]
    main_lidar4d.main(argv + ["--workspace", ws_one])
    main_lidar4d.main(argv + ["--workspace", ws_two, "--num_devices", "2"])
    evals = [[json.loads(line) for line in open(os.path.join(ws, "metrics_lidar4d.jsonl"))
              if "valid_loss" in line] for ws in (ws_one, ws_two)]
    assert len(evals[0]) == len(evals[1]) == 1
    np.testing.assert_allclose(evals[1][0]["valid_loss"], evals[0][0]["valid_loss"], rtol=1e-5)
    outputs = sorted(f for f in os.listdir(os.path.join(ws_two, "results")) if f.endswith(".npy"))
    assert outputs == sorted(f for f in os.listdir(os.path.join(ws_one, "results"))
                             if f.endswith(".npy")) and len(outputs) == 2


def test_cli_writes_synthetic_scene_on_demand(scene, tmp_path):
    """--dataloader synthetic with an empty --path writes the scene first;
    the same seed writes the same files as the fixture's."""
    root = str(tmp_path / "scene")
    argv = [a if a != scene["root"] else root for a in scene["argv"]]
    trainer = main_lidar4d.main(argv + ["--workspace", str(tmp_path / "ws"), "--test"])
    for name in sorted(os.listdir(os.path.join(scene["root"], "train"))):
        np.testing.assert_array_equal(np.load(os.path.join(root, "train", name)),
                                      np.load(os.path.join(scene["root"], "train", name)))
    assert trainer.epoch == 0


@pytest.mark.slow
def test_cli_synthetic_smoke_config(tmp_path):
    """The whole configs/synthetic_smoke.txt run (train 200 iterations,
    refine, evaluate, test) on the CPU."""
    ws = str(tmp_path / "ws")
    trainer = main_lidar4d.main(["--config", "configs/synthetic_smoke.txt", "--device", "cpu",
                                 "--workspace", ws, "--path", str(tmp_path / "scene")])
    assert trainer._refine_trained
    final = [json.loads(line) for line in open(trainer.metrics_path)][-1]
    assert np.isfinite(final["valid_loss"]) and np.isfinite(final["PointsMeter"]).all()
