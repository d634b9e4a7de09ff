#!/usr/bin/env python3
"""How often chip_smoke.py's classic-vs-fact step check fails from ReLU ties.

    python3 scripts/classic_vs_fact_ties.py [TRIALS]

Needs one CUDA GPU. Trains the flagship field twice as chip_smoke.py does
(2 + 5 steps from the seeded init) and prints how far the two trainings'
MLP weights differ (the kernels and PyTorch add in float32 atomics, whose
order varies from run to run, so the check meets a different state in
every run). Then for each trial it scales every weight of the field's MLPs
by 1 + 1e-4 x N(0, 1) (seeded) and runs chip_smoke.py's comparison of one
classic step against one fact step twice: each step on its own ReLU masks, and the classic step on the fact
step's masks (as chip_smoke.py now runs it). Prints one line per trial (the
pre-activations whose sign differs between the two steps, and each
comparison's outcome) and the failure counts of both.
"""

import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
import chip_smoke as cs  # noqa: E402


def mlp_weights(params):
    """The weight lists of the field's MLPs (the lists themselves, in place)."""
    return {"sigma": params["sigma"], "intensity": params["intensity"],
            "raydrop": params["raydrop"], "flow mlp": params["flow"]["mlp"]}


def outcome(field, signal, classic, fact):
    try:
        cs.compare_steps("classic vs fact", field, signal, classic, fact, cs.CLASSIC_STEP_RTOL,
                         cs.CLASSIC_GRAD_RTOL, post_step=False)
    except AssertionError as e:
        return f"FAIL ({e})"
    return "pass"


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from lidar4d_tpu_torch.cli.config import build_model_config, get_arg_parser
    from lidar4d_tpu_torch.models.lidar4d import LiDAR4DField

    trials = int(sys.argv[1]) if len(sys.argv) > 1 else 30
    dev = torch.device("cuda", 0)
    opt = get_arg_parser().parse_args(["--config", cs.CONFIG])
    opt.near_lidar *= opt.scale
    opt.far_lidar *= opt.scale
    field = LiDAR4DField(build_model_config(opt), device=dev)
    with tempfile.TemporaryDirectory() as root:
        ds, cache, scale = cs.make_scene(root)
    tfield = cs.train_field(field, scale)
    params, again = field.init(seed=cs.SEED), field.init(seed=cs.SEED)
    cs.train(tfield, params, ds, cache, opt, dev)
    cs.train(tfield, again, ds, cache, opt, dev)
    a, b = mlp_weights(params), mlp_weights(again)
    print("two trainings, MLP weights: max |a - b| / max |a| by MLP " + str(
        {k: max(((u - v).abs().max() / u.abs().max()).item() for u, v in zip(a[k], b[k]))
         for k in a}), flush=True)
    sampling = dict(num_steps=cs.UNIFORM_STEPS)
    fails = {"own masks": 0, "shared masks": 0}
    for trial in range(trials):
        signal = cs.signal_params(params)
        rng = np.random.default_rng(trial)
        for ws in mlp_weights(signal).values():
            ws[:] = [w * (1 + 1e-4 * rng.standard_normal(w.shape)).astype(np.float32)
                     for w in ws]
        masks = []
        with cs.onehot_variant("fact"), cs.float32_mlps_sharing_relu_masks(masks, True):
            fact = cs.step_grads(tfield, signal, ds, cache, sampling)
        with cs.onehot_variant("classic"), cs.mlp_dtype(torch.float32):
            own = cs.step_grads(tfield, signal, ds, cache, sampling, draws=fact[3])
        with (cs.onehot_variant("classic"),
              cs.float32_mlps_sharing_relu_masks(masks, False) as relu):
            shared = cs.step_grads(tfield, signal, ds, cache, sampling, draws=fact[3])
        results = {"own masks": outcome(tfield, signal, own, fact),
                   "shared masks": outcome(tfield, signal, shared, fact)}
        for k, r in results.items():
            fails[k] += r != "pass"
        print(f"TRIAL {trial}: {relu['flipped']} of {relu['masked']} pre-activations of "
              f"the other sign; " + "; ".join(f"{k}: {r}" for k, r in results.items()),
              flush=True)
    print(f"failures of {trials} trials: {fails}", flush=True)


if __name__ == "__main__":
    main()
