#!/usr/bin/env python3
"""Which torch.distributed collectives gloo runs on CUDA tensors.

    python3 scripts/gloo_cuda_collectives.py

Needs one CUDA card. Starts two gloo ranks on card 0 (`parallel.launch`)
and tries each collective once on a small CUDA tensor; prints one JSON line
{"gloo_on_cuda": {collective: "ok" or the error}} with the card's name and
PyTorch's version. `parallel.mesh` gathers through an all-reduce of
zero-filled slots, the collective every backend documents for every
device, so it needs none of the others.
"""

import json
import os
import sys
import tempfile

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def probe(rank, root):
    import torch.distributed as dist

    dev = torch.device("cuda", 0)
    x = torch.full((4,), float(rank + 1), device=dev)
    calls = {
        "all_reduce_sum": lambda: dist.all_reduce(x.clone()),
        "all_reduce_max": lambda: dist.all_reduce(x.clone(), op=dist.ReduceOp.MAX),
        "broadcast": lambda: dist.broadcast(x.clone(), 0),
        "broadcast_int64": lambda: dist.broadcast(torch.arange(4, device=dev), 0),
        "all_gather": lambda: dist.all_gather([torch.empty_like(x) for _ in range(2)], x),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(8, device=dev), x),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty(2, device=dev), x),
    }
    result = {}
    for name, call in calls.items():
        try:
            call()
            torch.cuda.synchronize()
            result[name] = "ok"
        except (RuntimeError, ValueError, NotImplementedError) as e:
            result[name] = f"{type(e).__name__}: {str(e)[:120]}"
        dist.barrier()
    torch.save(result, os.path.join(root, f"rank{rank}.pt"))


def main():
    if not torch.cuda.is_available():
        print("gloo_cuda_collectives: no CUDA card", file=sys.stderr)
        return 2
    from lidar4d_tpu_torch.parallel.launch import join_ranks, start_ranks

    with tempfile.TemporaryDirectory() as root:
        join_ranks(start_ranks(probe, (root,), 2, f"file://{root}/rendezvous", "gloo"), 120)
        result = torch.load(os.path.join(root, "rank0.pt"))
    print(json.dumps({"device": torch.cuda.get_device_name(0), "torch": torch.__version__,
                      "gloo_on_cuda": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
