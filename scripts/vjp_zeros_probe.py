"""Count plane_bilinear_vjp's point gradients that are an exact zero on one
side only (kernel or plain version) on the card: 60 draws at each of the
four flagship time-plane shapes [3, 8, 8, S], 1,024 ray-like segments of 256
samples and per-ray times (16 of them frame times k / 50), as
chip_smoke.vjp_cases draws them. Each such point is printed beside its
float64 value; chip_smoke.vjp_zeros takes them as float32 cancellations.

    python3 scripts/vjp_zeros_probe.py
"""
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from lidar4d_tpu_torch.ops import plane_onehot as po  # noqa: E402


def main():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    n_rays, samples = 1024, 256
    n = n_rays * samples
    total = {"trials": 0, "values": 0, "mismatch": 0}
    t0 = time.time()
    for trial in range(60):
        for s in (32, 64, 128, 256):
            a = -0.05 + 1.1 * torch.rand(n_rays, 1, 3, generator=gen, device=dev)
            b = -0.05 + 1.1 * torch.rand(n_rays, 1, 3, generator=gen, device=dev)
            lam = torch.linspace(0, 1, samples, device=dev)[None, :, None]
            pts = (a + (b - a) * lam).reshape(n, 3)
            t = torch.rand(n_rays, generator=gen, device=dev)
            t[:16] = torch.linspace(0, 50, 16, device=dev).round() / 50
            t = t.repeat_interleave(samples)[:, None]
            q = torch.stack([torch.cat([pts[:, [c]], t], -1) for c in range(3)]).contiguous()
            grid = 0.5 + torch.rand(3, 8, 8, s, generator=gen, device=dev)
            cot = torch.randn(3, 8, n, generator=gen, device=dev)
            got = po.plane_bilinear_vjp(grid, q, cot)[1]
            want = po.plane_bilinear_vjp_plain(grid, q, cot)[1]
            want64 = po.plane_bilinear_vjp_plain(grid.double(), q, cot.double())[1]
            torch.cuda.synchronize()
            bad = (got == 0) != (want == 0)
            total["trials"] += 1
            total["values"] += got.numel()
            total["mismatch"] += int(bad.sum())
            rel = ((got - want).abs().max() / want.abs().max()).item()
            for p, i, j in bad.nonzero()[:4].tolist():
                print(json.dumps(dict(s=s, trial=trial, p=p, i=i, coord=j, q=q[p, i].tolist(),
                                      got=got[p, i, j].item(), want=want[p, i, j].item(),
                                      want64=want64[p, i, j].item(), max_rel=rel,
                                      scale=want.abs().max().item())), flush=True)
    print(json.dumps(total), f"{time.time() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
