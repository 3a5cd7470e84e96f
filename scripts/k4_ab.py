"""K4's banded search on the card, for an A/B of two checkouts.

    python3 scripts/k4_ab.py DIR

Builds the kernels of the checkout DIR (into DIR/build), holds K4 against
its plain version on doc512 at W=64, R=128, and prints the search kernel's
device time (torch.profiler, mean of 20 launches) on doc512 and on the
3300 x 2550 letter page at W=64, R=128.  For an A/B, unpack the parent
(`git archive`) into a git-ignored directory (`dist/`) and run parent,
change, change, parent in one call, each in its own process.
"""

import os
import sys

import numpy as np
import torch

ROOT = os.path.abspath(sys.argv[1])
sys.path.insert(0, ROOT)

from binary_image_compression_tpu_torch.ops import _cuda  # noqa: E402
from binary_image_compression_tpu_torch.ops import fused_search as fs  # noqa
from binary_image_compression_tpu_torch.ops import select_windows as sw  # noqa
from binary_image_compression_tpu_torch.utils import pnm  # noqa: E402


def device_ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.device_time_total for e in prof.key_averages()
             if "banded_search_kernel" in e.key)
    return us / 1e3 / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("k4_ab: torch.cuda is not available", file=sys.stderr)
        return 1
    _cuda.build()
    _cuda.get_lib()
    dev = torch.device("cuda", 0)
    doc = pnm.read_pbm(os.path.join(ROOT, "tests", "fixtures", "doc512.pbm"))
    letter = np.tile(doc, (7, 5))[:3300, :2550]
    W, R = 64, 128
    for name, page in (("doc512", doc), ("letter", letter)):
        rows, cols = page.shape
        ny, nx = -(-rows // W), -(-cols // W)
        grid = np.zeros((1, ny * W, nx * W), dtype=bool)
        grid[0, :rows, :cols] = page
        img = torch.from_numpy(grid).to(dev)
        He = fs.plane_height(ny * W, W, R)
        E = sw._launch_plane(img, W, He)
        kw = dict(W=W, R=R, T_thresh=1, cols=cols, invert=True)
        if name == "doc512":
            want = sw.select_windows_plain(fs._field_plane(img, W, He, nx * W),
                                           ny, nx, **kw)
            if not torch.equal(sw._launch(E, ny, nx, **kw), want):
                raise AssertionError("K4 disagrees with its plain version")
        ms = device_ms(lambda: sw._launch(E, ny, nx, **kw))
        print(f"{os.path.basename(ROOT)} {name} W=64 R=128 K4 search device "
              f"ms {ms:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
