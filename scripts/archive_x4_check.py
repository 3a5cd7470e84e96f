"""Check the CLI's ``archive`` under torchrun against one card and the plain
reference.

    python3 scripts/archive_x4_check.py [--ranks 4] [--pages 32]
        [--batch-size 4] [--device cuda] [--rows 2376 --cols 1728]

Writes N fax pages (1,728 x 2,376 by default, the benchmark's doc512 text
tiled and rolled by ``np.random.default_rng(7)``) as PBMs into a
temporary directory, builds the kernels and the native library once, then runs

    python -m torch.distributed.run --nproc-per-node R -m
        binary_image_compression_tpu_torch archive p*.pbm out.bica
        --batch-size B --checkpoint journal --spans spans.jsonl

and compares its output byte for byte with ``archive.encode_archive`` of
the same pages on one device and with the plain reference's BICA
(``benchmark/reference/codec8_x4.archive``).  Prints one JSON line: the
byte comparisons, the journals left, each rank's ``archive.shard``
seconds, the launcher's time and the card's name and power limit.  Exits
1 where a comparison fails.  ``--device cpu`` runs it on the CPU with gloo.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "benchmark")]


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "none"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--pages", type=int, default=32)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int, default=2376)
    ap.add_argument("--cols", type=int, default=1728)
    a = ap.parse_args()
    from binary_image_compression_tpu_torch import native
    from binary_image_compression_tpu_torch.models import archive, codec
    from binary_image_compression_tpu_torch.ops import _cuda
    from binary_image_compression_tpu_torch.utils import pnm
    from core import pages as pages_mod
    from reference import codec8_x4
    native.get_lib()
    if a.device == "cuda":
        _cuda.get_lib()
    pages = list(pages_mod.make_pages(a.rows, a.cols, a.pages, 7))
    tmp = tempfile.mkdtemp(prefix="archive-x4-")
    names = []
    for i, p in enumerate(pages):
        names.append(os.path.join(tmp, f"p{i:03d}.pbm"))
        pnm.write_pbm(p, names[-1])
    out, journal = os.path.join(tmp, "out.bica"), os.path.join(tmp, "journal")
    spans = os.path.join(tmp, "spans.jsonl")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
           str(a.ranks), "-m", "binary_image_compression_tpu_torch", "archive",
           *names, out, "--batch-size", str(a.batch_size), "--checkpoint",
           journal, "--device", a.device, "--spans", spans]
    t0 = time.perf_counter()
    run = subprocess.run(cmd, capture_output=True, text=True, timeout=900,
                         cwd=REPO)
    launched_s = time.perf_counter() - t0
    if run.returncode != 0:
        print(run.stdout[-3000:], run.stderr[-6000:], file=sys.stderr)
        return 1
    with open(out, "rb") as f:
        got = f.read()
    params = codec.CodecParams(codec=8, W=16, R=128, strict=False)
    one = archive.encode_archive(pages, params, batch_size=a.batch_size,
                                 device=a.device)
    ref = codec8_x4.archive(pages, {"codec": 8, "W": 16, "R": 128, "T": None},
                            a.device)
    ranks = {}
    for path in sorted(glob.glob(spans + ".rank*")):
        with open(path) as f:
            lines = [json.loads(line) for line in f]
        ranks[path.rsplit(".", 1)[1]] = {
            "shard_s": sum((d["end_ns"] - d["start_ns"]) / 1e9
                           for d in lines if d.get("span") == "archive.shard"),
            "spans": sum("span" in d for d in lines)}
    res = {"ok": got == one == ref, "equals_one_card": got == one,
           "equals_reference": got == ref, "bytes": len(got),
           "pages": len(pages), "ranks": a.ranks,
           "journals_left": sorted(os.path.basename(p) for p in
                                   glob.glob(journal + "*")),
           "spans_by_rank": ranks, "launcher_s": launched_s,
           "stdout": run.stdout.strip().splitlines()[-1:],
           "card": card()}
    print(json.dumps(res), flush=True)
    shutil.rmtree(tmp)
    return 0 if res["ok"] and not res["journals_left"] else 1


if __name__ == "__main__":
    sys.exit(main())
