"""Time the port's W = 64 encode by stage on one card, for A/B runs of two
checkouts.

    python3 scripts/banded_times.py [--repo DIR] [--reps N]

Imports ``binary_image_compression_tpu_torch`` from the checkout DIR (this
one by default) and, after one warm-up call, times N calls of
``compress.encode`` of doc512 at W=64, R=128 (codec 8, T auto) by the host
clock.  Around the module functions every checkout's encode goes through,
synchronised timers split each call into stages:
  * upload: ``compress._upload``;
  * unpack: ``encode_analyze_decided`` less ``encode_analyze`` and
    ``decide_records``;
  * search: ``encode_analyze`` less ``finish_analysis`` (the banded maps
    and the map-reading K4 in a checkout that has them, K4's plane and
    search kernels in one that does not);
  * dense finish: ``finish_analysis``;
  * K2 (+records): ``decide_records``, K2 at M = 4096;
  * fetch and host: the rest of ``encode_batch`` besides ``pack_pages``;
  * native pack: ``pack_pages``.
The timers synchronise the card around each stage, so their sum is a little
above an untimed call.  Prints the card's name and power limit and one JSON
line with every time, in ms.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGES = ("_upload", "encode_analyze_decided", "encode_analyze",
          "finish_analysis", "decide_records", "pack_pages")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=HERE)
    ap.add_argument("--reps", type=int, default=5)
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("banded_times: torch.cuda is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(a.repo))
    from binary_image_compression_tpu_torch.models import codec, compress
    from binary_image_compression_tpu_torch.utils import pnm

    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    doc = pnm.read_pbm(os.path.join(HERE, "tests", "fixtures", "doc512.pbm"))
    p = codec.CodecParams(codec=8, W=64, R=128, strict=False)
    ms = dict.fromkeys(STAGES, 0.0)

    def timed(name, fn):
        def wrap(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn(*args, **kw)
            torch.cuda.synchronize()
            ms[name] += (time.perf_counter() - t0) * 1e3
            return r
        return wrap

    def encode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blob = compress.encode(doc, p, device="cuda")
        torch.cuda.synchronize()
        return blob, (time.perf_counter() - t0) * 1e3

    blob, _ = encode()
    plain = [encode()[1] for _ in range(a.reps)]
    orig = {n: getattr(compress, n) for n in STAGES}
    for n in STAGES:
        setattr(compress, n, timed(n, orig[n]))
    rows = []
    try:
        for _ in range(a.reps):
            for n in STAGES:
                ms[n] = 0.0
            total = encode()[1]
            rows.append(dict(
                total=total, upload=ms["_upload"],
                unpack=ms["encode_analyze_decided"] - ms["encode_analyze"]
                - ms["decide_records"],
                search=ms["encode_analyze"] - ms["finish_analysis"],
                finish=ms["finish_analysis"], k2=ms["decide_records"],
                fetch_host=total - ms["_upload"]
                - ms["encode_analyze_decided"] - ms["pack_pages"],
                pack=ms["pack_pages"]))
    finally:
        for n in STAGES:
            setattr(compress, n, orig[n])
    print(gpu)
    print(json.dumps(dict(repo=os.path.abspath(a.repo), bytes=len(blob),
                          encode_ms=plain,
                          stages_ms={k: [r[k] for r in rows]
                                     for k in rows[0]})))
    return 0


if __name__ == "__main__":
    sys.exit(main())
