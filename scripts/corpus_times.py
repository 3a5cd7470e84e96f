"""Time the port's corpus encode on one card, for A/B runs of two checkouts.

    python3 scripts/corpus_times.py [--repo DIR] [--reps N]

Imports ``binary_image_compression_tpu_torch`` from the checkout DIR (this
one by default), then times, after one warm-up call each, N calls of:
  * ``archive.encode_archive`` of 64 pages of doc512 rolled by
    ``np.random.RandomState(0)`` (chip_smoke's corpus), W=16, R=128, batch
    32, journal on (host clock);
  * ``compress.encode_batch`` of the first 32 of them (host clock);
  * ``compress.encode_analyze_decided`` on their uploaded words, the device
    part of a batch (CUDA events).
Prints the card's name and power limit and one JSON line with every time,
in ms.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=HERE)
    ap.add_argument("--reps", type=int, default=5)
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("corpus_times: torch.cuda is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(a.repo))
    from binary_image_compression_tpu_torch.models import (archive, codec,
                                                           compress)
    from binary_image_compression_tpu_torch.utils import pnm

    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    doc = pnm.read_pbm(os.path.join(HERE, "tests", "fixtures", "doc512.pbm"))
    rng = np.random.RandomState(0)
    corpus = [np.roll(doc, (int(rng.randint(512)), int(rng.randint(512))),
                      axis=(0, 1)) for _ in range(64)]
    p = codec.CodecParams(codec=8, W=16, R=128, strict=False)
    pages = np.stack(corpus[:32])
    dev = torch.device("cuda", 0)
    words = compress._upload(pages, 16, dev)
    kw = dict(W=16, R=128, T_thresh=p.resolved_T(), rows=512, cols=512)

    def host_ms(fn):
        fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(a.reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    def device_ms(fn):
        fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(a.reps):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            torch.cuda.synchronize()
            out.append(s.elapsed_time(e))
        return out

    with tempfile.TemporaryDirectory() as tmp:
        journal = os.path.join(tmp, "corpus.journal")
        corpus_ms = host_ms(lambda: archive.encode_archive(
            corpus, p, batch_size=32, device="cuda", checkpoint=journal))
    batch_ms = host_ms(lambda: compress.encode_batch(pages, p,
                                                     device="cuda"))
    analysis_ms = device_ms(lambda: compress.encode_analyze_decided(words,
                                                                    **kw))
    print(gpu)
    print(json.dumps(dict(repo=os.path.abspath(a.repo),
                          corpus_ms=corpus_ms, batch32_ms=batch_ms,
                          analysis32_ms=analysis_ms)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
