#!/usr/bin/env python3
"""The benchmark of binary_image_compression_tpu_torch on one or more cards.

    python3 benchmark/run.py --workload <config>.<traffic> --seed <n>
        --seconds <s> --trace <0|1>

Run from the root of a checkout.  Prints, as the last line of standard
output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device`` (with ``busy_s`` and ``window_s`` when
traced), ``breakdown`` when traced, ``card`` (nvidia-smi's name, power
limit and SM clock), ``set_up`` (its parts, and whether this run built
the program's kernels) and, last, ``checks``: every number that decides
``correct`` beside its limit, which also close standard error.

It exits non-zero, printing no result, where CUDA is missing or has fewer
cards than the cell asks for, and where a module of JAX or of the JAX
package is loaded once the window has closed.  The program's kernel and
native builds stay in ``build/`` inside the checkout.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(BENCH)
os.environ["TRITON_CACHE_DIR"] = os.path.join(REPO, "build", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(REPO, "build",
                                                  "torch_extensions")
sys.path[:0] = [BENCH, REPO]

FORBIDDEN = {"jax", "jaxlib", "flax", "binary_image_compression_tpu"}


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from core import harness
    from core.cell import find_cell

    cell = find_cell(args.workload)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); torch "
              f"sees {cards}", file=sys.stderr)
        return 3
    result, lines = harness.run(cell, args.seed, args.seconds,
                                bool(args.trace), device="cuda",
                                t_start=T_START)
    bad = forbidden_modules()
    if bad:
        print(f"loaded after the window: {', '.join(bad)}", file=sys.stderr)
        return 4
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
