"""Command line of the PyTorch/CUDA port (codec 8, causal and strict mode).

Counterpart of ``binary_image_compression_tpu/cli.py`` for the commands the
port covers:

    python -m binary_image_compression_tpu_torch compress   in.pbm out.bic
    python -m binary_image_compression_tpu_torch decompress in.bic out.pbm
    python -m binary_image_compression_tpu_torch archive    a.pbm b.pbm out.bica
    python -m binary_image_compression_tpu_torch extract    in.bica out.pbm --page 0

``--device`` defaults to ``cuda``; ``--device cpu`` runs the plain PyTorch
versions of the kernels.  ``--mode strict`` encodes with the residual-
substitution kernel K3 (archives: the native host encoder per page).  Other
codecs exit with the ROADMAP item that will port them.
"""

from __future__ import annotations

import argparse
import os
import sys


def _params(args):
    from .models import codec
    if args.codec != 8:
        sys.exit(f"codec {args.codec} is not ported yet: codecs 4/7 are "
                 "ROADMAP.md Queue 1 item 12, codec 13 item 7; use the JAX "
                 "package (python -m binary_image_compression_tpu)")
    return codec.CodecParams(codec=8, W=args.W, T=args.T, R=args.R,
                             strict=args.mode == "strict")


def _add_codec_opts(p):
    p.add_argument("--codec", type=int, default=8, help="codec id (8 only)")
    p.add_argument("-W", type=int, default=16, help="tile width")
    p.add_argument("-T", type=int, default=None, help="early-exit threshold")
    p.add_argument("-R", type=int, default=128, help="search radius")
    p.add_argument("--mode", choices=["strict", "causal"], default="causal")
    p.add_argument("--device", default="cuda",
                   help="torch device for the analysis: cuda (default) or cpu")


def cmd_compress(args):
    from .models import compress
    from .utils import pnm
    if os.path.splitext(args.input)[1].lower() != ".pbm":
        sys.exit("grayscale and color input are not ported yet "
                 "(ROADMAP.md Queue 1 item 8)")
    params = _params(args)
    img = pnm.read_pbm(args.input)
    encode = compress.encode_strict if params.strict else compress.encode
    blob = encode(img, params, device=args.device)
    with open(args.output, "wb") as f:
        f.write(blob)
    raw = img.size // 8
    print(f"{args.input}: {raw}B raw -> {len(blob)}B "
          f"({100.0 * len(blob) / raw:.2f}%)")


def cmd_decompress(args):
    from .models import codec
    from .utils import pnm
    with open(args.input, "rb") as f:
        blob = f.read()
    pnm.write_pbm(codec.decode(blob), args.output)
    print(f"wrote {args.output}")


def cmd_archive(args):
    from .models import archive
    from .utils import pnm
    params = _params(args)
    pages = [pnm.read_pbm(f) for f in args.inputs]
    blob = archive.encode_archive(pages, params, batch_size=args.batch_size,
                                  device=args.device,
                                  checkpoint=args.checkpoint)
    with open(args.output, "wb") as f:
        f.write(blob)
    raw = sum(p.size // 8 for p in pages)
    print(f"{len(pages)} pages: {raw}B raw -> {len(blob)}B "
          f"({100.0 * len(blob) / raw:.2f}%)")


def cmd_extract(args):
    from .models import archive
    from .utils import pnm
    with open(args.input, "rb") as f:
        blob = f.read()
    try:
        page = archive.decode_page(blob, args.page)
    except IndexError:
        sys.exit(f"error: page {args.page} out of range "
                 f"(archive has {archive.page_count(blob)} pages)")
    pnm.write_pbm(page, args.output)
    print(f"wrote page {args.page} -> {args.output}")


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m binary_image_compression_tpu_torch",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("compress", help="PBM -> .bic (codec 8)")
    p.add_argument("input")
    p.add_argument("output")
    _add_codec_opts(p)
    p.set_defaults(fn=cmd_compress)

    p = sub.add_parser("decompress", help=".bic -> PBM (codecs 4/6/7/8)")
    p.add_argument("input")
    p.add_argument("output")
    p.set_defaults(fn=cmd_decompress)

    p = sub.add_parser("archive", help="many PBMs -> one .bica corpus")
    p.add_argument("inputs", nargs="+")
    p.add_argument("output")
    _add_codec_opts(p)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--checkpoint", default=None,
                   help="journal path for a resumable encode")
    p.set_defaults(fn=cmd_archive)

    p = sub.add_parser("extract", help="page from a .bica corpus")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--page", type=int, default=0)
    p.set_defaults(fn=cmd_extract)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
