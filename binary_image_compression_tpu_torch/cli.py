"""Command line of the PyTorch/CUDA port: every codec of the JAX package,
grayscale and color, BSVD learning, the reference's estimates.

Counterpart of ``binary_image_compression_tpu/cli.py``:

    python -m binary_image_compression_tpu_torch compress   in.pbm out.bic
    python -m binary_image_compression_tpu_torch decompress in.bic out.pbm
    python -m binary_image_compression_tpu_torch estimate   in.pbm --driver 8
    python -m binary_image_compression_tpu_torch compare    in.pbm
    python -m binary_image_compression_tpu_torch info       in.bic
    python -m binary_image_compression_tpu_torch archive    a.pbm b.pbm out.bica
    torchrun --nproc-per-node 4 -m binary_image_compression_tpu_torch archive a.pbm ... out.bica
    python -m binary_image_compression_tpu_torch extract    in.bica out.pbm --page 0
    python -m binary_image_compression_tpu_torch bsvd       in.pbm [bsvd_test flags]
    python -m binary_image_compression_tpu_torch bitplanes  in.pgm
    python -m binary_image_compression_tpu_torch planes2pgm plane_ out.pgm

``--device`` defaults to ``cuda``; ``--device cpu`` runs the plain PyTorch
versions of the kernels.  ``compress`` routes as JAX's CLI does: codec 8
in causal mode goes to the device encoder (``--profile`` prints its
stages; ``--spans FILE``, on ``compress`` and ``archive``, writes the
encoders' spans and counters), ``--mode strict`` to the
residual-substitution kernel K3, codec 13 to its device context map with
the entropy coder on the host (``--entropy host``, the default) or on
the device (``--entropy device``: static table and interleaved rANS,
kernel K7), and every other codec (1, 2, 3, 4, 6, 7, 10, 11, 12) to
``codec.encode`` on the host (codec 11
learns on ``--device``; codecs 4 and 7 reach the device encoder through
the API, ``compress.encode``).  ``--codec auto`` keeps the smaller of codec
13 (host entropy) and codec 8, and ignores ``--shard``, as JAX's CLI
does.  ``compress --shard tiles`` splits one
page's tile rows over the ranks of a ``torch.distributed`` world (causal
codecs 4/7/8; run it under ``torchrun --nproc-per-node N``, or alone as a
world of 1; rank 0 writes the output).  Archives take every codec (causal
codec 8 batched on the device, the rest page by page through
``codec.encode``); under torchrun ``archive`` splits the pages over the
ranks, one card each, and writes one file: each rank's journal is
``<checkpoint>.rank<r>``, fsynced a batch, and removed only once rank 0
has fsynced the archive.  ``compress`` also takes .pgm/.pnm input, coded plane
by plane into a BICG stream, and .ppm, into a BICC stream
(``decompress`` writes them back): with no codec flag, each plane takes
the smaller
of codec 13 and codec 10 on the host; explicit flags (JAX's rule: any of
--codec, -W, -T, -R, --mode off its default) code every plane with them,
``--codec 10`` with the MED on the device and the native EG runs; and
``--entropy device`` codes the whole stack with codec 13 mode 2 on the
device.  ``estimate`` prints the reference drivers' codelength reports
(``models/ref_parity``), ``compare`` every codec's size and round trip,
``info`` a container's header.  ``bsvd`` runs bsvd_test on the device
(``--backend device``, the default; JAX's ``--backend tpu``) or as the
rand48 reference replay (``--backend ref``, ``models/bsvd_ref``, JAX's
default).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import struct
import sys

import numpy as np

# bsvd_test's -i catalog (bsvd.cpp:25-31); 3 (xor centroids) has no device
# twin and takes the majority-vote centroids, as in the JAX CLI
BSVD_INITS = {0: "neighbor", 1: "partition", 2: "random_centroids",
              3: "random_centroids", 4: "graph_grow"}


def _params(args):
    from .models import codec
    cid = int(args.codec) if args.codec.isdigit() else None
    if cid not in codec.VALID_CODECS:
        sys.exit(f"{args.cmd} --codec {args.codec}: unknown codec; valid: "
                 f"{codec.VALID_CODECS}, or auto (compress)")
    return codec.CodecParams(codec=cid, W=args.W, T=args.T, R=args.R,
                             strict=args.mode == "strict")


def _add_codec_opts(p):
    p.add_argument("--codec", default="8",
                   help="1 full-prior-area, 2/3 dict, 4/6/7/8 windowed, "
                        "10 med+rle, 11 bsvd, 12 cabic/arithmetic, 13 "
                        "scab striped-arithmetic, or auto: the smaller of "
                        "codec 13 and codec 8 (default 8)")
    p.add_argument("-W", type=int, default=16, help="tile width")
    p.add_argument("-T", type=int, default=None, help="early-exit threshold")
    p.add_argument("-R", type=int, default=128, help="search radius")
    p.add_argument("--mode", choices=["strict", "causal"], default="causal")
    p.add_argument("--device", default="cuda",
                   help="torch device for the analysis: cuda (default) or cpu")
    p.add_argument("--entropy", choices=["host", "device"], default="host",
                   help="codec 13 only: host = adaptive range coder "
                        "(payload mode 1), device = static table and "
                        "interleaved rANS built on the device (mode 2; for "
                        "PGM/PPM input every plane, whatever the codec)")
    p.add_argument("--profile", action="store_true",
                   help="codec 8, causal, or --shard tiles: print the "
                        "encoder's stages (wall clock and MB/s)")
    p.add_argument("--spans", metavar="FILE", default=None,
                   help="record the encoders' spans and counters "
                        "(utils/profiling) and write them to FILE, one "
                        "JSON object a line")


def _encode8(img, params, device, profile=None):
    from .models import compress
    if params.strict:
        return compress.encode_strict(img, params, device=device)
    return compress.encode(img, params, device=device, profile=profile)


def cmd_compress(args):
    from .models import codec, compress
    from .utils import pnm
    ext = os.path.splitext(args.input)[1].lower()
    if ext in (".pgm", ".pnm", ".ppm"):
        return _compress_gray(args, ext)
    if ext != ".pbm":
        sys.exit(f"{args.input}: compress takes .pbm, .pgm, .pnm or .ppm")
    img = pnm.read_pbm(args.input)
    if args.codec == "auto":
        # the smaller of codec 13 (host entropy) and codec 8, whatever
        # --shard says (JAX cli.py:58-59, :127)
        p13 = codec.CodecParams(codec=13, W=0, T=0, R=0)
        p8 = codec.CodecParams(codec=8, W=args.W, R=args.R,
                               strict=args.mode == "strict")
        blob = min((compress.encode_scab(img, p13, device=args.device),
                    _encode8(img, p8, args.device)), key=len)
    elif args.shard == "tiles":
        return _compress_tile_sharded(args, img)
    else:
        params = _params(args)
        if params.codec == 13:
            blob = compress.encode_scab(img, params, entropy=args.entropy,
                                        device=args.device)
        elif params.codec == 8:
            prof = None
            if args.profile and not params.strict:
                from .utils.profiling import PipelineProfile
                prof = PipelineProfile()
            blob = _encode8(img, params, args.device, prof)
            if prof is not None:
                print(prof.report())
        else:
            blob = codec.encode(img, params, device=args.device)
    _write(args, blob, img.size // 8, f", codec {blob[8]}")


def _compress_tile_sharded(args, img):
    """--shard tiles (JAX cli.py:86-95): the page's tile rows over every
    rank of the world (torchrun's, the BIC_* variables', or this process
    alone); NCCL for a CUDA --device, gloo for the CPU, unless
    BIC_DIST_BACKEND says otherwise.  Rank 0 writes the output."""
    import torch
    import torch.distributed as dist

    from .parallel import mesh as pmesh
    from .parallel import multihost, tileshard
    params = _params(args)
    if params.codec not in (4, 7, 8) or params.strict:
        sys.exit("--shard tiles requires a windowed codec (4/7/8) in causal "
                 "mode")
    owned = not dist.is_initialized()
    if not multihost.init_distributed(device=args.device):
        multihost.init_single_process(device=args.device)
    try:
        dev = args.device
        if dist.get_backend() == "nccl":
            dev = torch.device("cuda", torch.cuda.current_device())
        n = dist.get_world_size()
        m = pmesh.make_mesh(n, data=n, model=1)
        prof = None
        if args.profile:
            from .utils.profiling import PipelineProfile
            prof = PipelineProfile()
        blob = tileshard.encode_tile_sharded(m, img, params, device=dev,
                                             profile=prof)
    finally:
        if owned:
            dist.destroy_process_group()
    if blob is not None:
        if prof is not None:
            print(prof.report())
        _write(args, blob, img.size // 8,
               f", codec {blob[8]}, {n} tile shards")


def _compress_gray(args, ext):
    """A PGM or PPM, plane by plane (JAX cli.py:54-85): no codec flag, the
    per-plane best of codecs 13 and 10 on the host; explicit flags, every
    plane with them (codec 10 with the MED on the device); --entropy
    device, codec 13 mode 2 on the device for the whole stack."""
    from .models import codec
    from .utils import pnm
    if args.codec == "auto":
        sys.exit("--codec auto takes PBM input")
    explicit = (args.codec != "8" or args.W != 16 or args.T is not None
                or args.R != 128 or args.mode != "causal")
    params = _params(args) if explicit else None
    if args.entropy == "device":
        backend = "device-rans"
    elif params is not None and params.codec == 10:
        backend = "device"
    else:
        backend = "host"
    img, maxval = pnm.read_pnm(args.input)
    if ext == ".ppm":
        blob = codec.encode_ppm(img, maxval, params, backend=backend,
                                device=args.device)
        raw = img.size * 3
    else:
        blob = codec.encode_pgm(img, maxval, params, backend=backend,
                                device=args.device)
        raw = img.size * (2 if maxval > 255 else 1)
    _write(args, blob, raw, "")


def _write(args, blob: bytes, raw: int, what: str) -> None:
    with open(args.output, "wb") as f:
        f.write(blob)
    print(f"{args.input}: {raw}B raw -> {len(blob)}B "
          f"({100.0 * len(blob) / raw:.2f}%{what})")


def cmd_decompress(args):
    from .models import codec
    from .utils import pnm
    with open(args.input, "rb") as f:
        blob = f.read()
    if blob[:4] == codec.PPM_MAGIC:
        rgb, maxval = codec.decode_ppm(blob)
        pnm.write_ppm(rgb, maxval, args.output)
    elif blob[:4] == codec.PGM_MAGIC:
        gray, maxval = codec.decode_pgm(blob)
        pnm.write_pgm(gray, maxval, args.output)
    else:
        pnm.write_pbm(codec.decode(blob), args.output)
    print(f"wrote {args.output}")


def cmd_estimate(args):
    """The reference drivers' codelength reports (compress_test ..
    compress8_test), from ``models/ref_parity``, printed as JAX's CLI
    prints them."""
    from .models import ref_parity as rp
    from .utils import pnm
    img = pnm.read_pbm(args.input)
    fns = {1: rp.compress1, 2: rp.compress2, 3: rp.compress3,
           4: rp.compress4, 5: rp.compress5, 6: rp.compress6,
           7: rp.compress7, 8: rp.compress8}
    kw = {}
    if args.driver >= 3 and args.T is not None:
        kw["T"] = args.T
    if args.driver >= 4:
        kw["R"] = args.R
    out = fns[args.driver](img, W=args.W, **kw)
    f = out["final"]
    skip = ("map", "hist_weight", "hist_besti", "hist_bestj", "hist_radius")
    print(json.dumps({k: v for k, v in f.items() if k not in skip},
                     indent=1, default=str))
    if "map" in f:
        print("MAP:")
        for line in f["map"]:
            print(line)
    if "hist_weight" in f:
        # the reference's ASCII histograms (compress4_test.cpp:41-50)
        for name, log in (("hist_weight", True), ("hist_besti", False),
                          ("hist_bestj", False), ("hist_radius", False)):
            print(f"{name.upper()}:")
            for i, h in enumerate(f[name]):
                top = int(math.ceil(math.log2(h + 1.0))) if log else h
                print(f"{i}:" + "#" * top)


# (codec, label) of the compare table (JAX cli.py:282-305)
COMPARE_CODECS = ((2, "dict"), (3, "dict+T"), (4, "window"),
                  (7, "window+pred"), (8, "window+pred+inv"),
                  (10, "med+rle"), (12, "cabic/arithmetic"),
                  (13, "scab/striped-arith"))


def cmd_compare(args):
    """Each codec's size on one page, causal mode, and whether its stream
    decodes to the page; a codec that raises shows its error in the last
    column, as in JAX's CLI."""
    from .models import codec
    from .utils import pnm
    img = pnm.read_pbm(args.input)
    raw = img.size // 8
    rows = [("raw", raw, None)]
    for cid, label in COMPARE_CODECS:
        p = codec.CodecParams(codec=cid, W=args.W if cid < 10 else 0,
                              R=args.R, T=0 if cid >= 12 else None,
                              strict=False)
        try:
            blob = codec.encode(img, p)
            ok = bool((codec.decode(blob) == img).all())
            rows.append((f"codec {cid} ({label})", len(blob), ok))
        except Exception as e:
            rows.append((f"codec {cid} ({label})", None, str(e)[:40]))
    w = max(len(r[0]) for r in rows)
    for name, size, ok in rows:
        pct = f"{100.0 * size / raw:6.1f}%" if size else "   n/a"
        tail = "" if ok in (None, True) else f"  [{ok}]"
        print(f"{name:<{w}}  {size or 0:>8}B  {pct}{tail}")


def cmd_info(args):
    """The header of a BIC1 stream, a BICG container or a BICA archive as
    one JSON line (JAX cli.py:336-358)."""
    from .models import archive, codec
    with open(args.input, "rb") as f:
        blob = f.read()
    if blob[:4] == archive.MAGIC:
        print(json.dumps({"container": "BICA",
                          "pages": archive.page_count(blob),
                          "bytes": len(blob)}))
        return
    if blob[:4] == codec.PGM_MAGIC:
        nplanes, gflag, maxval = struct.unpack("<BBH", blob[4:8])
        print(json.dumps({"container": "BICG", "planes": nplanes,
                          "gray_code": bool(gflag), "maxval": maxval,
                          "bytes": len(blob)}))
        return
    if blob[:4] != codec.MAGIC:
        sys.exit("not a BIC stream")
    crc, cid, flags, W, rows, cols, T, R = struct.unpack(
        "<IBBHIIII", blob[4:codec.HEADER_LEN])
    print(json.dumps({"container": "BIC1", "codec": cid,
                      "mode": "strict" if flags & 1 else "causal",
                      "W": W, "rows": rows, "cols": cols, "T": T, "R": R,
                      "bytes": len(blob),
                      "raw_bytes": rows * cols // 8}))


def cmd_archive(args):
    """One BICA file of the inputs.  Alone, ``archive.encode_archive`` on
    --device; under torchrun (or in a world already up), every rank reads
    the inputs and ``multihost.encode_archive_sharded`` archives its page
    range on its own card, each rank with its journal
    ``<checkpoint>.rank<r>``, into the one output file; rank 0 prints."""
    import torch.distributed as dist

    from .models import archive
    from .parallel import multihost
    from .utils import pnm
    params = _params(args)
    pages = [pnm.read_pbm(f) for f in args.inputs]
    raw = sum(p.size // 8 for p in pages)
    owned = not dist.is_initialized()
    if multihost.init_distributed(device=args.device):
        try:
            _archive_sharded(args, params, pages, raw)
        finally:
            if owned:
                dist.destroy_process_group()
        return
    blob = archive.encode_archive(pages, params, batch_size=args.batch_size,
                                  device=args.device,
                                  checkpoint=args.checkpoint)
    with open(args.output, "wb") as f:
        f.write(blob)
    print(f"{len(pages)} pages: {raw}B raw -> {len(blob)}B "
          f"({100.0 * len(blob) / raw:.2f}%)")


def _archive_sharded(args, params, pages, raw):
    import torch
    import torch.distributed as dist

    from .parallel import multihost
    dev = args.device
    if dist.get_backend() == "nccl":
        dev = torch.device("cuda", torch.cuda.current_device())
    multihost.encode_archive_sharded(pages, params,
                                     batch_size=args.batch_size, device=dev,
                                     checkpoint=args.checkpoint,
                                     output=args.output)
    if dist.get_rank() == 0:
        size = os.path.getsize(args.output)
        print(f"{len(pages)} pages: {raw}B raw -> {size}B "
              f"({100.0 * size / raw:.2f}%), {dist.get_world_size()} ranks")


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


def cmd_bsvd(args):
    """bsvd_test: learn (D, A) for X on the device (``--backend device``)
    or by the reference replay (``--backend ref``), write the three PBMs
    (and the mosaics) to --out-dir."""
    from .utils import pnm
    img = pnm.read_pbm(args.input)
    if args.backend == "ref":
        D, A, E, wE = _bsvd_ref(args, img)
    else:
        D, A, E = _bsvd_device(args, img)
        wE = int(E.sum())
    _write_bsvd_outputs(args, D, A, E, wE)


def _bsvd_ref(args, img):
    """The rand48 replay of bsvd.cpp (JAX cli.py:234-246): the MDL
    selection loops for -l 4 (forward) and -l >= 5 (backward), else
    bsvd_test's loops."""
    from .models import bsvd_ref
    if args.l >= 4:
        out = bsvd_ref.run_mdl(
            img, W=args.w, K0=max(1, args.k // 8), image_mode=bool(args.I),
            mi=args.i, cu=args.c, du=args.d, lmi=args.L,
            direction="forward" if args.l == 4 else "backward", seed=args.r)
        return out["D"], out["A"], out["E"], int(out["E"].sum())
    D, A, E, wE, _ = bsvd_ref.run_bsvd_test(
        img, W=args.w, K=args.k, image_mode=bool(args.I), mi=args.i,
        cu=args.c, du=args.d, lm=args.l, seed=args.r)
    return D, A, E, wE


def _bsvd_device(args, img):
    import torch

    from .models import bsvd
    from .ops._cuda import resolve_device
    dev = resolve_device(args.device)
    X = (bsvd.patchify_to_rows(torch.from_numpy(img), args.w) if args.I
         else torch.from_numpy(img.astype(np.int8))).to(dev)
    init = BSVD_INITS.get(args.i, "neighbor")
    du = "proximus" if args.d in (1, 3) else "steepest"
    if args.l == 4:  # MDL forward selection (bsvd.cpp:1463-1546)
        E, D, A, _ = bsvd.learn_mdl_forward(
            X, K0=max(1, args.k // 8), max_k=args.k, init=init,
            dict_update=du, seed=args.r)
    elif args.l in (1, 2, 3):  # role-switching loops
        E, D, A, _ = bsvd.learn_alter(X, K=args.k, init=init, variant=args.l,
                                      dict_update=du, seed=args.r)
    elif args.l == 5:  # MDL backward selection (bsvd.cpp:1548-1663)
        E, D, A, _ = bsvd.learn_mdl_backward(X, K0=args.k, init=init,
                                             dict_update=du, seed=args.r)
    elif args.l >= 6:  # MDL full search (bsvd.cpp:1665-1717)
        E, D, A, _ = bsvd.learn_mdl_full(
            X, Kmax=args.k, Kstep=max(1, args.k // 2), init=init,
            dict_update=du, seed=args.r)
    else:
        E, D, A, _ = bsvd.learn(X, K=args.k, init=init, dict_update=du,
                                seed=args.r)
    E, D, A = (x.astype(bool) for x in bsvd.state_to_numpy(E, D, A))
    return D, A, E


def _write_bsvd_outputs(args, D, A, E, wE: int) -> None:
    from .ops import bitpack
    from .utils import mosaic, pnm
    out = args.out_dir
    pnm.write_pbm(D, os.path.join(out, "dictionary.pbm"))
    pnm.write_pbm(A, os.path.join(out, "coefficients.pbm"))
    pnm.write_pbm(E, os.path.join(out, "residual.pbm"))
    if args.m:
        mos = mosaic.render_mosaic(bitpack.np_pack(D), D.shape[1])
        pnm.write_pbm(mos, os.path.join(out, "atoms_mosaic.pbm"))
    if args.M:
        mos = mosaic.render_mosaic(bitpack.np_pack(E), E.shape[1])
        pnm.write_pbm(mos, os.path.join(out, "residual_mosaic.pbm"))
    print(f"|E| = {wE}  (K={D.shape[0]}, M={D.shape[1]}, N={A.shape[0]})")


def cmd_bitplanes(args):
    """A PGM -> one PBM per bitplane, <prefix>NN.pbm (bitplane_tool)."""
    from .utils import bitplanes, pnm
    gray, maxval = pnm.read_pnm(args.input)
    planes = bitplanes.decompose(gray, maxval)
    for i in range(planes.shape[0]):
        pnm.write_pbm(planes[i], f"{args.prefix}{i:02d}.pbm")
    print(f"wrote {planes.shape[0]} planes ({args.prefix}NN.pbm)")


def cmd_planes2pgm(args):
    """<prefix>00.pbm, 01, ... -> one PGM (plane2pgm_tool), maxval the
    final mask (plane2pgm_tool.cpp:53)."""
    from .utils import bitplanes, pnm
    planes = []
    while os.path.exists(f"{args.prefix}{len(planes):02d}.pbm"):
        planes.append(pnm.read_pbm(f"{args.prefix}{len(planes):02d}.pbm"))
    if not planes:
        sys.exit(f"no {args.prefix}NN.pbm files found")
    gray = bitplanes.recompose(np.stack(planes))
    pnm.write_pgm(gray, (1 << len(planes)) - 1, args.output)
    print(f"wrote {args.output} from {len(planes)} planes")


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m binary_image_compression_tpu_torch",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("compress", help="PBM/PGM/PPM -> .bic")
    p.add_argument("input")
    p.add_argument("output")
    _add_codec_opts(p)
    p.add_argument("--shard", choices=["none", "tiles"], default="none",
                   help="tiles: split the page's tile rows over the ranks "
                        "of a torch.distributed world (run under torchrun "
                        "--nproc-per-node N, or alone as a world of 1; "
                        "codecs 4/7/8, causal; byte-identical streams)")
    p.set_defaults(fn=cmd_compress)

    p = sub.add_parser("decompress", help=".bic -> PBM/PGM/PPM")
    p.add_argument("input")
    p.add_argument("output")
    p.set_defaults(fn=cmd_decompress)

    p = sub.add_parser("estimate",
                       help="reference-parity codelength report")
    p.add_argument("input")
    p.add_argument("--driver", type=int, default=8, choices=range(1, 9))
    p.add_argument("-W", type=int, default=16)
    p.add_argument("-T", type=int, default=None)
    p.add_argument("-R", type=int, default=128)
    p.set_defaults(fn=cmd_estimate)

    p = sub.add_parser("compare", help="size comparison across codecs")
    p.add_argument("input")
    p.add_argument("-W", type=int, default=16)
    p.add_argument("-R", type=int, default=128)
    p.set_defaults(fn=cmd_compare)

    p = sub.add_parser("info", help="inspect a .bic container")
    p.add_argument("input")
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser(
        "archive", help="many PBMs -> one .bica corpus (under torchrun "
                        "--nproc-per-node N: the pages split over N cards)",
        description="Many PBMs -> one .bica corpus.  Under torchrun "
                    "--nproc-per-node N each rank archives its range of "
                    "the pages on its own card into the one output file; "
                    "each rank keeps its own journal, <checkpoint>.rank<r>, "
                    "and removes it only after rank 0 has fsynced the "
                    "archive.")
    p.add_argument("inputs", nargs="+")
    p.add_argument("output")
    _add_codec_opts(p)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--checkpoint", default=None,
                   help="journal path for a resumable encode (under "
                        "torchrun: one journal a rank, <path>.rank<r>)")
    p.set_defaults(fn=cmd_archive)

    p = sub.add_parser("extract", help="page from a .bica corpus")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--page", type=int, default=0)
    p.set_defaults(fn=cmd_extract)

    p = sub.add_parser("bsvd", help="binary dictionary learning "
                                    "(bsvd_test flags)")
    p.add_argument("input")
    p.add_argument("-i", type=int, default=0, help="initializer 0-4")
    p.add_argument("-c", type=int, default=0,
                   help="coef update 0-1 (reference replay only)")
    p.add_argument("-d", type=int, default=0, help="dict update 0-3")
    p.add_argument("-l", type=int, default=0, help="learning loop 0-6")
    p.add_argument("-L", type=int, default=0,
                   help="inner loop (MDL, reference replay only)")
    p.add_argument("-w", type=int, default=16, help="patch width")
    p.add_argument("-k", type=int, default=512, help="dictionary size")
    p.add_argument("-r", type=int, default=34503498, help="random seed")
    p.add_argument("-I", type=int, default=0, help="image mode (patchify)")
    p.add_argument("-m", type=int, default=1, help="write atoms mosaic")
    p.add_argument("-M", type=int, default=1, help="write residual mosaic")
    p.add_argument("--out-dir", default=".")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    p.add_argument("--backend", choices=["device", "ref"], default="device",
                   help="device: learn on --device; ref: the reference's "
                        "rand48 replay on the host (bsvd_test's outputs)")
    p.set_defaults(fn=cmd_bsvd)

    p = sub.add_parser("bitplanes", help="PGM -> plane_NN.pbm")
    p.add_argument("input")
    p.add_argument("--prefix", default="plane_")
    p.set_defaults(fn=cmd_bitplanes)

    p = sub.add_parser("planes2pgm", help="plane_NN.pbm -> PGM")
    p.add_argument("prefix")
    p.add_argument("output")
    p.set_defaults(fn=cmd_planes2pgm)

    args = ap.parse_args(argv)
    if getattr(args, "spans", None):
        return _with_spans(args)
    args.fn(args)


def _with_spans(args):
    """Run the command with the recorder on, then write what it kept to
    ``--spans`` as JSON lines (``profiling.write_jsonl``); under torchrun
    with more than one rank, rank r writes ``<FILE>.rank<r>``."""
    from .utils import profiling
    profiling.record(True)
    try:
        args.fn(args)
    finally:
        profiling.record(False)
        path = args.spans
        if int(os.environ.get("WORLD_SIZE", "1")) > 1:
            path += f".rank{os.environ.get('RANK', '0')}"
        profiling.write_jsonl(path, *profiling.take())


if __name__ == "__main__":
    main()
