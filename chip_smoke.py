"""End-to-end check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the native host library and the CUDA kernels from this checkout,
holds each kernel (K1's field plane and search, K2 decision, K3 strict
analysis, K4's 64-bit field plane and banded search, K5 packed distances,
K6 packed row weights, the BSVD pursuit kernel that fuses K5 and K6,
on planted inputs up to a letter page's 33,120 patches, and K7, codec 13's
interleaved-rANS encode, on random tables, the densest emission at 1, 33
and 255 lanes, three pages in one launch, every codec-13 case of the CPU
tests and a letter page, and on doc512 also against its stream-order
twin, and K8, codec 10's adaptive exp-Golomb coder, on residual planes
from empty to full, odd widths, both first-run cases, run counts at each
rung of the capacity ladder that sizes its plain version's run array, a
single one at the last pixel, ones only in the first and last words,
chunks of 512 ones, the whole stacks of the bench page, a letter page and
a noisy page, and a color page's 24 planes, and K9, codec 8's record pack,
on doc512's blocks at W = 16 and 8, a fax page, 32 fax pages in one
launch (also against native ``bic_pack_tiles``) and random blocks over
the fields' whole ranges) against its plain PyTorch version on the card,
then
drives the port's paths, each with
the launch counts reset just before it and read just after: the causal
encode (one 512x512 page, then a 64-page corpus through the archive
writer), strict mode (``encode_strict`` on a 512x512 and a 512x2048
page), the banded route (``encode`` of doc512 at W = 64 and W = 40 and of
a 3300x2550 letter page at W = 64, with a spy showing that no distance map
was built on the card) and BSVD
(codec 11 on one page, ``learn`` on both distance routes, the ``bsvd`` CLI
at K = 512, with a spy showing that each packed pursuit on the card was one
launch of the pursuit kernel, with no K5 or K6 launch and no host sync)
and codec 13 (``encode_scab`` in both entropy modes on doc512 and the
letter page, one K7 launch per device-entropy encode, with a spy showing
that the plain rANS loop ran on no CUDA tensor) and grayscale
(``encode_pgm`` of the JAX bench stack, a 3300x2550 8-bit letter page and
a noisy 512x512 page whose low plane is past the ladder, and
``encode_ppm`` of an RGB page, in each device backend: one K8 launch per
stack on "device-assembly" and none elsewhere, one K7 launch per stack on
"device-rans"; codec 10
== the host route byte for byte, the bench stack at 104,658 B with codec
10 and 76,918 B with rANS, every stream decoding to its page) and codecs
4 and 7 (``compress.encode`` of doc512 at W = 16, through K1, and W = 64,
through K4, with the complement trick off and no K2 launch: 16,986 /
17,094 and 22,367 / 22,375 B, with the encoder's stage profile), then the
host codecs 1, 2, 3, 6 and 12 at their pinned bytes and the CLI's
``compare`` and ``info`` as subprocesses, the L0 bitpack API (``l0_api``:
every name on the card == the same call on the CPU, exact, at K5's doc512
shape, [1024, 8] x [64, 8] words, and on 250-column rows with dirty
padding; ``dist_matrix`` launches K5 and ``row_weight``, ``weight``,
``gf2_sum``, ``row_sum`` and ``dist`` launch K6; the Gram pursuit and
``learn`` on the gram route == the packed route on doc512 at K = 64), and
multi-device
(``parallel/``): ``encode_tile_sharded`` of a 3300x2550 letter page at
W = 16 (K1) and W = 64 (K4, 720,310 B), of doc512's top 128 rows (R over
two shard blocks) and of a ragged page (a pad tile row), each == the
single-device ``compress.encode`` and the host encoder, at a world of 1 on
NCCL in this process (launches counted; then the CLI's ``--shard tiles``
as a subprocess) and at a world of 2 under gloo (two processes of this
script on the one card, ``--parallel-rank``, each with its own timeout),
where the ranks also hold the row-sharded MED of the letter page, the
sharded BSVD step at codec 11's shape (K = 64 and 512), the page-sharded
64-page corpus with its merged offsets and the offset scan against one
device; the letter page's sharded encode is timed by stage (halo, shard
analysis, gather, native assembly) at both worlds beside
``compress.encode``.  K1 and K4 are also held against their plain
versions on shard frames (tiles at frame row R, negative y_base: doc512 at
W = 16, R = 128 and R = 100, and W = 64 / 40 for K4, and a ragged page).
Codec 11 is held at JAX's 24,209 B.  K1 and K4 are also held
against their plain versions with the complement trick off on doc512
(W = 16 and W = 64), the shapes of codecs 4 and 7.  Every
codec-8 stream is checked byte for byte against the native host encoder,
the codec-11 stream and codec 13's device-entropy streams against the same
encode on the CPU, codec 13's host-entropy streams against the native coder's own
context scan, and each is round-tripped; stages and kernels are timed with CUDA
events (K1's, K2's, K3's and K4's kernels also by torch.profiler's device
times; the W = 16 and W = 64 encodes split into stages),
K7 also at 1, 8 and 32 pages a launch and in clocks a step, K9 at a fax
page and 32 fax pages beside the host's native pack, the
grayscale stages (MED, K8 kernel by kernel, the K7 stack, fetches) and
``encode_pgm`` end to end per backend,
and each kernel's time is printed beside its least time on the card
(``utils/roofline``) and, for K1's plane, K5 and K6, the one PyTorch call
that computes the same function; the pursuit kernel also beside the sweep
route it replaced (K5 and K6 once per sweep), per call and per learn.  K2's round counter is held against the
CPU model of its order of work, and K2 is timed beside its serial design
(``scripts/k2_serial.cu``, built beside the kernels).  Imports no JAX.

Any failure raises and exits non-zero; without CUDA it exits 1 at once.  The
last line of standard output is a JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(REPO, "tests", "fixtures")
RAW_DOC = 512 * 512 // 8
CORPUS_PAGES = 64
STAGE_BATCHES = (1, 32)


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps launches, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def host_ms(fn, reps: int) -> float:
    """Mean host wall time of fn() (synchronised) over reps calls."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def grid_of(pages: np.ndarray, W: int, dev) -> torch.Tensor:
    B, rows, cols = pages.shape
    ny, nx = -(-rows // W), -(-cols // W)
    g = np.zeros((B, ny * W, nx * W), dtype=bool)
    g[:, :rows, :cols] = pages
    return torch.from_numpy(g).to(dev)


def shard_frame(page: np.ndarray, W: int, base: int, blk: int,
                R: int) -> np.ndarray:
    """A tile shard's frame of one page, as ``parallel/tileshard`` searches
    it: the R rows above rows base..base+blk of the padded tile grid (zeros
    above the page), then those rows; [1, R + blk, nx*W]."""
    rows, cols = page.shape
    ny, nx = -(-rows // W), -(-cols // W)
    grid = np.zeros((max(ny * W, base + blk), nx * W), dtype=bool)
    grid[:rows, :cols] = page
    frame = np.zeros((1, R + blk, nx * W), dtype=bool)
    lo = max(base - R, 0)
    frame[0, R - (base - lo):] = grid[lo:base + blk]
    return frame


def check_shard_frames(name, cases, launch_plane, launch, plain_plane,
                       plain, dev) -> tuple[int, int]:
    """A kernel pair on shard frames (row0 = R, y_base = base - R, so
    negative for a top shard) == its plain versions, field for field."""
    worst = worst_plane = 0
    for what, page, W, R, base, blk in cases:
        frame = shard_frame(page, W, base, blk, R)
        img = torch.from_numpy(frame).to(dev)
        ny, nx = blk // W, frame.shape[2] // W
        He = R + blk               # a frame is never shorter than its bands
        E = launch_plane(img, W, He)
        plain_E = plain_plane(img, W, He, nx * W)
        kw = dict(W=W, R=R, T_thresh=2, cols=page.shape[1], invert=True,
                  y_base=base - R, row0=R)
        got = launch(E, ny, nx, **kw)
        want = plain(plain_E, ny, nx, **kw)
        torch.cuda.synchronize()
        err_p = int((E.to(torch.int64) - plain_E.to(torch.int64)).abs().max())
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        worst, worst_plane = max(worst, err), max(worst_plane, err_p)
        log(f"{name} shard frame, {what}: W={W} R={R} rows {base}.."
            f"{base + blk} (row0={R}, y_base={base - R}) T={ny * nx} plane "
            f"max_abs_err={err_p}, search max_abs_err={err} "
            f"found={int(got[..., 3].sum())}")
        if err != 0 or err_p != 0:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"on the shard frame {what}")
    return worst, worst_plane


def check_k1(fs, pnm, dev) -> tuple[int, int]:
    """K1's two kernels == their plain versions on the same CUDA tensors:
    the plane kernel == ``_field_plane``, the search == its plain version
    (W = 5 and 12 take the run-time-W instance; y_base != 0 moves masks and
    keys to absolute rows).  Returns the worst error of each."""
    doc = pnm.read_pbm(os.path.join(FIXTURES, "doc512.pbm"))
    rag = pnm.read_pbm(os.path.join(FIXTURES, "ragged75x101.pbm"))
    rnd = np.random.RandomState(7).rand(256, 320) < 0.3
    rs = np.random.RandomState(1)
    roll = lambda n: np.stack([np.roll(doc, (rs.randint(512), rs.randint(512)),
                                       axis=(0, 1)) for _ in range(n)])
    small = np.random.RandomState(3).rand(2, 96, 130) < 0.3
    # name, pages, W, R, invert, y_base
    cases = [("doc512", doc[None], 16, 128, True, 0),
             ("ragged75x101", rag[None], 8, 16, True, 0),
             ("ragged75x101 no-invert", rag[None], 8, 16, False, 0),
             ("doc512 no-invert (codecs 4/7)", doc[None], 16, 128, False, 0),
             ("random256x320 (64-bit priority)", rnd[None], 32, 192, True, 0),
             ("random96x130 x2 W=5", small, 5, 10, True, 0),
             ("random96x130 x2 W=12 y_base=24", small, 12, 36, True, 24),
             ("random96x130 x2 y_base=-16", small, 16, 48, True, -16),
             ("doc512 W=8 y_base=64", doc[None], 8, 64, True, 64),
             ("doc512 W=32", doc[None], 32, 96, True, 0),
             ("doc512 x4 batch", roll(4), 16, 128, True, 0),
             ("doc512 x32 batch", roll(32), 16, 128, True, 0)]
    worst = worst_plane = 0
    for name, pages, W, R, invert, y_base in cases:
        B, rows, cols = pages.shape
        ny, nx = -(-rows // W), -(-cols // W)
        img = grid_of(pages, W, dev)
        He = fs.plane_height(ny * W, W, R)
        E = fs._launch_plane(img, W, He)
        plain_E = fs.to_i32(fs._field_plane(img, W, He, nx * W))
        kw = dict(W=W, R=R, T_thresh=2, cols=cols, invert=invert,
                  y_base=y_base)
        got = fs._launch(E, ny, nx, **kw)
        want = fs.fused_search_select_plain(plain_E, ny, nx, **kw)
        torch.cuda.synchronize()
        err_p = int((E.to(torch.int64) - plain_E.to(torch.int64)).abs().max())
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        worst, worst_plane = max(worst, err), max(worst_plane, err_p)
        log(f"K1 {name}: W={W} R={R} B={B} T={ny * nx} y_base={y_base} "
            f"plane max_abs_err={err_p}, search max_abs_err={err} "
            f"found={int(got[..., 3].sum())}")
        if err != 0 or err_p != 0:
            raise AssertionError(f"K1 disagrees with its plain version on "
                                 f"{name}")
    # shard frames: what, page, W, R, first row, rows of the shard
    shards = [("doc512 top shard", doc, 16, 128, 0, 256),
              ("doc512 lower shard", doc, 16, 128, 256, 256),
              ("doc512, R not a multiple of W", doc, 16, 100, 64, 128),
              ("ragged75x101 top shard", rag, 8, 24, 0, 40)]
    e, ep = check_shard_frames(
        "K1", shards, fs._launch_plane, fs._launch,
        lambda img, W, He, We: fs.to_i32(fs._field_plane(img, W, He, We)),
        fs.fused_search_select_plain, dev)
    return max(worst, e), max(worst_plane, ep)


def adversarial_k2(M: int, T: int, B: int = 1):
    """K2's worst case: nomatch only, weights alternating M, 0, so k changes
    on every tile.  (weights4, has_cands, idx_len) int32 [B, T, ...]."""
    w4 = np.full((B, T, 4), M, dtype=np.int32)
    w4[..., 2] = w4[..., 3] = np.where(np.arange(T) % 2 == 0, M, 0)
    return w4, np.zeros((B, T), np.int32), np.ones((B, T), np.int32)


def doc512_k2(compress, pnm, W: int, dev):
    """doc512's K2 inputs from the port's analysis on the card."""
    doc = pnm.read_pbm(os.path.join(FIXTURES, "doc512.pbm"))
    out = compress.encode_analyze(torch.from_numpy(doc[None]).to(dev), W=W,
                                  R=128, T_thresh=1, rows=512, cols=512)
    return tuple(out[k].to(torch.int32).cpu().numpy()
                 for k in ("weights4", "has_cands", "idx_len"))


def check_k2(dc, compress, pnm, dev) -> int:
    """K2 == its plain version == the host replay, with each page's round
    count == the CPU model's (``decide.decide_rounds_model``): random
    weights at M = 256 and at M = 4096 (W = 64, an enb LUT of 4097 entries),
    the adversarial input (k changes on every tile) and doc512's own
    weights at W = 16 and 32."""
    rs = np.random.RandomState(11)
    cases = []
    for M, T in ((256, 1024), (256, 4096), (4096, 1024)):
        B = 2
        cases.append((f"random M={M} T={T}", M, (4, 7, 8), (
            rs.randint(0, M + 1, size=(B, T, 4)).astype(np.int32),
            (rs.rand(B, T) < 0.8).astype(np.int32),
            rs.randint(1, 12, size=(B, T)).astype(np.int32))))
    cases.append(("adversarial M=256 T=1024", 256, (4, 7, 8),
                  adversarial_k2(256, 1024, 2)))
    for W in (16, 32):
        cases.append((f"doc512 W={W}", W * W, (8,),
                      doc512_k2(compress, pnm, W, dev)))
    worst = 0
    for name, M, codecs, (w4, hc, il) in cases:
        enb_np = compress.enb_lut(M)
        enb = torch.from_numpy(enb_np).to(dev)
        tw4, thc, til = (torch.from_numpy(a).to(dev) for a in (w4, hc, il))
        B = w4.shape[0]
        for cid in codecs:
            rounds = torch.full((B,), -1, dtype=torch.int32, device=dev)
            got = torch.stack(dc._launch(tw4, thc, til, enb, codec_id=cid,
                                         rounds=rounds))
            want = torch.stack(dc.decide_modes_plain(tw4, thc, til, enb,
                                                     codec_id=cid))
            err = int((got.to(torch.int64) - want.to(torch.int64))
                      .abs().max())
            worst = max(worst, err)
            g = got.cpu().numpy()
            counts = []
            for b in range(B):
                host = compress._decide_modes(
                    dict(weights4=w4[b], has_cands=hc[b] != 0,
                         idx_len=il[b]), M, cid)
                model = dc.decide_rounds_model(w4[b], hc[b], il[b], enb_np,
                                               codec_id=cid)
                for k in range(3):
                    if not np.array_equal(g[k, b], host[k]):
                        raise AssertionError(
                            f"K2 != host replay ({name}, codec {cid})")
                counts.append((int(rounds[b]), model[3], model[4]))
                if counts[-1][0] != model[3]:
                    raise AssertionError(
                        f"K2 took {counts[-1][0]} rounds on {name} page {b}, "
                        f"codec {cid}; the CPU model {model[3]}")
            log(f"K2 {name} B={B} codec {cid}: max_abs_err vs plain={err}, "
                f"== host replay; rounds (card, model, serial tiles) per "
                f"page {counts}")
            if err != 0:
                raise AssertionError(f"K2 disagrees with its plain version "
                                     f"({name}, codec {cid})")
    return worst


def feedback_image() -> np.ndarray:
    """Repeated tiles force strict matches on substituted residuals (the
    image of tests/test_pallas_strict.py, RandomState(12345))."""
    img = np.tile(np.random.RandomState(12345).rand(16, 16) < 0.4, (6, 6))
    img[40:48, 40:48] ^= True
    return img


def check_k3(st, compress, pnm, dev) -> int:
    """K3 == its plain version on the same CUDA tensors: all 8 outputs and
    the residual fields, exact."""
    fx = lambda n: pnm.read_pbm(os.path.join(FIXTURES, n))
    cases = [("text64", fx("text64.pbm"), 8, 16),
             ("ragged75x101", fx("ragged75x101.pbm"), 8, 24),
             ("residual feedback", feedback_image(), 8, 40),
             ("doc512", fx("doc512.pbm"), 16, 128),
             ("text256 W=24", fx("text256.pbm"), 24, 48),
             ("text64 R<W", fx("text64.pbm"), 16, 9),
             ("doc512 W=32", fx("doc512.pbm"), 32, 64),
             ("doc512 2x2 W=32 R=1024", np.tile(fx("doc512.pbm"), (2, 2)),
              32, 1024)]
    worst = 0
    for name, img, W, R in cases:
        rows, cols = img.shape
        g = grid_of(img[None], W, dev)[0]
        plan = st._plan(W, R, *g.shape)
        enb = torch.from_numpy(compress.enb_lut(W * W)).to(dev)
        kw = dict(W=W, R=R, T_thresh=1, cols=cols)
        got = st._launch(g, enb, **kw)
        want = st.strict_analyze_plain(g, enb, **kw)
        torch.cuda.synchronize()
        err = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
                  for a, b in zip(got, want))
        worst = max(worst, err)
        band = (f"ring of {plan['ring_cols']} columns" if plan["ring"]
                else "band in global memory")
        log(f"K3 {name}: W={W} R={R} T={g.numel() // (W * W)} ({band}, "
            f"{plan['slices']} grid-2 slices) max_abs_err={err} "
            f"matches={int((got[0][:, 0] < 2).sum())}")
        if err != 0:
            raise AssertionError(f"K3 disagrees with its plain version on "
                                 f"{name}")
    return worst


def letter_page(doc: np.ndarray) -> np.ndarray:
    """A US letter page at 300 dpi, 3300 x 2550: doc512 tiled and cropped."""
    return np.tile(doc, (7, 5))[:3300, :2550]


def check_k4(sw, fs, pnm, dev) -> tuple[int, int]:
    """K4's two kernels == their plain versions on the same CUDA tensors:
    the plane kernel == ``_field_plane``, the search == the banded maps and
    the selection over them (W = 64 takes its own instance, the rest the
    run-time-W one).  Returns the worst error of each."""
    fx = lambda n: pnm.read_pbm(os.path.join(FIXTURES, n))
    doc, rag = fx("doc512.pbm"), fx("ragged75x101.pbm")
    rs = np.random.RandomState(1)
    roll = lambda n: np.stack([np.roll(doc, (rs.randint(512), rs.randint(512)),
                                       axis=(0, 1)) for _ in range(n)])
    partial = np.random.RandomState(4).rand(1, 300, 200) < 0.3
    strip = np.random.RandomState(9).rand(1, 16, 105_000) < 0.2
    strip[:, :, 52_500:] = strip[:, :, :52_500]
    # name, pages, W, R, invert
    cases = [("doc512", doc[None], 40, 64, True),
             ("doc512", doc[None], 64, 128, True),
             ("doc512 no-invert (codecs 4/7)", doc[None], 64, 128, False),
             ("ragged75x101", rag[None], 33, 40, True),
             ("ragged75x101", rag[None], 48, 56, True),
             ("random300x200 (partial bottom and right tiles)", partial, 64,
              128, True),
             ("doc512 x4 batch", roll(4), 64, 128, True),
             ("strip 16x105000 (outside K1's band budget)", strip, 8, 8,
              True)]
    worst = worst_plane = 0
    for name, pages, W, R, invert in cases:
        B, rows, cols = pages.shape
        ny, nx = -(-rows // W), -(-cols // W)
        if W <= 32 and fs.fused_supported(ny, nx, W, R):
            raise AssertionError(f"{name}: K1 takes this shape")
        img = grid_of(pages, W, dev)
        He = fs.plane_height(ny * W, W, R)
        E = sw._launch_plane(img, W, He)
        plain_E = fs._field_plane(img, W, He, nx * W)
        kw = dict(W=W, R=R, T_thresh=1, cols=cols, invert=invert)
        got = sw._launch(E, ny, nx, **kw)
        want = sw.select_windows_plain(plain_E, ny, nx, **kw)
        torch.cuda.synchronize()
        err_p = int((E - plain_E).abs().max()) if not torch.equal(
            E, plain_E) else 0
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        worst, worst_plane = max(worst, err), max(worst_plane, err_p)
        log(f"K4 {name}: W={W} R={R} B={B} T={ny * nx} invert={invert} plane "
            f"max_abs_err={err_p}, search max_abs_err={err} "
            f"found={int(got[..., 3].sum())}")
        if err != 0 or err_p != 0:
            raise AssertionError(f"K4 disagrees with its plain version on "
                                 f"{name} at W={W}")
    shards = [("doc512 top shard", doc, 64, 128, 0, 256),
              ("doc512 lower shard", doc, 64, 128, 256, 256),
              ("doc512", doc, 40, 64, 40, 120),
              ("ragged75x101 top shard", rag, 33, 40, 0, 66)]
    e, ep = check_shard_frames("K4", shards, sw._launch_plane, sw._launch,
                               fs._field_plane, sw.select_windows_plain, dev)
    return max(worst, e), max(worst_plane, ep)


def main_path(compress, archive, codec, native, pnm):
    """The causal path, as a user calls it: one page, then a corpus."""
    doc = pnm.read_pbm(os.path.join(FIXTURES, "doc512.pbm"))
    p = codec.CodecParams(codec=8, W=16, R=128, strict=False)
    host = lambda img: host_stream(codec, native, img, p)

    t0 = time.perf_counter()
    blob = compress.encode(doc, p, device="cuda")
    t_page = time.perf_counter() - t0
    if len(blob) != 17207:
        raise AssertionError(f"doc512 encoded to {len(blob)} B, not 17207")
    if blob != host(doc):
        raise AssertionError("doc512 stream != native host encoder stream")
    if not np.array_equal(codec.decode(blob), doc):
        raise AssertionError("doc512 does not round-trip")
    log(f"single page: doc512 W=16 R=128 -> {len(blob)} B, == host "
        f"encoder, round-trips ({t_page * 1e3:.1f} ms wall, first call)")

    rng = np.random.RandomState(0)
    corpus = [np.roll(doc, (int(rng.randint(512)), int(rng.randint(512))),
                      axis=(0, 1)) for _ in range(CORPUS_PAGES)]
    ckpt = os.path.join(REPO, "build", "chip_smoke_corpus.journal")
    os.makedirs(os.path.dirname(ckpt), exist_ok=True)
    if os.path.exists(ckpt):
        os.remove(ckpt)
    t0 = time.perf_counter()
    arc = archive.encode_archive(corpus, p, batch_size=32, device="cuda",
                                 checkpoint=ckpt)
    t_arc = time.perf_counter() - t0
    n = archive.page_count(arc)
    offs = np.frombuffer(arc, dtype=np.uint64, count=n, offset=8)
    ends = list(offs[1:]) + [len(arc) - 8 - 8 * n]
    for i in range(n):
        page_blob = arc[8 + 8 * n + int(offs[i]):8 + 8 * n + int(ends[i])]
        if page_blob != host(corpus[i]):
            raise AssertionError(f"corpus page {i} != host encoder stream")
    back = archive.decode_archive(arc)
    if not all(np.array_equal(a, b) for a, b in zip(back, corpus)):
        raise AssertionError("corpus does not round-trip")
    n = CORPUS_PAGES
    log(f"corpus: {n} pages -> {len(arc)} B, ratio "
        f"{100.0 * len(arc) / (n * RAW_DOC):.2f} %, every page == host "
        f"encoder, round-trips; encode_archive {t_arc:.3f} s wall "
        f"({n / t_arc:.1f} pages/s, {n * 0.262144 / t_arc:.2f} MP/s, "
        f"batch 32, journal on)")


def host_stream(codec, native, img, p) -> bytes:
    hdr = codec._header(p, *img.shape, codec.image_crc(img))
    return native.encode_windowed(img, hdr, p.codec, p.strict, p.W,
                                  p.resolved_T(), p.R)


def strict_path(compress, codec, native, pnm):
    """The strict path as a user calls it: encode_strict on doc512, and on
    doc512 tiled 1 x 4 (512 x 2048, wider than the serial pass's ring)."""
    doc = pnm.read_pbm(os.path.join(FIXTURES, "doc512.pbm"))
    p = codec.CodecParams(codec=8, W=16, R=128, strict=True)
    for name, img in (("doc512", doc), ("doc512 1x4", np.tile(doc, (1, 4)))):
        t0 = time.perf_counter()
        blob = compress.encode_strict(img, p, device="cuda")
        t = time.perf_counter() - t0
        if blob != host_stream(codec, native, img, p):
            raise AssertionError(f"strict {name} != native host strict "
                                 f"stream")
        if not np.array_equal(codec.decode(blob), img):
            raise AssertionError(f"strict {name} does not round-trip")
        if name == "doc512" and len(blob) != 19192:
            raise AssertionError(f"strict doc512 is {len(blob)} B, not "
                                 f"19192")
        log(f"strict: {name} {img.shape[0]}x{img.shape[1]} W=16 R=128 -> "
            f"{len(blob)} B, == host strict encoder, round-trips "
            f"({t * 1e3:.1f} ms wall, first call)")


BANDED_BYTES = {(64, 128): 22375, (40, 64): 22590}


def banded_path(compress, codec, native, pnm):
    """The banded route as a user calls it: encode doc512 at W = 64 and 40,
    and a 3300 x 2550 letter page at W = 64, R = 128."""
    doc = pnm.read_pbm(os.path.join(FIXTURES, "doc512.pbm"))
    for name, img, W, R in (("doc512", doc, 64, 128), ("doc512", doc, 40, 64),
                            ("letter 3300x2550", letter_page(doc), 64, 128)):
        p = codec.CodecParams(codec=8, W=W, R=R, strict=False)
        t0 = time.perf_counter()
        blob = compress.encode(img, p, device="cuda")
        t = time.perf_counter() - t0
        if blob != host_stream(codec, native, img, p):
            raise AssertionError(f"{name} W={W} != native host stream")
        if not np.array_equal(codec.decode(blob), img):
            raise AssertionError(f"{name} W={W} does not round-trip")
        if name == "doc512" and len(blob) != BANDED_BYTES[(W, R)]:
            raise AssertionError(f"doc512 W={W} is {len(blob)} B, not "
                                 f"{BANDED_BYTES[(W, R)]}")
        log(f"banded: {name} W={W} R={R} -> {len(blob)} B, == host encoder, "
            f"round-trips ({t * 1e3:.1f} ms wall, first call)")


# doc512's codec-4/7 bytes, causal: (codec, W, R) -> bytes
CODEC47_BYTES = {(4, 16, 128): 16986, (7, 16, 128): 17094,
                 (4, 64, 128): 22367, (7, 64, 128): 22375}
CODEC47_REPS = 5


def codec47_path(compress, codec, native, pnm, profiling, W: int, R: int):
    """Codecs 4 and 7 as a user calls them: ``compress.encode`` of doc512
    on the card (K1 at W = 16, K4 at W = 64, both with the complement
    trick off; the modes decided and the records packed by native
    ``bic_decide_pack``).  Each stream == the native host encoder's and
    the pinned bytes, and round-trips; then CODEC47_REPS warm calls with
    a ``PipelineProfile``, whose report is printed."""
    doc = pnm.read_pbm(os.path.join(FIXTURES, "doc512.pbm"))
    for cid in (4, 7):
        p = codec.CodecParams(codec=cid, W=W, R=R, strict=False)
        t0 = time.perf_counter()
        blob = compress.encode(doc, p, device="cuda")
        t_first = time.perf_counter() - t0
        want = CODEC47_BYTES[(cid, W, R)]
        if len(blob) != want:
            raise AssertionError(f"codec {cid} doc512 W={W} is {len(blob)} "
                                 f"B, not {want}")
        if blob != host_stream(codec, native, doc, p):
            raise AssertionError(f"codec {cid} doc512 W={W} != native host "
                                 f"encoder stream")
        if not np.array_equal(codec.decode(blob), doc):
            raise AssertionError(f"codec {cid} doc512 W={W} does not "
                                 f"round-trip")
        prof = profiling.PipelineProfile()
        walls = []
        for _ in range(CODEC47_REPS):
            t0 = time.perf_counter()
            if compress.encode(doc, p, device="cuda", profile=prof) != blob:
                raise AssertionError(f"codec {cid} W={W}: a warm call "
                                     f"wrote other bytes")
            walls.append((time.perf_counter() - t0) * 1e3)
        log(f"codec {cid}: doc512 W={W} R={R} causal -> {len(blob)} B, == "
            f"host encoder, round-trips; compress.encode wall "
            f"{t_first * 1e3:.1f} ms first call, warm "
            f"{', '.join(f'{t:.2f}' for t in walls)} ms (median "
            f"{float(np.median(walls)):.2f}); profile of the "
            f"{CODEC47_REPS} warm calls:")
        for line in prof.report().splitlines():
            log("  " + line)


# doc512's bytes of the host codecs (codec 1 on the 128 x 128 crop)
HOST_BYTES = {1: 1302, 2: 21914, 3: 21934, 6: 16986, 12: 16181}


def host_codecs_phase(codec, pnm):
    """The host codecs as a user calls them: ``codec.encode`` and
    ``codec.decode`` of codecs 1 (doc512's 128 x 128 crop), 2, 3, 6 and 12
    (doc512), each at its pinned bytes and round-tripping, timed on this
    machine's host; then the CLI's ``compare`` and ``info`` on doc512 as
    subprocesses, which must exit 0 (``compare`` with no codec failing and
    its sizes those of the API)."""
    path = os.path.join(FIXTURES, "doc512.pbm")
    doc = pnm.read_pbm(path)
    for cid, want in HOST_BYTES.items():
        img = doc[:128, :128] if cid == 1 else doc
        p = (codec.CodecParams(codec=12, W=0, T=0, R=128, strict=False)
             if cid == 12 else
             codec.CodecParams(codec=cid, W=16, R=128, strict=False))
        t0 = time.perf_counter()
        blob = codec.encode(img, p)
        t_enc = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = codec.decode(blob)
        t_dec = time.perf_counter() - t0
        if len(blob) != want:
            raise AssertionError(f"codec {cid} is {len(blob)} B, not {want}")
        if not np.array_equal(back, img):
            raise AssertionError(f"codec {cid} does not round-trip")
        log(f"host codec {cid}: {img.shape[0]}x{img.shape[1]} -> "
            f"{len(blob)} B, round-trips; encode {t_enc * 1e3:.1f} ms, "
            f"decode {t_dec * 1e3:.1f} ms (host wall)")
    bic = os.path.join(REPO, "build", "chip_smoke_codec4.bic")
    os.makedirs(os.path.dirname(bic), exist_ok=True)
    with open(bic, "wb") as f:
        f.write(codec.encode(doc, codec.CodecParams(codec=4, W=16, R=128,
                                                    strict=False)))
    want_sizes = {2: 21914, 3: 21934, 4: 16986, 7: 17094, 8: 17207,
                  12: 16181, 13: 15097}
    for argv in (["compare", path], ["info", bic]):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m",
                            "binary_image_compression_tpu_torch", *argv],
                           cwd=REPO, capture_output=True, text=True,
                           timeout=600)
        t = time.perf_counter() - t0
        if r.returncode != 0:
            raise AssertionError(f"CLI {argv[0]} exited {r.returncode}: "
                                 f"{r.stderr[-2000:]}")
        for line in r.stdout.splitlines():
            log(f"  {argv[0]}: {line}")
        if argv[0] == "compare":
            sizes = {}
            for line in r.stdout.splitlines():
                if "[" in line:
                    raise AssertionError(f"compare: a codec failed: {line}")
                m = re.match(r"codec (\d+) .* (\d+)B ", line)
                if m:
                    sizes[int(m[1])] = int(m[2])
            bad = {c: (sizes.get(c), n) for c, n in want_sizes.items()
                   if sizes.get(c) != n}
            if bad:
                raise AssertionError(f"compare sizes differ: {bad}")
        else:
            info = json.loads(r.stdout.strip().splitlines()[-1])
            if (info["codec"], info["W"], info["rows"], info["cols"]) != \
                    (4, 16, 512, 512):
                raise AssertionError(f"info read {info}")
        log(f"CLI {argv[0]} exited 0 ({t:.1f} s wall, process start "
            f"included)")


# --- multi-device: parallel/ on torch.distributed -------------------------

LETTER_W64_BYTES = 720310        # codec 8 causal, W=64, R=128
PARALLEL_TIMEOUT = 600           # seconds, each rank of the gloo world
PARALLEL_REPS = 3


def tile_cases(pnm):
    """(what, page, W, R) of the tile-sharded checks: the letter page
    through K1 and K4, the top 128 rows of doc512 (at 2 ranks R=128 spans
    two 64-row blocks), and ragged75x101 at W=16 (5 tile rows: a pad row
    at 2 ranks)."""
    doc = pnm.read_pbm(os.path.join(FIXTURES, "doc512.pbm"))
    rag = pnm.read_pbm(os.path.join(FIXTURES, "ragged75x101.pbm"))
    letter = letter_page(doc)
    return [("letter 3300x2550", letter, 16, 128),
            ("letter 3300x2550", letter, 64, 128),
            ("doc512 rows 0..127, R over two blocks", doc[:128], 16, 128),
            ("ragged75x101, a pad tile row", rag, 16, 32)]


def tile_sharded_checks(m, tileshard, compress, codec, native, pnm, dev,
                        want: dict | None):
    """encode_tile_sharded of every tile case; on the line's first rank
    each stream == `want` (compress.encode's, computed before) == the
    native host stream, round-trips, and the letter page at W=64 is
    LETTER_W64_BYTES.  Returns {(what, W): bytes} there."""
    got = {}
    for what, img, W, R in tile_cases(pnm):
        p = codec.CodecParams(codec=8, W=W, R=R, strict=False)
        blob = tileshard.encode_tile_sharded(m, img, p, device=dev)
        if blob is None:
            continue
        if want is not None and blob != want[(what, W)]:
            raise AssertionError(f"tile-sharded {what} W={W} != "
                                 f"compress.encode")
        if blob != host_stream(codec, native, img, p):
            raise AssertionError(f"tile-sharded {what} W={W} != native host "
                                 f"stream")
        if not np.array_equal(codec.decode(blob), img):
            raise AssertionError(f"tile-sharded {what} W={W} does not "
                                 f"round-trip")
        if what.startswith("letter") and W == 64 and \
                len(blob) != LETTER_W64_BYTES:
            raise AssertionError(f"letter W=64 is {len(blob)} B, not "
                                 f"{LETTER_W64_BYTES}")
        got[(what, W)] = blob
        log(f"  tile-sharded {what} W={W} R={R} over {m.shape['data']} "
            f"rank(s) -> {len(blob)} B, == compress.encode and the host "
            f"encoder, round-trips")
    return got


def single_device_streams(compress, codec, pnm) -> dict:
    return {(what, W): compress.encode(img, codec.CodecParams(
        codec=8, W=W, R=R, strict=False), device="cuda")
        for what, img, W, R in tile_cases(pnm)}


def profiled(fn, reps: int):
    """Host wall ms of reps warm calls of fn(profile), and the profile."""
    from binary_image_compression_tpu_torch.utils.profiling import \
        PipelineProfile
    fn(None)
    prof = PipelineProfile()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(prof)
        walls.append((time.perf_counter() - t0) * 1e3)
    return walls, prof


def log_times(label: str, walls, prof, reps: int, gpu: str) -> None:
    per = {k: v.seconds * 1e3 / reps for k, v in prof.stages.items()}
    log(f"{label} [{gpu}]: wall per call "
        f"{', '.join(f'{w:.3f}' for w in walls)} ms (median "
        f"{float(np.median(walls)):.3f}); per call "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in per.items()))


def parallel_world1(compress, codec, native, pnm, _cuda, dev, gpu) -> dict:
    """A world of 1 on NCCL in this process: the tile-sharded encodes,
    their launches counted (the single-device references are made before
    the counts are reset), then the CLI's --shard tiles as a subprocess and
    the letter page's times beside compress.encode.  Returns the counts."""
    import torch.distributed as dist

    from binary_image_compression_tpu_torch.parallel import mesh as pm
    from binary_image_compression_tpu_torch.parallel import (multihost,
                                                             tileshard)
    want = single_device_streams(compress, codec, pnm)
    multihost.init_single_process(backend="nccl", device=dev)
    try:
        if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
            raise AssertionError("world 1 is not one NCCL rank")
        log(f"parallel world 1: backend {dist.get_backend()}, compute on "
            f"{dev}")
        m = pm.make_mesh(1, data=1, model=1)
        counts = drive("parallel world 1", lambda: tile_sharded_checks(
            m, tileshard, compress, codec, native, pnm, dev, want), _cuda,
            ("field_plane", "fused_search_select", "banded_plane",
             "select_windows"))
        if counts.get("decide_modes"):
            raise AssertionError("the tile-sharded path launched K2")
        doc = pnm.read_pbm(os.path.join(FIXTURES, "doc512.pbm"))
        letter = letter_page(doc)
        for W in (16, 64):
            p = codec.CodecParams(codec=8, W=W, R=128, strict=False)
            walls, prof = profiled(lambda pr: tileshard.encode_tile_sharded(
                m, letter, p, device=dev, profile=pr), PARALLEL_REPS)
            log_times(f"letter W={W} encode_tile_sharded, world 1 (NCCL)",
                      walls, prof, PARALLEL_REPS, gpu)
            walls, prof = profiled(lambda pr: compress.encode(
                letter, p, device="cuda", profile=pr), PARALLEL_REPS)
            log_times(f"letter W={W} compress.encode, one device", walls,
                      prof, PARALLEL_REPS, gpu)
    finally:
        dist.destroy_process_group()

    src = os.path.join(REPO, "build", "chip_smoke_letter.pbm")
    out = os.path.join(REPO, "build", "chip_smoke_letter.bic")
    pnm.write_pbm(letter, src)
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m",
                        "binary_image_compression_tpu_torch", "compress",
                        src, out, "-W", "64", "--shard", "tiles"],
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        raise AssertionError(f"compress --shard tiles exited "
                             f"{r.returncode}:\n{r.stderr[-3000:]}")
    with open(out, "rb") as f:
        if f.read() != want[("letter 3300x2550", 64)]:
            raise AssertionError("compress --shard tiles != compress.encode")
    log(f"CLI compress --shard tiles -W 64 on the letter page (a world of "
        f"1, NCCL): {r.stdout.strip()}; == compress.encode "
        f"({time.perf_counter() - t0:.1f} s wall)")
    return counts


def parallel_world2(gpu: str) -> None:
    """A world of 2 under gloo: two processes of this script on the one
    card (NCCL takes one rank per GPU), each with its own timeout; any
    rank's failure fails the run.  The kernels are built before."""
    import socket
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    logdir = os.path.join(REPO, "build", "chip_smoke_parallel")
    os.makedirs(logdir, exist_ok=True)
    logs = [open(os.path.join(logdir, f"rank{r}.log"), "w+")
            for r in range(2)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--parallel-rank", str(r), str(port)],
                              cwd=REPO, stdout=logs[r],
                              stderr=subprocess.STDOUT) for r in range(2)]
    t0 = time.perf_counter()
    try:
        for p in procs:
            try:
                p.wait(timeout=max(1.0, PARALLEL_TIMEOUT
                                   - (time.perf_counter() - t0)))
            except subprocess.TimeoutExpired:
                pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, f in enumerate(logs):
        f.seek(0)
        for line in f.read().splitlines():
            log(f"  [rank {r}] {line}")
        f.close()
    rcs = [p.returncode for p in procs]
    if any(rc != 0 for rc in rcs):
        raise AssertionError(f"parallel world 2: ranks exited {rcs}")
    log(f"parallel world 2 (gloo, both ranks on {gpu}): every check passed, "
        f"ranks exited {rcs} ({time.perf_counter() - t0:.1f} s wall)")


def parallel_rank(rank: int, port: int, dev="cuda:0") -> int:
    """One rank of parallel_world2's gloo world, compute on `dev`."""
    import torch.distributed as dist
    sys.path.insert(0, REPO)
    from binary_image_compression_tpu_torch import native
    from binary_image_compression_tpu_torch.models import (archive, bsvd,
                                                           codec, compress)
    from binary_image_compression_tpu_torch.ops import _cuda, predict
    from binary_image_compression_tpu_torch.ops.bitpack import np_pack
    from binary_image_compression_tpu_torch.parallel import (bitmerge, halo,
                                                             multihost,
                                                             tileshard)
    from binary_image_compression_tpu_torch.parallel import mesh as pm
    from binary_image_compression_tpu_torch.utils import pnm, threefry

    dev = torch.device(dev)
    world = 2
    multihost.init_distributed(f"127.0.0.1:{port}", world, rank,
                               backend="gloo", device=dev)
    log(f"backend {dist.get_backend()}, world {dist.get_world_size()}, "
        f"rank {rank}, compute on {dev}")
    m = pm.make_mesh(world, data=world, model=1)
    first = rank == 0
    want = single_device_streams(compress, codec, pnm) if first else None
    _cuda.launches.clear()
    tile_sharded_checks(m, tileshard, compress, codec, native, pnm, dev, want)
    counts = dict(_cuda.launches)
    log(f"tile-sharded launches on this rank: {counts}")
    for k in ("field_plane", "fused_search_select", "banded_plane",
              "select_windows"):
        if not counts.get(k):
            raise AssertionError(f"this rank never launched {k}")

    doc = pnm.read_pbm(os.path.join(FIXTURES, "doc512.pbm"))
    letter = letter_page(doc)
    cols = letter.shape[1]
    packed = torch.from_numpy(np_pack(letter).view(np.int32)).to(dev)
    r = halo.med_forward_sharded(m, packed, cols)
    if not torch.equal(r, predict.med_forward(packed, cols)):
        raise AssertionError("med_forward_sharded != med_forward")
    back = halo.med_inverse_sharded(m, r, cols)
    if not torch.equal(back, predict.med_inverse(r, cols)) or \
            not torch.equal(back, packed):
        raise AssertionError("med_inverse_sharded != med_inverse")
    log("halo: the letter page's MED forward and inverse over 2 ranks == "
        "predict.med_forward / med_inverse, and the inverse gives the page")

    X = bsvd.patchify_to_rows(torch.from_numpy(doc).to(dev), 16)
    step = pm.sharded_train_step(m)
    for K in (64, 512):
        D, A = bsvd.initialize_random_centroids(threefry.PRNGKey(34503498),
                                                X, K)
        E = bsvd.residual(X, D, A)
        one = bsvd.learn_train_step(E, D, A)
        _, Es, Ds, As = pm.shard_bsvd_state(m, X, E, D, A)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        Es, Ds, As = step(Es, Ds, As)
        torch.cuda.synchronize()
        t = (time.perf_counter() - t0) * 1e3
        got = (m.all_gather_cat(Es, "data"), Ds, m.all_gather_cat(As, "data"))
        if not all(torch.equal(g, w) for g, w in zip(got, one)):
            raise AssertionError(f"sharded_train_step K={K} != "
                                 f"learn_train_step")
        log(f"sharded_train_step doc512 N=1024 M=256 K={K} (data=2): == "
            f"one device's learn_train_step ({t:.1f} ms wall)")

    rng = np.random.RandomState(0)
    corpus = [np.roll(doc, (int(rng.randint(512)), int(rng.randint(512))),
                      axis=(0, 1)) for _ in range(CORPUS_PAGES)]
    p = codec.CodecParams(codec=8, W=16, R=128, strict=False)
    blobs = multihost.encode_corpus_sharded(corpus, params=p, batch_size=32,
                                            device=dev)
    offs = multihost.corpus_offsets(blobs, len(corpus))
    every = [None] * world
    dist.all_gather_object(every, blobs)
    if first:
        single = archive.encode_pages(corpus, p, batch_size=32, device=dev)
        if [b for part in every for b in part] != single:
            raise AssertionError("encode_corpus_sharded != encode_pages")
        if not np.array_equal(offs, multihost.merge_host_offsets(
                [len(b) for b in single])):
            raise AssertionError("corpus offsets != merge_host_offsets")
        log(f"encode_corpus_sharded: {len(corpus)} pages over 2 ranks, every "
            f"blob == archive.encode_pages, offsets merged (last "
            f"{int(offs[-1])})")
    nbits = 1000 + 7 * rank
    off = bitmerge.exclusive_offsets(m, "data", nbits)
    if off != (1000 if rank else 0):
        raise AssertionError(f"exclusive_offsets gave {off}")

    gpu = card()
    for W in (16, 64):
        p = codec.CodecParams(codec=8, W=W, R=128, strict=False)
        walls, prof = profiled(lambda pr: tileshard.encode_tile_sharded(
            m, letter, p, device=dev, profile=pr), PARALLEL_REPS)
        if first:
            log_times(f"letter W={W} encode_tile_sharded, world 2 (gloo, "
                      f"two processes on one card)", walls, prof,
                      PARALLEL_REPS, gpu)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def no_maps_on_card(search, fn):
    """Run fn() with a spy on ``search.window_distance_maps_banded`` (K4's
    plain maps); fail if it was called on a CUDA tensor."""
    orig, devices = search.window_distance_maps_banded, []

    def spy(E, *a, **k):
        devices.append(E.device.type)
        return orig(E, *a, **k)
    search.window_distance_maps_banded = spy
    try:
        fn()
    finally:
        search.window_distance_maps_banded = orig
    log(f"banded path: window_distance_maps_banded called {len(devices)} "
        f"times, on {sorted(set(devices)) or 'no device'}")
    if "cuda" in devices:
        raise AssertionError("the banded path built distance maps on the "
                             "card")


# (N, M, K) of K5's checks: tests/test_pallas.py's shapes, ragged edges,
# codec 11 on doc512 (W=16, K=64), the bsvd CLI (-k 512, image and matrix
# mode, and -w 48: M = 2304), scripts/bench_bsvd.py's shapes, and rows wider
# than JAX's 2048-bit packed bound
K5_CASES = [(77, 130, 33), (300, 64, 16),
            (1, 1, 1), (1, 32, 1), (33, 32, 65), (31, 100, 1), (1, 200, 70),
            (1024, 256, 64), (1024, 256, 512), (512, 512, 512),
            (121, 2304, 512),
            (4096, 256, 256), (4096, 1024, 256), (2048, 2048, 128),
            (64, 2080, 40), (256, 4096, 64)]
BENCH_BSVD = ((1024, 256, 64), (1024, 256, 512), (4096, 256, 256),
              (4096, 1024, 256), (2048, 2048, 128))
# the planted letter page: the 16 x 16 patches of a 3300 x 2550 page (207 x
# 160 = 33,120 rows of 256 bits) against K = 512 atoms, from
# RandomState(33120)
LETTER_PURSUIT = (33120, 256, 512)


def dense_rows(N, M, K, dev):
    """bench_bsvd.py's operands: 0/1 int8 E [N, M] and D [K, M], density
    0.3, from RandomState(N + M + K)."""
    rs = np.random.RandomState(N + M + K)
    E = torch.from_numpy((rs.rand(N, M) < 0.3).astype(np.int8)).to(dev)
    D = torch.from_numpy((rs.rand(K, M) < 0.3).astype(np.int8)).to(dev)
    return E, D


def check_k5(pd, bsvd, dev) -> int:
    """K5 == its plain version on the same CUDA tensors, and == the float32
    matmul route, exact, on every K5_CASES shape."""
    worst = 0
    for N, M, K in K5_CASES:
        E, D = dense_rows(N, M, K, dev)
        a, b = bsvd._pack(E), bsvd._pack(D)
        got = pd._launch_dist(a, b)
        want = pd.packed_dist_matrix_plain(a, b)
        mxu = bsvd.distances_to_atoms(E, D, "mxu")
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        err_mxu = float((got.to(torch.float32) - mxu).abs().max())
        worst = max(worst, err)
        log(f"K5 [{N}, {a.shape[1]}] x [{K}, {a.shape[1]}] (M={M}): "
            f"max_abs_err={err}, vs mxu route {err_mxu}")
        if err != 0 or err_mxu != 0:
            raise AssertionError(f"K5 disagrees at N={N} M={M} K={K}")
    return worst


def check_k6(pd, bsvd, dev) -> int:
    """K6 == its plain version on the rows of K5_CASES."""
    worst = 0
    for N, M, K in K5_CASES:
        E, _ = dense_rows(N, M, K, dev)
        a = bsvd._pack(E)
        got = pd._launch_weight(a)
        want = pd.packed_row_weight_plain(a)
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        worst = max(worst, err)
        if err != 0 or not torch.equal(got.to(torch.int64), E.sum(dim=1)):
            raise AssertionError(f"K6 disagrees at N={N} M={M}")
    log(f"K6 on the {len(K5_CASES)} K5 row sets: max_abs_err={worst}")
    return worst


def planted_pursuit(N, M, K, seed, dev):
    """Planted pursuit inputs, int8 on `dev`, from RandomState(seed): D =
    rand(K, M) < 0.25, A* = rand(N, K) < 3/K, E = (A* D mod 2) ^ (rand(N,
    M) < 0.05) and A = 0, so rows recover about 3 atoms each.  The product
    is float32 on the card (sums of at most K ones, exact)."""
    rs = np.random.RandomState(seed)
    D = rs.rand(K, M) < 0.25
    Astar = rs.rand(N, K) < 3.0 / K
    noise = torch.from_numpy(rs.rand(N, M) < 0.05).to(dev)
    Dt = torch.from_numpy(D).to(dev)
    prod = torch.from_numpy(Astar).to(dev).float() @ Dt.float()
    E = (torch.remainder(prod, 2.0) == 1.0) ^ noise
    return (E.to(torch.int8), Dt.to(torch.int8),
            torch.zeros((N, K), dtype=torch.int8, device=dev))


def check_pursuit(pd, bsvd, dev):
    """The pursuit kernel == ``packed_pursuit_plain`` on the same CUDA
    tensors, exactly (the packed E, A, the changed count, every row's
    passes), with D staged in shared memory and read from device memory, on
    the K5_CASES shapes built as planted inputs and on the planted letter
    page.  Returns the worst error and the letter page's packed inputs."""
    worst = 0
    cases = [(N, M, K, N + M + K) for N, M, K in K5_CASES]
    cases.append(LETTER_PURSUIT + (LETTER_PURSUIT[0],))
    for N, M, K, seed in cases:
        E, D, A = planted_pursuit(N, M, K, seed, dev)
        Ep0, Dp = bsvd._pack(E), bsvd._pack(D)
        Ew, Aw = Ep0.clone(), A.clone()
        want = pd.packed_pursuit_plain(Ew, Dp, Aw, K)
        for stage in (1, 0):
            Eg, Ag = Ep0.clone(), A.clone()
            got = pd._launch_pursuit(Eg, Dp, Ag, K, stage=stage)
            torch.cuda.synchronize()
            err = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
                      for a, b in ((Eg, Ew), (Ag, Aw), (got[0], want[0]),
                                   (got[1], want[1])))
            worst = max(worst, err)
            log(f"pursuit [{N}, {Dp.shape[1]}] x [{K}, {Dp.shape[1]}] (M={M}) "
                f"D {'in shared memory' if stage else 'from device memory'}: "
                f"changed {int(want[0])}, passes {int(want[1].sum())} (max "
                f"{int(want[1].max())}), max_abs_err={err}")
            if err != 0:
                raise AssertionError(f"the pursuit kernel disagrees at N={N} "
                                     f"M={M} K={K}, stage {stage}")
    return worst, (Ep0, Dp, A)


def pursuit_spy(bsvd, _cuda, fn):
    """Run fn() with a spy on ``bsvd.update_coefficients``: each packed-route
    call on CUDA tensors must launch the pursuit kernel once and nothing
    else of ours (no K5, no K6), with torch's sync debug mode set to
    "error" around it (no host sync inside)."""
    orig, calls = bsvd.update_coefficients, []

    def spy(E, D, A, max_flips=None, distances="packed"):
        if not E.is_cuda or distances != "packed":
            return orig(E, D, A, max_flips, distances)
        before = dict(_cuda.launches)
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = orig(E, D, A, max_flips, distances)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        delta = {k: n - before.get(k, 0) for k, n in _cuda.launches.items()
                 if n != before.get(k, 0)}
        calls.append(delta)
        if delta != {"packed_pursuit": 1}:
            raise AssertionError(f"update_coefficients launched {delta}")
        return out
    bsvd.update_coefficients = spy
    try:
        fn()
    finally:
        bsvd.update_coefficients = orig
    log(f"bsvd path: {len(calls)} packed update_coefficients calls on the "
        f"card, each one packed_pursuit launch, no K5 or K6 launch, no host "
        f"sync")
    if not calls:
        raise AssertionError("no packed pursuit ran on the card")


CODEC11_BYTES = 24209   # JAX's codec.encode of doc512, W=16, K=64


def bsvd_path(codec, bsvd, cli, pnm, dev):
    """BSVD as a user calls it: codec 11 on doc512, learn on both distance
    routes, and the bsvd CLI at K = 512."""
    doc = pnm.read_pbm(os.path.join(FIXTURES, "doc512.pbm"))
    p = codec.CodecParams(codec=11, W=16, T=0, R=0)
    t0 = time.perf_counter()
    blob = codec.encode(doc, p, device="cuda")
    t = time.perf_counter() - t0
    if blob != codec.encode(doc, p, device="cpu"):
        raise AssertionError("codec 11 doc512: cuda stream != cpu stream")
    if len(blob) != CODEC11_BYTES:
        raise AssertionError(f"codec 11 doc512 is {len(blob)} B, not JAX's "
                             f"{CODEC11_BYTES}")
    if not np.array_equal(codec.decode(blob), doc):
        raise AssertionError("codec 11 doc512 does not round-trip")
    log(f"codec 11: doc512 W=16 K=64 -> {len(blob)} B (JAX's bytes), == the "
        f"CPU encode, round-trips ({t * 1e3:.1f} ms wall, first call)")

    X = bsvd.patchify_to_rows(torch.from_numpy(doc).to(dev), 16)
    packed = bsvd.learn(X, K=64, init="random_centroids")
    mxu = bsvd.learn(X, K=64, init="random_centroids", distances="mxu")
    if packed[3] != mxu[3] or not all(torch.equal(a, b) for a, b in
                                      zip(packed[:3], mxu[:3])):
        raise AssertionError("learn: packed and mxu routes differ")
    log(f"learn doc512 W=16 K=64: packed == mxu route (E, D, A), "
        f"{packed[3]} iterations, |E| = {int(packed[0].sum())}")

    out = os.path.join(REPO, "build", "chip_smoke_bsvd")
    os.makedirs(out, exist_ok=True)
    for f in os.listdir(out):
        os.remove(os.path.join(out, f))
    t0 = time.perf_counter()
    cli.main(["bsvd", os.path.join(FIXTURES, "doc512.pbm"), "-I", "1", "-w",
              "16", "-k", "512", "-i", "2", "--out-dir", out])
    t = time.perf_counter() - t0
    got = {n: pnm.read_pbm(os.path.join(out, n + ".pbm"))
           for n in ("dictionary", "coefficients", "residual")}
    D, A, E = (torch.from_numpy(got[n]).to(dev, torch.int8)
               for n in ("dictionary", "coefficients", "residual"))
    if D.shape != (512, 256) or A.shape != (1024, 512):
        raise AssertionError(f"bsvd CLI wrote D {tuple(D.shape)}, "
                             f"A {tuple(A.shape)}")
    if not torch.equal(E, bsvd.residual(X, D, A)):
        raise AssertionError("bsvd CLI: E != residual(X, D, A)")
    log(f"bsvd CLI doc512 -I 1 -w 16 -k 512 -i 2: wrote the three PBMs, "
        f"E == residual(X, D, A), |E| = {int(E.sum())} ({t:.2f} s wall)")


class _Timed:
    """Sum the synchronised host time of calls to module functions while
    inside the `with` block (restores them on exit)."""

    def __init__(self, mod, names):
        self.mod, self.names = mod, names
        self.ms = dict.fromkeys(names, 0.0)

    def __enter__(self):
        self.orig = {n: getattr(self.mod, n) for n in self.names}
        for n in self.names:
            setattr(self.mod, n, self._wrap(n, self.orig[n]))
        return self

    def _wrap(self, n, fn):
        def timed(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn(*a, **k)
            torch.cuda.synchronize()
            self.ms[n] += (time.perf_counter() - t0) * 1e3
            return r
        return timed

    def __exit__(self, *exc):
        for n in self.names:
            setattr(self.mod, n, self.orig[n])


# the L0 API's cases: (rows of a, rows of b, columns, dirty padding); the
# first is K5's doc512 shape (codec 11's 1,024 patches of 256 bits against
# K = 64 atoms, [1024, 8] x [64, 8] words)
L0_CASES = ((1024, 64, 256, False), (300, 77, 250, True))


def l0_words(N, cols, seed, dirty):
    """Random uint32 words [N, nwords(cols)] as int64 on the CPU, from
    RandomState(seed); the bits past `cols` random where dirty, else 0."""
    w = -(-cols // 32)
    x = np.random.RandomState(seed).randint(0, 2 ** 32, size=(N, w),
                                            dtype=np.uint64).astype(np.int64)
    if not dirty and cols % 32:
        x[:, -1] &= (0xFFFFFFFF << (32 - cols % 32)) & 0xFFFFFFFF
    return torch.from_numpy(x)


def l0_calls(bp, cols, K):
    """Each name of the L0 API as a function of (a, b) words."""
    sub = min(31, cols - 8)
    return {
        "dist_matrix": lambda a, b: bp.dist_matrix(a, b, cols),
        "row_weight": lambda a, b: bp.row_weight(a),
        "weight": lambda a, b: bp.weight(a),
        "gf2_sum": lambda a, b: bp.gf2_sum(a),
        "row_sum": lambda a, b: bp.row_sum(a),
        "dist": lambda a, b: bp.dist(a[:K], b),
        "xor": lambda a, b: bp.xor(a[:K], b),
        "bool_and": lambda a, b: bp.bool_and(a[:K], b),
        "bool_or": lambda a, b: bp.bool_or(a[:K], b),
        "flip": lambda a, b: bp.flip(a, cols),
        "col_weight": lambda a, b: bp.col_weight(a, cols),
        "col_sum": lambda a, b: bp.col_sum(a),
        "and_counts": lambda a, b: bp.and_counts(a, b, cols),
        "mul": lambda a, b: bp.mul(a, cols, False, b, cols, True),
        "transpose": lambda a, b: bp.transpose(b, K, cols),
        "submatrix": lambda a, b: bp.submatrix(a, 3, 40, 5, 5 + sub, cols),
        "set_submatrix": lambda a, b: bp.set_submatrix(
            a, bp.submatrix(b, 0, 30, 0, sub, cols), 7, 2, cols, sub),
        "unvectorize_patches": lambda a, b: bp.unvectorize_patches(b, 15),
        "vectorize_patches": lambda a, b: bp.vectorize_patches(
            bp.unvectorize_patches(b, 15)),
        "unpatchify": lambda a, b: bp.unpatchify(
            bp.unvectorize_patches(b[:63], 15), 100, 135, 15),
    }


def l0_api(bitpack, bsvd, pnm, threefry, dev):
    """The L0 bitpack API as a user calls it: every name on CUDA tensors ==
    the same call on the CPU, exact, on L0_CASES (dist_matrix through K5,
    row_weight, weight, gf2_sum, row_sum and dist through K6); then the
    Gram pursuit on the card == the packed route, and ``learn`` on the gram
    route == the packed route, on doc512's patches at K = 64."""
    for N, K, cols, dirty in L0_CASES:
        a, b = l0_words(N, cols, N + cols, dirty), l0_words(K, cols, K, dirty)
        ga, gb = a.to(dev), b.to(dev)
        for name, fn in l0_calls(bitpack, cols, K).items():
            got, want = fn(ga, gb), fn(a, b)
            if got.device != ga.device or not torch.equal(got.cpu(), want):
                raise AssertionError(f"l0_api {name} [{N}] x [{K}] words "
                                     f"of {cols} bits: card != CPU")
        if dirty and torch.equal(bitpack.dist_matrix(a, b, cols),
                                 bitpack.dist_matrix(a & bitpack.from_i32(
                                     bitpack.trail_mask(cols)), b, cols)):
            raise AssertionError("l0_api: the dirty padding was not dirty")
        log(f"l0_api [{N}, {a.shape[1]}] x [{K}, {b.shape[1]}] words, {cols} "
            f"bits{', dirty padding' if dirty else ''}: "
            f"{len(l0_calls(bitpack, cols, K))} names, card == CPU, exact")
    doc = pnm.read_pbm(os.path.join(FIXTURES, "doc512.pbm"))
    X = bsvd.patchify_to_rows(torch.from_numpy(doc).to(dev), 16)
    D, A = bsvd.initialize_random_centroids(threefry.PRNGKey(34503498), X, 64)
    E = bsvd.residual(X, D, A)
    gram = bsvd.update_coefficients(E, D, A, distances="gram")
    packed = bsvd.update_coefficients(E, D, A, distances="packed")
    if not (all(torch.equal(x, y) for x, y in zip(gram[:2], packed[:2]))
            and int(gram[2]) == int(packed[2]) > 0
            and gram[0].device == X.device):
        raise AssertionError("gram pursuit != packed pursuit on the card")
    lg = bsvd.learn(X, K=64, init="random_centroids", distances="gram")
    lp = bsvd.learn(X, K=64, init="random_centroids")
    if lg[3] != lp[3] or not all(torch.equal(x, y)
                                 for x, y in zip(lg[:3], lp[:3])):
        raise AssertionError("learn: gram and packed routes differ")
    log(f"l0_api gram pursuit doc512 K=64: == packed route (E, A, "
        f"{int(gram[2])} rows changed); learn gram == packed, {lg[3]} "
        f"iterations")


def l0_times(bitpack, pd, dev, gpu):
    """The wrappers beside the kernels alone on L0_CASES:
    ``bitpack.dist_matrix`` (casts, K5, and on ragged rows the mask and the
    padding counts) against K5, ``bitpack.row_weight`` against K6, by CUDA
    events."""
    for N, K, cols, dirty in L0_CASES:
        a, b = l0_words(N, cols, N + cols, dirty), l0_words(K, cols, K, dirty)
        ga, gb = a.to(dev), b.to(dev)
        ia, ib = bitpack.to_i32(ga), bitpack.to_i32(gb)
        t = dict(dist_matrix=cuda_ms(
            lambda: bitpack.dist_matrix(ga, gb, cols), 20),
                 k5=cuda_ms(lambda: pd._launch_dist(ia, ib), 20),
                 row_weight=cuda_ms(lambda: bitpack.row_weight(ga), 20),
                 k6=cuda_ms(lambda: pd._launch_weight(ia), 20))
        log(f"l0_api [{N}, {a.shape[1]}] x [{K}, {b.shape[1]}] words of "
            f"{cols} bits: bitpack.dist_matrix {t['dist_matrix']:.4f} ms (K5 "
            f"alone {t['k5']:.4f} ms), bitpack.row_weight "
            f"{t['row_weight']:.4f} ms (K6 alone {t['k6']:.4f} ms), CUDA "
            f"events, mean of 20 [{gpu}]")


def device_times(fn, kernels, reps: int = 20):
    """Mean device time per call of fn() spent in the CUDA kernels whose
    names contain each of `kernels`, over reps calls, from torch.profiler;
    None where the trace shows no device time."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = prof.key_averages()
    us = [sum(e.device_time_total for e in ev if k in e.key) for k in kernels]
    return [u / 1e3 / reps if u else None for u in us]


def device_ms(fn, kernel: str, reps: int = 20):
    return device_times(fn, (kernel,), reps)[0]


def device_split(fn, matches, reps: int = 20) -> dict:
    """Mean device ms per call of fn() in each CUDA kernel whose name holds
    one of `matches`, by kernel name, from torch.profiler."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        hit = next((m for m in matches if m in e.key), None)
        if hit and e.device_time_total:
            name = e.key[e.key.index(hit):].split("(")[0].split("<")[0]
            out[name] = out.get(name, 0.0) + e.device_time_total / 1e3 / reps
    return out


def nd(v) -> str:
    return "not measured" if v is None else f"{v:.4f} ms"


def first_pursuit_inputs(bsvd, fn):
    """Run fn() and return copies of the (E, D, A) of its first
    ``update_coefficients`` call."""
    orig, got = bsvd.update_coefficients, []

    def spy(E, D, A, *a, **k):
        if not got:
            got.append((E.clone(), D.clone(), A.clone()))
        return orig(E, D, A, *a, **k)
    bsvd.update_coefficients = spy
    try:
        fn()
    finally:
        bsvd.update_coefficients = orig
    return got[0]


def sweep_route(bsvd, pd):
    """``update_coefficients`` on the packed route as it was before the
    pursuit kernel: ``pd.sweeps`` over the K5 and K6 kernels, one K5 launch
    and one host sync per sweep.  For the A/B only."""
    def update_coefficients(E, D, A, max_flips=None, distances="packed"):
        M, K = E.shape[1], D.shape[0]
        Ep = bsvd._pack(E)
        A = A.clone(memory_format=torch.contiguous_format)
        changed, _ = pd.sweeps(Ep, bsvd._pack(D), A,
                               K if max_flips is None else max_flips,
                               pd.packed_dist_matrix, pd.packed_row_weight)
        return bsvd.bitpack.unpack(Ep, M).to(E.dtype), A, changed
    return update_coefficients


def pursuit_kernel_times(pd, roofline, Ep0, Dp, A0, name, gpu, reps=20):
    """The pursuit kernel on fresh copies of (Ep0, A0): per call by CUDA
    events (the ctypes call: memset and kernel) and on the device by
    torch.profiler, against its bound from this run's passes; beside the
    plain version and the sweep route over the K5 and K6 kernels on the
    same inputs (host clock: they sync every sweep).  Returns (ms, device
    ms, plain ms, bound)."""
    N, nw = Ep0.shape
    K = Dp.shape[0]
    _, passes = pd._launch_pursuit(Ep0.clone(), Dp, A0.clone(), K)
    P = int(passes.sum())
    bound = roofline.bound_ms(**dict(zip(("popcounts", "nbytes"),
                                         roofline.pursuit_work(P, N, K, nw))))

    def fresh():
        copies = iter([(Ep0.clone(), A0.clone()) for _ in range(reps + 1)])

        def launch():
            Ep, A = next(copies)
            return pd._launch_pursuit(Ep, Dp, A, K)
        return launch
    ms = cuda_ms(fresh(), reps)
    dev_ms = device_ms(fresh(), "packed_pursuit_kernel", reps)
    plain = host_ms(lambda: pd.packed_pursuit_plain(Ep0.clone(), Dp,
                                                    A0.clone(), K), 3)
    sweep = host_ms(lambda: pd.sweeps(Ep0.clone(), Dp, A0.clone(), K,
                                      pd.packed_dist_matrix,
                                      pd.packed_row_weight), 5)
    pct = "" if dev_ms is None else f", {100 * bound[0] / dev_ms:.1f} % of bound"
    log(f"pursuit kernel, {name} ([{N}, {nw}] x [{K}, {nw}], {P} passes, "
        f"max {int(passes.max())}): {ms:.4f} ms per call (CUDA events), "
        f"{nd(dev_ms)} on the device (torch.profiler){pct}; bound "
        f"{bound[0]:.6f} ms ({bound[1]}); the sweep route (K5 + K6 kernels "
        f"per sweep) {sweep:.4f} ms, the plain version {plain:.3f} ms (host "
        f"clock) [{gpu}]")
    return ms, dev_ms, plain, bound


def pursuit_call_parts(bsvd, pd, E0, D0, A0, name, gpu, reps=20):
    """One packed ``update_coefficients`` call split into its steps, each
    timed alone by the host clock (synchronised, mean of reps): packing E
    and D, the copy of A, the pursuit's ctypes call (on fresh copies) and
    unpacking E, beside the whole call."""
    M, K = E0.shape[1], D0.shape[0]
    Ep0, Dp = bsvd._pack(E0), bsvd._pack(D0)
    copies = iter([(Ep0.clone(), A0.clone()) for _ in range(reps + 1)])

    def launch():
        Ep, A = next(copies)
        return pd._launch_pursuit(Ep, Dp, A, K)
    t = {"pack E": host_ms(lambda: bsvd._pack(E0), reps),
         "pack D": host_ms(lambda: bsvd._pack(D0), reps),
         "copy A": host_ms(lambda: A0.clone(
             memory_format=torch.contiguous_format), reps),
         "pursuit (one ctypes call)": host_ms(launch, reps),
         "unpack E": host_ms(lambda: bsvd.bitpack.unpack(Ep0, M).to(
             E0.dtype), reps),
         "whole call": host_ms(lambda: bsvd.update_coefficients(E0, D0, A0),
                               reps)}
    log(f"update_coefficients {name}, by step (host clock, synchronised, "
        f"mean of {reps}): " + ", ".join(f"{k} {v:.4f} ms"
                                          for k, v in t.items())
        + f" [{gpu}]")


def bsvd_times(codec, bsvd, pd, pnm, roofline, letter, dev, gpu):
    """K5 beside its plain version and the matmul route, K6 beside its plain
    version; the pursuit kernel against its bound and the sweep route at
    doc512 K = 64 and K = 512 (each learn's first call) and on the planted
    letter page; codec 11 end to end split into learning and the writer;
    and learning with the atom loop's and the pursuit's shares, the
    pursuit kernel and the sweep route in turns (kernel, sweep, sweep,
    kernel, twice)."""
    k5 = {}
    for N, M, K in BENCH_BSVD:
        E, D = dense_rows(N, M, K, dev)
        a, b = bsvd._pack(E), bsvd._pack(D)
        t = dict(
            k5=cuda_ms(lambda: pd._launch_dist(a, b), 20),
            plain=cuda_ms(lambda: pd.packed_dist_matrix_plain(a, b), 3),
            mxu=cuda_ms(lambda: bsvd.distances_to_atoms(E, D, "mxu"), 20),
            route=cuda_ms(lambda: bsvd.distances_to_atoms(E, D, "packed"),
                          20))
        k5[(N, M, K)] = t
        b5 = roofline.bound_ms(**dict(zip(
            ("popcounts", "nbytes"), roofline.k5_work(N, K, a.shape[1]))))
        log(f"K5 N={N} M={M} K={K}: kernel {t['k5']:.4f} ms, plain "
            f"{t['plain']:.3f} ms, mxu route (f32 matmul) {t['mxu']:.4f} ms, "
            f"packed route (pack + K5) {t['route']:.4f} ms; bound "
            f"{b5[0]:.6f} ms ({b5[1]}) [{gpu}]")
        dk = device_ms(lambda: pd._launch_dist(a, b), "packed_dist_kernel")
        log(f"  K5 device time alone (torch.profiler, mean of 20): "
            f"{nd(dk)} [{gpu}]")
    # the library yardsticks at codec 11's shape, on the unpacked rows
    E, D = dense_rows(1024, 256, 64, dev)
    Ef, Df = E.float(), D.float()
    if not torch.equal(torch.cdist(Ef, Df, p=0),
                       pd._launch_dist(bsvd._pack(E), bsvd._pack(D)).float()):
        raise AssertionError("torch.cdist(p=0) != K5 on codec 11's rows")
    lib5 = cuda_ms(lambda: torch.cdist(Ef, Df, p=0), 20)
    lib6 = cuda_ms(lambda: E.sum(dim=1), 20)
    log(f"library calls at [1024, 256] x [64, 256] bits: torch.cdist(p=0) "
        f"on float32 rows {lib5:.4f} ms (== K5), int8 rows.sum(1) "
        f"{lib6:.4f} ms [{gpu}]")
    a = bsvd._pack(E)
    k6 = cuda_ms(lambda: pd._launch_weight(a), 20)
    k6p = cuda_ms(lambda: pd.packed_row_weight_plain(a), 5)
    dk = device_ms(lambda: pd._launch_weight(a), "packed_weight_kernel")
    log(f"K6 [1024, 8]: kernel {k6:.4f} ms, plain {k6p:.4f} ms; device "
        f"time alone {nd(dk)} [{gpu}]")

    doc = pnm.read_pbm(os.path.join(FIXTURES, "doc512.pbm"))
    p = codec.CodecParams(codec=11, W=16, T=0, R=0)
    X = bsvd.patchify_to_rows(torch.from_numpy(doc).to(dev), 16)
    pursuit = {}
    for K in (64, 512):
        E0, D0, A0 = first_pursuit_inputs(
            bsvd, lambda: bsvd.learn(X, K=K, init="random_centroids",
                                     max_iters=1))
        pursuit[K] = pursuit_kernel_times(
            pd, roofline, bsvd._pack(E0), bsvd._pack(D0),
            A0.contiguous(), f"doc512 K={K}, first call of learn", gpu)
        pursuit_call_parts(bsvd, pd, E0, D0, A0.contiguous(),
                           f"doc512 K={K}, first call of learn", gpu)
    pursuit_kernel_times(pd, roofline, *letter, "planted letter page", gpu,
                         reps=10)

    def learn():
        E, D, A, _ = bsvd.learn(X, K=64, init="random_centroids")
        return bsvd.state_to_numpy(E, D, A)
    state = learn()
    blob = codec._write_bsvd(doc, p, *state, 64)
    t_learn = host_ms(learn, 5)
    t_write = host_ms(lambda: codec._write_bsvd(doc, p, *state, 64), 5)
    t_enc = host_ms(lambda: codec.encode(doc, p, device="cuda"), 5)
    t_dec = host_ms(lambda: codec.decode(blob), 5)
    log(f"codec 11 doc512 W=16 K=64 (host clock, mean of 5): encode "
        f"{t_enc:.3f} ms; of it, learning {t_learn:.3f} ms and _write_bsvd "
        f"{t_write:.3f} ms timed alone; decode {t_dec:.3f} ms [{gpu}]")
    sweeps = sweep_route(bsvd, pd)
    for K in (64, 512):
        runs = {"kernel": [], "sweeps": []}
        states = {}
        for route in ("kernel", "sweeps", "sweeps", "kernel") * 2 + ("mxu",):
            total, pur, atoms, iters, state = timed_learn(
                bsvd, X, K, sweeps if route == "sweeps" else None,
                "mxu" if route == "mxu" else "packed")
            states.setdefault(route, state)
            if route == "mxu":
                log(f"learn doc512 W=16 K={K} distances=mxu: {total:.3f} ms, "
                    f"{iters} iterations; atom loop {atoms:.3f} ms "
                    f"({100 * atoms / total:.1f} %), pursuit {pur:.3f} ms "
                    f"({100 * pur / total:.1f} %) [{gpu}]")
            else:
                runs[route].append((pur, total, atoms, iters))
        if not all(all(torch.equal(a, b) for a, b in zip(st, states["kernel"]))
                   for st in states.values()):
            raise AssertionError(f"learn K={K}: the routes' states differ")
        for route, rs in runs.items():
            pur = sorted(r[0] for r in rs)
            tot = sorted(r[1] for r in rs)
            log(f"learn doc512 W=16 K={K}, packed pursuit by the "
                f"{'pursuit kernel' if route == 'kernel' else 'sweep route (K5 + K6)'}"
                f": pursuit ms per learn {fmt(pur)} (median "
                f"{float(np.median(pur)):.3f}), learn {fmt(tot)} ms; atom loop "
                f"median {float(np.median([r[2] for r in rs])):.3f} ms, "
                f"{rs[0][3]} iterations [{gpu}]")
    c11 = k5[(1024, 256, 64)]
    return c11["k5"], c11["plain"], k6, k6p, lib5, lib6, pursuit[64]


def timed_learn(bsvd, X, K, route_fn, distances):
    """One learn of X at K (random-centroid init), with
    ``update_coefficients`` replaced by route_fn where given: (total ms,
    pursuit ms, atom-loop ms, iterations, (E, D, A)), synchronised timers."""
    orig = bsvd.update_coefficients
    if route_fn is not None:
        bsvd.update_coefficients = route_fn
    try:
        with _Timed(bsvd, ("update_coefficients",
                           "update_dictionary_steepest")) as tm:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            E, D, A, iters = bsvd.learn(X, K=K, init="random_centroids",
                                        distances=distances)
            torch.cuda.synchronize()
            total = (time.perf_counter() - t0) * 1e3
    finally:
        bsvd.update_coefficients = orig
    return (total, tm.ms["update_coefficients"],
            tm.ms["update_dictionary_steepest"], iters, (E, D, A))


def drive(name, fn, _cuda, needs):
    """Run one path with the launch counts set to 0 just before it; fail if
    a kernel it needs was never launched.  Returns the counts."""
    _cuda.launches.clear()
    fn()
    counts = dict(_cuda.launches)
    log(f"{name} path launches: {counts}")
    for k in needs:
        if counts.get(k, 0) < 1:
            raise AssertionError(f"{name} path never launched {k}")
    return counts


def stage_times(compress, fs, bitpack, codec, pnm, dev, gpu):
    """Per-stage times of the causal path at 1 page and a batch of 32."""
    doc = pnm.read_pbm(os.path.join(FIXTURES, "doc512.pbm"))
    p = codec.CodecParams(codec=8, W=16, R=128, strict=False)
    W, R, T_thresh = p.W, p.R, p.resolved_T()
    rows, cols = doc.shape
    ny, nx = rows // W, cols // W
    rs = np.random.RandomState(2)
    for B in STAGE_BATCHES:
        pages = np.stack([doc] + [np.roll(doc, (rs.randint(512),
                                                rs.randint(512)), axis=(0, 1))
                                  for _ in range(B - 1)])
        st = {}
        reps = 5
        st["upload"] = host_ms(lambda: compress._upload(pages, W, dev), reps)
        packed = compress._upload(pages, W, dev)

        def k1():
            img = bitpack.unpack(packed, nx * W)
            return img, fs.fused_search_select(
                img, ny, nx, W=W, R=R, T_thresh=T_thresh, cols=cols,
                invert=True)
        st["K1 (unpack+plane+kernel)"] = cuda_ms(k1, reps)
        img, (sel, oy, plane) = k1()
        st["finish"] = cuda_ms(lambda: compress.finish_analysis(
            img, sel, oy, plane, W=W, nx=nx), reps)
        out = compress.finish_analysis(img, sel, oy, plane, W=W, nx=nx)
        st["K2 (+records)"] = cuda_ms(
            lambda: compress.decide_records(out, W * W), reps)
        block = compress.decide_records(out, W * W)
        st["fetch"] = host_ms(lambda: block.cpu().numpy(), reps)
        bnp = block.cpu().numpy()
        st["native pack"] = host_ms(
            lambda: compress.pack_pages(bnp, pages, p), reps)
        st["K9 pack (card route)"] = host_ms(
            lambda: compress.pack_pages(block, pages, p), reps)
        st["end to end (encode_batch)"] = host_ms(
            lambda: compress.encode_batch(pages, p, device="cuda"), 3)
        parts = ", ".join(f"{k} {v:.3f} ms" for k, v in st.items())
        log(f"stages B={B} doc512 W=16 R=128 [{gpu}]: {parts}")
        log(f"  per page: {st['end to end (encode_batch)'] / B:.3f} ms, "
            f"{B * 1e3 / st['end to end (encode_batch)']:.1f} pages/s "
            f"[{gpu}]")
    return img, sel, out


def fax_pages(pnm, B: int) -> np.ndarray:
    """B fax pages (1,728 x 2,376, ITU-T T.4 fine A4): doc512 tiled, each
    after the first rolled by offsets from a fixed seed."""
    doc = pnm.read_pbm(os.path.join(FIXTURES, "doc512.pbm"))
    page = np.tile(doc, (5, 4))[:2376, :1728]
    rs = np.random.RandomState(20)
    return np.stack([page] + [np.roll(page, (rs.randint(2376),
                                             rs.randint(1728)), axis=(0, 1))
                              for _ in range(B - 1)])


def record_block(compress, pages, p, dev) -> torch.Tensor:
    """The card's decided record block of same-sized pages."""
    B, rows, cols = pages.shape
    return compress.encode_analyze_decided(
        compress._upload(pages, p.W, dev), W=p.W, R=p.R,
        T_thresh=p.resolved_T(), rows=rows, cols=cols)


def random_records(bitpack, compress, B, T, W, seed, dev) -> torch.Tensor:
    """A record block of random fields over their whole ranges (k_used 0-31,
    idx_len 0-63, weights 0..M with each end a tenth of the tiles, every
    mode), each residual of exactly its weight."""
    M = W * W
    rs = np.random.RandomState(seed)
    w = np.where(rs.rand(B, T) < 0.1, rs.choice([0, M], (B, T)),
                 rs.randint(0, M + 1, (B, T)))
    bits = np.argsort(rs.rand(B, T, M), axis=-1) < w[..., None]
    il = rs.randint(0, 64, (B, T))
    t = lambda a: torch.from_numpy(np.asarray(a, dtype=np.int64))
    return compress._record_block(
        t(rs.randint(0, 4, (B, T))), t(rs.randint(0, 2, (B, T))),
        t(rs.randint(0, 32, (B, T))), t(il), t(w),
        t(rs.randint(0, 2 ** 31 - 1, (B, T))),
        bitpack.pack(t(bits))).contiguous().to(dev)


def check_k9(rp, compress, bitpack, codec, pnm, _cuda, dev) -> int:
    """K9 (``recpack.pack_records``) against its plain version on the card,
    words and bit counts, and the real blocks' pages against native
    ``bic_pack_tiles``: doc512 at W = 16 and 8, a fax page, 32 fax pages in
    one launch, and random blocks over the fields' whole ranges at W = 16,
    8, 12 and 5 (a block of 16,500 tiles a page: two chunks of the
    offsets' scan).  Returns the mismatched words and pages (0)."""
    doc = pnm.read_pbm(os.path.join(FIXTURES, "doc512.pbm"))
    cases = []
    for W in (16, 8):
        p = codec.CodecParams(codec=8, W=W, R=128, strict=False)
        cases.append((f"doc512 W={W}", W, record_block(compress, doc[None],
                                                       p, dev), True))
    p16 = codec.CodecParams(codec=8, W=16, R=128, strict=False)
    fax = fax_pages(pnm, 32)
    cases.append(("fax page", 16, record_block(compress, fax[:1], p16, dev),
                  True))
    cases.append(("32 fax pages", 16, record_block(compress, fax, p16, dev),
                  True))
    for W, B, T in ((16, 2, 16500), (8, 3, 1001), (12, 2, 777), (5, 4, 333)):
        cases.append((f"random W={W} {B}x{T}", W,
                      random_records(bitpack, compress, B, T, W, W, dev),
                      False))
    worst = 0
    for name, W, block, real in cases:
        M = W * W
        before = _cuda.launches["pack_records"]
        words, nbits = rp.pack_records(block, M)
        torch.cuda.synchronize()
        if _cuda.launches["pack_records"] != before + 1:
            raise AssertionError(f"K9 {name}: not one launch")
        want_w, want_n = rp.pack_records_plain(block, M)
        bad = int((words != want_w).sum()) + int((nbits != want_n).sum())
        if real:
            starts, sizes, _ = rp.page_layout(nbits.cpu())
            buf = words.cpu().numpy().view(np.uint8)
            host = block.cpu().numpy()
            bad += sum(buf[s:s + n].tobytes()
                       != compress._pack_decided(host[b], b"", M)
                       for b, (s, n) in enumerate(zip(starts, sizes)))
        log(f"K9 {name}: {tuple(block.shape)} -> {int(nbits.sum())} bits, "
            f"mismatches {bad}" + (" (words, counts and pages vs native)"
                                   if real else " (words and counts)"))
        worst = max(worst, bad)
    if worst:
        raise AssertionError(f"K9 differs from its plain version: {worst}")
    return worst


def k9_times(rp, compress, codec, roofline, pnm, dev, gpu) -> dict:
    """K9 at a fax page and at 32 fax pages: per launch (CUDA events: the
    two zero fills and both kernels), its kernels' device time
    (torch.profiler), the bound (``roofline.k9_bytes``), the plain version
    on the card; and the pack stage both ways: ``pack_pages`` of the
    fetched block (native, host threads) and of the card's block (K9 and
    the fetches).  Returns each size's kernels-line figures."""
    p = codec.CodecParams(codec=8, W=16, R=128, strict=False)
    fax = fax_pages(pnm, 32)
    figures = {}
    for B in (1, 32):
        pages = fax[:B]
        block = record_block(compress, pages, p, dev)
        _, T, C = block.shape
        call = lambda: rp.pack_records(block, 256)
        k9 = cuda_ms(call, 20)
        parts = device_split(call, ("k9_", "fill", "Fill"), 20)
        k9d = sum(v for k, v in parts.items() if "k9_" in k) or None
        plain = cuda_ms(lambda: rp.pack_records_plain(block, 256), 1)
        nbits = call()[1].cpu()
        used = rp.page_layout(nbits)[2]
        nbytes = roofline.k9_bytes(B, T, C - 2, used)
        bound = roofline.bound_ms(nbytes=nbytes)
        bnp = block.cpu().numpy()
        host = host_ms(lambda: compress.pack_pages(bnp, pages, p), 3)
        card_route = host_ms(lambda: compress.pack_pages(block, pages, p), 10)
        log(f"K9 {B} fax page(s) [{B}, {T}, {C}]: {k9:.4f} ms per launch "
            f"(events), device {nd(k9d)} (torch.profiler: "
            + ", ".join(f"{k} {v:.4f}" for k, v in parts.items())
            + f" ms); bound {bound[0]:.6f} ms ({bound[1]}: {nbytes} B, "
            f"payload {int(nbits.sum())} bits); plain {plain:.3f} ms; "
            f"pack_pages: host route {host:.3f} ms (block fetched before), "
            f"card route {card_route:.3f} ms (K9, fetches, headers) [{gpu}]")
        figures[B] = (k9, plain, bound, None, k9d)
    return figures


def plane_by_conv(fs, img, W: int, He: int):
    """The library yardstick of K1's plane: one float32 convolution of the
    zero-padded page with the row kernel 2^(W-1) .. 2^0.  Returns (call,
    True if it equals the plane kernel's output)."""
    B, gh, gw = img.shape
    x = torch.zeros((B, 1, He, gw + W - 1), dtype=torch.float32,
                    device=img.device)
    x[:, 0, :gh, :gw] = img
    w = (2.0 ** torch.arange(W - 1, -1, -1, device=img.device)).view(
        1, 1, 1, W)
    call = lambda: torch.nn.functional.conv2d(x, w)
    same = torch.equal(call()[:, 0].round().to(torch.int64),
                       fs._launch_plane(img, W, He).to(torch.int64))
    return call, same


K2_SERIAL = os.path.join(REPO, "scripts", "k2_serial.cu")


def start_k2_serial_build(_cuda):
    """Start nvcc on scripts/k2_serial.cu, K2's serial design (one dependent
    step per tile), to run beside the kernels' own build."""
    out = os.path.join(REPO, "build", "k2_serial")
    os.makedirs(out, exist_ok=True)
    lib = os.path.join(out, "libk2_serial.so")
    proc = subprocess.Popen([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared",
                             "-I", _cuda.CSRC, "-o", lib, K2_SERIAL],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return proc, lib


def load_k2_serial(_cuda, dc, build):
    """Wait for the serial design's build; returns its launcher, with
    ``dc._launch``'s inputs and int32 [B, T, 3] out."""
    import ctypes
    proc, path = build
    _, err = proc.communicate(timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {K2_SERIAL}:\n{err[-3000:]}")
    lib = ctypes.CDLL(path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bic_decide_modes_serial.restype = i
    lib.bic_decide_modes_serial.argtypes = [p] * 5 + [i] * 6 + [p]

    def launch(w4, hc, il, enb, codec_id=8):
        B, T, _ = w4.shape
        out = torch.empty((B, T, 3), dtype=torch.int32, device=w4.device)
        use_pred, mcost, ncost = dc.mode_costs(codec_id)
        _cuda.check(lib.bic_decide_modes_serial(
            *(p(t.data_ptr()) for t in (w4, hc, il, enb, out)), B, T,
            enb.shape[0], int(use_pred), mcost, ncost,
            _cuda.stream(w4.device)), "bic_decide_modes_serial")
        return out
    return launch


def k2_times(dc, serial, roofline, a, a32, dev, gpu):
    """K2 against its serial design (``scripts/k2_serial.cu``) on the same
    inputs in one call (serial, rounds, rounds, serial): doc512 at 1 page
    and at the batch of ``a32``, by CUDA events and by torch.profiler; the
    random pair at T and 4T (M = 256) as ns per round, from the rounds the
    kernel counted with the guard off; the adversarial input; and doc512
    under each guard."""
    dk, ds = "decide_modes_kernel", "decide_modes_serial_kernel"
    rounds = lambda x, guard=dc.GUARD: _k2_rounds(dc, x, guard)
    for x in (a, a32):
        want = torch.stack(dc._launch(*x, codec_id=8), dim=-1)
        if not torch.equal(serial(*x), want):
            raise AssertionError("K2's serial design != K2")
    for B, x in ((1, a), (a32[0].shape[0], a32)):
        ev, dv = {}, {}
        for name in ("serial", "rounds", "rounds", "serial"):
            fn = ((lambda: serial(*x)) if name == "serial"
                  else (lambda: dc._launch(*x, codec_id=8)))
            ev.setdefault(name, []).append(cuda_ms(fn, 50))
            dv.setdefault(name, []).append(
                device_ms(fn, ds if name == "serial" else dk))
        r = rounds(x)
        log(f"K2 doc512 x{B} W=16 R=128 (serial, rounds, rounds, serial): "
            f"rounds design {fmt(ev['rounds'])} ms by events, "
            f"{fmt(dv['rounds'])} ms on the device (torch.profiler); serial "
            f"design {fmt(ev['serial'])} ms by events, {fmt(dv['serial'])} "
            f"ms on the device; rounds per page {min(r)}-{max(r)} (floor "
            f"{roofline.k2_rounds_floor(x[0].shape[1])}) [{gpu}]")
    T = a[0].shape[1]
    rs = np.random.RandomState(5)
    pair = []
    for n in (T, 4 * T):
        b = [torch.from_numpy(x.astype(np.int32)).to(dev) for x in (
            rs.randint(0, 257, (1, n, 4)), rs.rand(1, n) < 0.8,
            rs.randint(1, 12, (1, n)))] + [a[3]]
        pair.append((device_ms(lambda: dc._launch(*b, codec_id=8, guard=0),
                               dk),
                     rounds(b, 0)[0],
                     device_ms(lambda: dc._launch(*b, codec_id=8), dk),
                     rounds(b)[0], device_ms(lambda: serial(*b), ds)))
    (t1, r1, g1, q1, s1), (t4, r4, g4, q4, s4) = pair
    if None not in (t1, t4, s1, s4):
        per_round = (t4 - t1) / (r4 - r1)
        step = (s4 - s1) / (3 * T)
        log(f"K2 random M=256 (torch.profiler, mean of 20): guard off "
            f"{t1:.4f} ms in {r1} rounds at T={T}, {t4:.4f} ms in {r4} "
            f"rounds at T={4 * T}: {per_round * 1e6:.2f} ns per round "
            f"({per_round * 1e-3 * roofline.H100_CLOCK_HZ:.0f} clocks at 1.98 "
            f"GHz); with the guard {g1:.4f} / {g4:.4f} ms ({q1} / {q4} "
            f"rounds); serial design {s1:.4f} / {s4:.4f} ms, "
            f"{step * 1e6:.2f} ns per step [{gpu}]")
    else:
        log(f"K2 random M=256: device time not measured [{gpu}]")
    adv = [torch.from_numpy(x).to(dev) for x in adversarial_k2(256, T)]
    adv.append(a[3])
    ta, tsa = [], []
    for _ in range(2):
        tsa.append(device_ms(lambda: serial(*adv), ds))
        ta.append(device_ms(lambda: dc._launch(*adv, codec_id=8), dk))
    log(f"K2 adversarial M=256 T={T} (k changes on every tile; "
        f"torch.profiler): rounds design {fmt(ta)} ms ({rounds(adv)[0]} "
        f"rounds, the rest serial), serial design {fmt(tsa)} ms; guard off "
        f"{nd(device_ms(lambda: dc._launch(*adv, codec_id=8, guard=0), dk))}"
        f" [{gpu}]")
    guards = {g: device_ms(lambda: dc._launch(*a, codec_id=8, guard=g), dk)
              for g in (0, 2, 4)}
    log("K2 doc512 x1 by guard (torch.profiler): " + ", ".join(
        f"{g}: {nd(t)} ({rounds(a, g)[0]} rounds)" for g, t in guards.items())
        + f" [{gpu}]")


def _k2_rounds(dc, x, guard):
    r = torch.zeros(x[0].shape[0], dtype=torch.int32, device=x[0].device)
    dc._launch(*x, codec_id=8, rounds=r, guard=guard)
    return r.tolist()


def fmt(ts) -> str:
    return " / ".join("not measured" if t is None else f"{t:.4f}" for t in ts)


def kernel_times(compress, fs, dc, roofline, img, out, serial, dev, gpu):
    """K1's two kernels and K2 beside their plain versions at doc512's
    shapes (one page); K1's kernels also by torch.profiler, and K2 by
    ``k2_times``, at one page and at the batch `img` holds."""
    W, R, T_thresh, rows, cols = 16, 128, 1, 512, 512
    ny = nx = 32
    He = fs.plane_height(512, W, R)
    one = img[:1]
    E = fs._launch_plane(one, W, He)
    kw = dict(W=W, R=R, T_thresh=T_thresh, cols=cols, invert=True, y_base=0)
    k1 = cuda_ms(lambda: fs._launch(E, ny, nx, **kw), 20)
    k1p = cuda_ms(lambda: fs.fused_search_select_plain(E, ny, nx, **kw), 3)
    kpl = cuda_ms(lambda: fs._launch_plane(one, W, He), 20)
    kplp = cuda_ms(lambda: fs.to_i32(fs._field_plane(one, W, He, cols)), 20)
    conv, same = plane_by_conv(fs, one, W, He)
    kpll = cuda_ms(conv, 20) if same else None
    i32 = lambda t: t.to(torch.int32).contiguous()
    enb = torch.from_numpy(compress.enb_lut(W * W)).to(dev)
    a32 = (i32(out["weights4"]), i32(out["has_cands"]), i32(out["idx_len"]),
           enb)
    a = tuple(x[:1] for x in a32[:3]) + (enb,)
    k2 = cuda_ms(lambda: dc._launch(*a, codec_id=8), 20)
    k2p = cuda_ms(lambda: dc.decide_modes_plain(*a, codec_id=8), 2)
    log(f"K1 search kernel {k1:.4f} ms vs plain {k1p:.3f} ms; K1 plane "
        f"kernel {kpl:.4f} ms vs plain {kplp:.4f} ms, conv2d "
        f"{nd(kpll)} ({'== the plane' if same else 'not exact, not used'}); "
        f"K2 kernel {k2:.4f} ms vs plain {k2p:.3f} ms (doc512 x1, W=16 "
        f"R=128) [{gpu}]")
    for pages in (one, img):
        B = pages.shape[0]
        dpl, dse = device_times(
            lambda: fs.fused_search_select(pages, ny, nx, **kw),
            ("field_plane_kernel", "fused_search_kernel"), 20)
        per = "" if dse is None else f" ({dse / B:.4f} ms per page)"
        log(f"  K1 device time by kernel (torch.profiler, mean of 20 calls), "
            f"doc512 x{B}: plane {nd(dpl)}, search {nd(dse)}{per} [{gpu}]")
    T = ny * nx
    k2_times(dc, serial, roofline, a, a32, dev, gpu)
    k1_bound = roofline.bound_ms(
        popcounts=roofline.search_popcounts(rows, cols, W, R),
        nbytes=roofline.k1_bytes(*E.shape, T))
    pl_bound = roofline.bound_ms(
        nbytes=roofline.plane_bytes(1, rows, cols, He))
    k2_bound = roofline.bound_ms(nbytes=roofline.k2_bytes(1, T, W * W))
    return dict(k1=(k1, k1p, k1_bound, None),
                plane=(kpl, kplp, pl_bound, kpll),
                k2=(k2, k2p, k2_bound, None))


def new_path_times(compress, codec, st, sw, fs, bitpack, pnm, roofline, dev,
                   gpu):
    """K3 (whole, and the device time of each of its kernels) beside its
    plain version and the strict encode end to end, on doc512; then K4's
    (``banded_times``)."""
    doc = pnm.read_pbm(os.path.join(FIXTURES, "doc512.pbm"))
    g = grid_of(doc[None], 16, dev)[0]
    enb = torch.from_numpy(compress.enb_lut(256)).to(dev)
    kw = dict(W=16, R=128, T_thresh=1, cols=512)
    k3 = cuda_ms(lambda: st._launch(g, enb, **kw), 10)
    dev_plane, dev_g2, dev_serial = device_times(
        lambda: st._launch(g, enb, **kw),
        ("strict_plane_kernel", "strict_grid2_kernel", "strict_serial_kernel"),
        10)
    k3p = cuda_ms(lambda: st.strict_analyze_plain(g, enb, **kw), 2)
    ps = codec.CodecParams(codec=8, W=16, R=128, strict=True)
    e_strict = host_ms(lambda: compress.encode_strict(doc, ps, device="cuda"),
                       5)
    b3 = roofline.bound_ms(
        popcounts=roofline.search_popcounts(512, 512, 16, 128),
        nbytes=roofline.k3_bytes(512, 512, 16))
    floor = roofline.k3_chain_floor_ms(512, 512, 16, 128)
    log(f"K3 (plane + 31 grid-2 + 32 serial launches) {k3:.4f} ms vs "
        f"plain {k3p:.3f} ms (doc512, W=16 R=128) [{gpu}]")
    log(f"  K3 device time by kernel (torch.profiler, mean of 10 calls): "
        f"plane {nd(dev_plane)}, grid-2 pass {nd(dev_g2)}, serial pass "
        f"{nd(dev_serial)}; bound {b3[0]:.4f} ms; chain floor (derived: grid "
        f"1's popcounts on one SM) {floor:.4f} ms [{gpu}]")
    log(f"end to end: encode_strict doc512 W=16 R=128 {e_strict:.3f} ms "
        f"[{gpu}]")
    k4, plane = banded_times(compress, codec, sw, fs, bitpack, pnm, roofline,
                             dev, gpu)
    return k3, k3p, b3, k4, plane


def banded_times(compress, codec, sw, fs, bitpack, pnm, roofline, dev, gpu):
    """K4's plane and search kernels beside their plain versions (the plain
    search is the map route: the banded maps and the selection over them)
    on doc512 at W = 64, R = 128, by CUDA events and by torch.profiler, the
    search also on the letter page; then the W = 64 encode split into
    stages.  Returns the kernels-line figures of the search and the plane."""
    doc = pnm.read_pbm(os.path.join(FIXTURES, "doc512.pbm"))
    W, R, rows, cols = 64, 128, 512, 512
    ny = nx = 8
    p = codec.CodecParams(codec=8, W=W, R=R, strict=False)
    kw = dict(W=W, R=R, T_thresh=p.resolved_T(), cols=cols, invert=True)
    He = fs.plane_height(ny * W, W, R)
    img = grid_of(doc[None], W, dev)
    E = sw._launch_plane(img, W, He)
    k4 = cuda_ms(lambda: sw._launch(E, ny, nx, **kw), 20)
    k4p = cuda_ms(lambda: sw.select_windows_plain(E, ny, nx, **kw), 3)
    pl = cuda_ms(lambda: sw._launch_plane(img, W, He), 20)
    plp = cuda_ms(lambda: fs._field_plane(img, W, He, nx * W), 20)
    dpl, dse, dde = device_times(
        lambda: sw.select_windows(img, ny, nx, **kw),
        ("banded_plane_kernel", "banded_search_kernel",
         "banded_decode_kernel"), 20)
    k4_bound = lambda *shape: roofline.bound_ms(**dict(zip(
        ("popcounts", "nbytes"), roofline.k4_work(*shape))))
    b4 = k4_bound(rows, cols, W, R)
    bpl = roofline.bound_ms(
        nbytes=roofline.plane_bytes(1, rows, cols, He, word=8))
    pct = "" if dse is None else f" ({100 * b4[0] / dse:.1f} % of bound)"
    log(f"K4 search kernel {k4:.4f} ms vs the plain map route (banded maps "
        f"+ selection) {k4p:.3f} ms; plane kernel {pl:.4f} ms vs plain "
        f"{plp:.4f} ms (doc512, W=64 R=128, CUDA events) [{gpu}]")
    log(f"  K4 device time by kernel (torch.profiler, mean of 20 calls): "
        f"plane {nd(dpl)} (bound {bpl[0]:.6f} ms, {bpl[1]}), search "
        f"{nd(dse)}, decode {nd(dde)}; search bound {b4[0]:.4f} ms "
        f"({b4[1]}){pct} [{gpu}]")
    letter = letter_page(doc)
    lrows, lcols = letter.shape
    lny, lnx = -(-lrows // W), -(-lcols // W)
    limg = grid_of(letter[None], W, dev)
    lkw = dict(kw, cols=lcols)
    lse, = device_times(lambda: sw.select_windows(limg, lny, lnx, **lkw),
                        ("banded_search_kernel",), 10)
    lb = k4_bound(lrows, lcols, W, R)
    log(f"  K4 search on the letter page {lrows}x{lcols} (T={lny * lnx}): "
        f"{nd(lse)} on the device, bound {lb[0]:.4f} ms ({lb[1]}) [{gpu}]")

    st = {}
    reps = 5
    st["upload"] = host_ms(lambda: compress._upload(doc[None], W, dev), reps)
    packed = compress._upload(doc[None], W, dev)
    st["unpack"] = cuda_ms(lambda: bitpack.unpack(packed, nx * W), reps)
    img = bitpack.unpack(packed, nx * W)
    st["plane"] = cuda_ms(lambda: sw._launch_plane(img, W, He), reps)
    E = sw._launch_plane(img, W, He)
    st["K4"] = cuda_ms(lambda: sw._launch(E, ny, nx, **kw), reps)
    sel, oy, _ = sw.select_windows(img, ny, nx, **kw)
    st["dense finish"] = cuda_ms(lambda: compress.finish_analysis(
        img, sel, oy, None, W=W, nx=nx), reps)
    out = compress.finish_analysis(img, sel, oy, None, W=W, nx=nx)
    st["K2 (+records, M=4096)"] = cuda_ms(
        lambda: compress.decide_records(out, W * W), reps)
    block = compress.decide_records(out, W * W)
    st["fetch"] = host_ms(lambda: block.cpu().numpy(), reps)
    bnp = block.cpu().numpy()
    st["native pack"] = host_ms(
        lambda: compress.pack_pages(bnp, doc[None], p), reps)
    st["end to end (encode)"] = host_ms(
        lambda: compress.encode(doc, p, device="cuda"), reps)
    log(f"stages doc512 W=64 R=128 [{gpu}]: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in st.items()))
    e_letter = host_ms(lambda: compress.encode(letter, p, device="cuda"), 2)
    log(f"end to end: encode letter {lrows}x{lcols} W=64 R=128 "
        f"{e_letter:.3f} ms "
        f"(host clock, mean of 2) [{gpu}]")
    return (k4, k4p, b4, None), (pl, plp, bpl, None)


# (rows, cols, stripe_rows, n_lanes) of K7's random-table cases: pads at
# the stripes' ends, a short last stripe, one row, fewer pixels than lanes,
# part-filled warps, one lane and 255 lanes (8 warps)
K7_RANDOM = [(64, 64, 32, 32), (75, 101, 19, 4), (75, 101, 38, 8),
             (1, 7, 1, 32), (129, 67, 65, 64), (33, 65, 17, 33),
             (50, 50, 25, 255), (96, 80, 96, 1)]
# K7's densest emission (f = 1 at every step, a word on ~3 steps in 4):
# short last stripes (18 and 1 rows) at 1, 33 and 255 lanes
K7_DENSE = [(75, 101, 19, 1), (100, 37, 33, 33), (75, 101, 38, 255)]
SCAB_BYTES = {"host": 15097, "device": 14402}
K7_BATCHES = (1, 8, 32)


def k7_cases(codec, pnm) -> list:
    """(name, page, params, n_lanes) of every codec-13 case of the CPU
    tests (tests/test_torch_codec13.py): three fixtures at both templates
    and T = 0, 2, 4, the edge geometries at T = 2, text64 at six lane
    counts; then doc512 and the letter page at the defaults."""
    fx = lambda n: pnm.read_pbm(os.path.join(FIXTURES, n))
    P = lambda W=0, T=0: codec.CodecParams(codec=13, W=W, T=T, R=0)
    cases = [(f"{n} W={W} T={T}", fx(n), P(W, T), 32)
             for n in ("text256.pbm", "ragged75x101.pbm", "text64.pbm")
             for W, T in ((10, 0), (12, 2), (12, 4), (0, 0))]
    rng = np.random.RandomState(7)
    edges = [np.zeros((33, 65), bool), np.ones((16, 16), bool),
             rng.rand(1, 7) < 0.5, rng.rand(129, 67) < 0.93,
             np.eye(50, dtype=bool)]
    cases += [(f"edge {e.shape[0]}x{e.shape[1]} T=2", e, P(0, 2), 32)
              for e in edges]
    cases += [(f"text64.pbm T=2 n_lanes={nl}", fx("text64.pbm"), P(0, 2), nl)
              for nl in (1, 4, 8, 33, 64, 255)]
    doc = fx("doc512.pbm")
    return cases + [("doc512", doc, P(), 32),
                    ("letter 3300x2550", letter_page(doc), P(), 32)]


def scab_inputs(compress, codec, rd, img, p, dev):
    """K7's inputs for one page as the mode-2 path builds them on the card:
    (bits, ctx, p_used) with a batch dim of 1, and the stripe height."""
    tmpl, _, sr = codec.scab_stripes(p, img.shape[0])
    bits = compress.scab_upload(img, dev)
    ctx = compress.scab_ctx_map(bits, tmpl=tmpl, stripe_rows=sr)
    p_used = rd.build_table(*rd.count_contexts(ctx, bits))[3]
    return (bits[None], ctx[None], p_used.to(torch.int16)[None]), sr


def check_k7(rd, compress, codec, pnm, dev) -> int:
    """K7 == ``rans_stripes_plain`` (the reverse loop and pack_varlen) on
    the same CUDA tensors: random tables on two pages at K7_RANDOM's
    geometries, then every codec-13 case with the table its page builds on
    the card.  States, stream words and bit counts exact.  Returns the
    worst error."""
    worst = 0

    def one(name, a, sr, nl):
        got = rd._launch(*a, stripe_rows=sr, n_lanes=nl)
        want = rd.rans_stripes_plain(*a, stripe_rows=sr, n_lanes=nl)
        torch.cuda.synchronize()
        err = max(0 if torch.equal(g, w) else
                  int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
                  for g, w in zip(got, want))
        B, rows, cols = a[0].shape
        S, steps, _ = rd.stripe_geometry(rows, cols, sr, nl)
        log(f"K7 {name}: B={B} {rows}x{cols} S={S} N={nl} steps={steps} "
            f"stream {int(got[2].sum()) // 8} B max_abs_err={err}")
        if err != 0:
            raise AssertionError(f"K7 disagrees with its plain version on "
                                 f"{name}")
        return err

    for rows, cols, sr, nl in K7_RANDOM:
        rs = np.random.RandomState(rows * cols + nl)
        bits = torch.from_numpy(rs.rand(2, rows, cols) < 0.3).to(dev)
        ctx = torch.stack([compress.scab_ctx_map(b, tmpl=12, stripe_rows=sr)
                           for b in bits])
        p_used = torch.from_numpy(
            rs.randint(1, 4096, (2, 4096)).astype(np.int16)).to(dev)
        worst = max(worst, one("random table", (bits, ctx, p_used), sr, nl))
    for rows, cols, sr, nl in K7_DENSE:
        rs = np.random.RandomState(rows + nl)
        bits = torch.from_numpy(rs.rand(2, rows, cols) < 0.5).to(dev)
        p_used = torch.full((2, 4096), 4095, dtype=torch.int16, device=dev)
        p_used[:, 1] = 1
        worst = max(worst, one("densest emission",
                               (bits, bits.to(torch.int16), p_used), sr, nl))
    rs = np.random.RandomState(3)
    bits = torch.from_numpy(rs.rand(3, 100, 37) < np.array(
        [0.05, 0.3, 0.7])[:, None, None]).to(dev)
    ctx = torch.stack([compress.scab_ctx_map(b, tmpl=12, stripe_rows=33)
                       for b in bits])
    p_used = torch.from_numpy(
        rs.randint(1, 4096, (3, 4096)).astype(np.int16)).to(dev)
    worst = max(worst, one("3 pages of different content",
                           (bits, ctx, p_used), 33, 32))
    for name, img, p, nl in k7_cases(codec, pnm):
        a, sr = scab_inputs(compress, codec, rd, img, p, dev)
        worst = max(worst, one(name, a, sr, nl))
        if name == "doc512":
            # the kernel's stream-order pass as torch ops, on the card
            twin = rd.rans_stripes_twin(*a, stripe_rows=sr, n_lanes=nl)
            got = rd._launch(*a, stripe_rows=sr, n_lanes=nl)
            if not all(torch.equal(g, w) for g, w in zip(got, twin)):
                raise AssertionError("K7 != its stream-order twin on doc512")
            log("K7 doc512: == rans_stripes_twin (the plain loop through "
                "stream_order_plain) on the card")
    return worst


def k7_batch_times(compress, codec, rd, roofline, doc, dev, gpu):
    """K7 at B = 1, 8 and 32 doc512 pages a launch (the corpus rolls of
    ``np.random.RandomState(0)``), each page with its own table: device
    time per launch (torch.profiler) and per page, at 4 stripes x 32 lanes
    a page."""
    rng = np.random.RandomState(0)
    pages = [np.roll(doc, (int(rng.randint(512)), int(rng.randint(512))),
                     axis=(0, 1)) for _ in range(max(K7_BATCHES))]
    p = codec.CodecParams(codec=13, W=0, T=0, R=0)
    ins = [scab_inputs(compress, codec, rd, img, p, dev) for img in pages]
    sr = ins[0][1]
    _, steps, _ = rd.stripe_geometry(512, 512, sr, 32)
    floor = roofline.rans_work(512 * 512, steps, 4, 32)[1]
    out = {}
    for B in K7_BATCHES:
        a = tuple(torch.cat([x[0][i] for x in ins[:B]]) for i in range(3))
        k7 = lambda: rd.rans_encode(*a, stripe_rows=sr)
        ms = cuda_ms(k7, 10)
        dk = device_ms(k7, "rans_encode_kernel", 10)
        out[B] = (ms, dk)
        log(f"K7 doc512 corpus, B={B} pages a launch ({4 * B} blocks): "
            f"{ms:.4f} ms per launch (events), device {nd(dk)}, per page "
            f"{ms / B:.4f} (events), "
            f"{'not measured' if dk is None else f'{dk / B:.4f}'} "
            f"(device); one page's chain floor {floor:.4f} ms [{gpu}]")
    return out


def scab_path(compress, codec, pnm):
    """Codec 13 as a user calls it: ``encode_scab`` on the card in both
    entropy modes, on doc512 and the letter page.  Mode 1 == ``codec.encode``
    (the native coder's own context scan), mode 2 == the CPU port's stream;
    both decode to the page through the native decoders."""
    doc = pnm.read_pbm(os.path.join(FIXTURES, "doc512.pbm"))
    p = codec.CodecParams(codec=13, W=0, T=0, R=0)
    for name, img in (("doc512", doc), ("letter 3300x2550", letter_page(doc))):
        for entropy in ("host", "device"):
            t0 = time.perf_counter()
            blob = compress.encode_scab(img, p, entropy=entropy,
                                        device="cuda")
            t = time.perf_counter() - t0
            if entropy == "host":
                ref, what = codec.encode(img, p), "codec.encode"
            else:
                ref, what = compress.encode_scab(
                    img, p, entropy="device", device="cpu"), "the CPU port"
            if blob != ref:
                raise AssertionError(f"codec 13 {name} ({entropy}) != "
                                     f"{what}")
            if name == "doc512" and len(blob) != SCAB_BYTES[entropy]:
                raise AssertionError(f"codec 13 doc512 ({entropy}) is "
                                     f"{len(blob)} B, not "
                                     f"{SCAB_BYTES[entropy]}")
            if not np.array_equal(codec.decode(blob), img):
                raise AssertionError(f"codec 13 {name} ({entropy}) does not "
                                     f"decode to the page")
            log(f"codec 13: {name} entropy={entropy} -> {len(blob)} B, == "
                f"{what}, decodes ({t * 1e3:.1f} ms wall, first call)")


def no_plain_rans_on_card(rd, fn):
    """Run fn() with a spy on ``rans_encode_plain`` (K7's plain loop); fail
    if it was called on a CUDA tensor."""
    orig, devices = rd.rans_encode_plain, []

    def spy(f, b):
        devices.append(f.device.type)
        return orig(f, b)
    rd.rans_encode_plain = spy
    try:
        fn()
    finally:
        rd.rans_encode_plain = orig
    log(f"scab path: rans_encode_plain called {len(devices)} times, on "
        f"{sorted(set(devices)) or 'no device'}")
    if "cuda" in devices:
        raise AssertionError("the plain rANS loop ran on the card")


def scab_times(compress, codec, rd, bitpack, pnm, roofline, dev, gpu):
    """Codec 13 on doc512 and the letter page: the mode-2 stages (CUDA
    events on the card, the host clock for upload, fetch and serialize),
    the host-entropy stages, ``encode_scab`` end to end in both modes, and
    K7 by events and torch.profiler beside its bound, its chain floor and
    its plain version.  Returns doc512's kernels-line figures."""
    doc = pnm.read_pbm(os.path.join(FIXTURES, "doc512.pbm"))
    p = codec.CodecParams(codec=13, W=0, T=0, R=0)
    figures = {}
    for name, img, reps in (("doc512", doc, 5),
                            ("letter 3300x2550", letter_page(doc), 3)):
        rows, cols = img.shape
        tmpl, S, sr = codec.scab_stripes(p, rows)
        st = {}
        st["upload"] = host_ms(lambda: compress._upload(img[None], 1, dev),
                               reps)
        packed = compress._upload(img[None], 1, dev)
        st["unpack"] = cuda_ms(lambda: bitpack.unpack(packed, cols), reps)
        bits = bitpack.unpack(packed, cols)[0]
        cmap = lambda: compress.scab_ctx_map(bits, tmpl=tmpl, stripe_rows=sr)
        st["context map"] = cuda_ms(cmap, reps)
        ctx = cmap()
        st["counts"] = cuda_ms(lambda: rd.count_contexts(ctx, bits), reps)
        ones, total = rd.count_contexts(ctx, bits)
        st["table"] = cuda_ms(lambda: rd.build_table(ones, total), reps)
        q, transmit, _, p_used = rd.build_table(ones, total)
        a = (bits[None], ctx[None], p_used.to(torch.int16)[None])
        k7 = lambda: rd.rans_encode(*a, stripe_rows=sr)
        st["K7"] = cuda_ms(k7, reps)
        st["table pack"] = cuda_ms(lambda: rd.pack_table(q, transmit), reps)
        res = compress.scab_rans_page(bits, tmpl=tmpl, stripe_rows=sr)
        st["fetch"] = host_ms(lambda: compress.fetch_rans_fields(res), reps)
        f = compress.fetch_rans_fields(res)
        st["serialize (+ header, CRC)"] = host_ms(
            lambda: codec._header(p, rows, cols, codec.image_crc(img))
            + compress._serialize_scab_rans(f, tmpl, S, sr, 32), reps)
        st["end to end (encode_scab, device entropy)"] = host_ms(
            lambda: compress.encode_scab(img, p, entropy="device",
                                         device="cuda"), reps)
        log(f"codec 13 mode-2 stages, {name} [{gpu}]: " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in st.items()))
        h = {}
        h["upload + unpack + map"] = host_ms(
            lambda: compress.scab_ctx_map(compress.scab_upload(img, dev),
                                          tmpl=tmpl, stripe_rows=sr), reps)
        h["map fetch"] = host_ms(lambda: ctx.cpu().numpy(), reps)
        cnp = ctx.cpu().numpy().view(np.uint16)
        h["native coder"] = host_ms(
            lambda: codec._encode_scab(img, p, ctx_pre=cnp), reps)
        h["end to end (encode_scab, host entropy)"] = host_ms(
            lambda: compress.encode_scab(img, p, device="cuda"), reps)
        h["codec.encode (native scan, no card)"] = host_ms(
            lambda: codec.encode(img, p), reps)
        log(f"codec 13 mode-1 stages, {name} [{gpu}]: " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in h.items()))

        ms = cuda_ms(k7, 20)
        dk7 = device_ms(k7, "rans_encode_kernel", 10)
        plain = cuda_ms(lambda: rd.rans_stripes_plain(*a, stripe_rows=sr), 1)
        _, steps, _ = rd.stripe_geometry(rows, cols, sr, 32)
        nbytes, floor = roofline.rans_work(rows * cols, steps, S, 32,
                                           int(res["bits"].sum()) // 8)
        bound = roofline.bound_ms(nbytes=nbytes)
        ratio = "" if dk7 is None else (
            f", device {dk7 / floor:.2f}x the floor, "
            f"{dk7 * 1e-3 * roofline.H100_CLOCK_HZ / steps:.0f} clocks a "
            f"step at {roofline.H100_CLOCK_HZ / 1e9:.2f} GHz")
        log(f"K7 {name}: {ms:.4f} ms per launch (CUDA events), device "
            f"{nd(dk7)} (torch.profiler, mean of 10); bound {bound[0]:.6f} "
            f"ms ({bound[1]}), chain floor {floor:.4f} ms ({S} stripes x 32 "
            f"lanes, {steps} steps){ratio}; plain {plain:.3f} ms [{gpu}]")
        figures[name] = (ms, plain, bound, None)
    k7_batch_times(compress, codec, rd, roofline, doc, dev, gpu)
    return figures["doc512"]


# codec 10 and codec 13 mode 2 on the JAX bench stack (JAX bench.py:522,
# BENCH.json pgm8_bytes / pgm8_rans_bytes)
GRAY_BYTES = {"codec 10": 104658, "rans": 76918}
GRAY_BACKENDS = ("device", "device-assembly", "device-rans")


def gray_page(img: np.ndarray) -> np.ndarray:
    """The JAX bench's 8-bit page from a bilevel one: cumsum along rows,
    times 7, mod 256 (bench.py:522)."""
    return (np.cumsum(img, axis=1) * 7 % 256).astype(np.uint32)


def gray_cases(pnm) -> list:
    """(name, 8-bit page): the bench stack (doc512), a 300-dpi US letter
    page made gray the same way, and the bench page with random low two
    bits, a scan's noise, whose gray-coded low plane has a dense MED
    residual (JAX sends it past its run-array ladder to the native coder)."""
    doc = pnm.read_pbm(os.path.join(FIXTURES, "doc512.pbm"))
    g = gray_page(doc)
    noise = np.random.RandomState(12).randint(0, 4, g.shape).astype(np.uint32)
    return [("bench 512x512", g),
            ("letter 3300x2550", gray_page(letter_page(doc))),
            ("noisy 512x512", g ^ noise)]


def gray_residuals(compress, bitplanes, gray, dev):
    """The page's gray-coded planes (host) and their MED residuals on the
    card, as ``encode_planes_device`` makes them."""
    planes = bitplanes.decompose(gray ^ (gray >> 1), 255)
    res = compress.med_planes(compress.upload_planes(planes, dev),
                              planes.shape[2])
    return planes, res


def check_k8(eg, compress, bitplanes, pnm, dev) -> int:
    """K8 == ``eg_encode_plain`` (torch.nonzero runs, the transition maps,
    the composition scan, pack_varlen) on the same CUDA tensors, word for
    word and bit count for bit count: residual planes at densities 0 to 1,
    odd widths, a first run of 0 and of 7, run counts at each rung of
    ``run_cap`` (and one past it), a single one at the last pixel, ones only
    in the first and last words, chunks of 512 ones, words that are not a
    whole number of chunks, the whole stacks of the bench page, the letter
    page and the noisy page, whose low plane is past the ladder, and a color
    page's 24 planes.  Returns the worst error."""
    worst = 0

    def one(name, res, cols):
        nonlocal worst
        got = eg._launch(res, cols)
        want = eg.eg_encode_plain(res, cols)
        torch.cuda.synchronize()
        err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
                  for g, w in zip(got, want))
        P, rows, _ = res.shape
        runs = int(eg.run_counts(res, cols).sum())
        log(f"K8 {name}: P={P} {rows}x{cols} runs={runs} payload "
            f"{int(got[1].sum()) // 8} B max_abs_err={err}")
        if err != 0:
            raise AssertionError(f"K8 disagrees with its plain version on "
                                 f"{name}")
        worst = max(worst, err)

    def up(bits):
        return compress.upload_planes(bits, dev)

    rs = np.random.RandomState(10)
    for d in (0.0, 0.02, 0.3, 0.5, 0.9, 1.0):
        one(f"density {d}", up(rs.rand(1, 512, 512) < d), 512)
    for rows, cols in ((33, 61), (75, 101)):
        one("odd width", up(rs.rand(2, rows, cols) < np.array(
            [0.1, 0.3])[:, None, None]), cols)
    for first in (0, 7):
        bits = rs.rand(1, 256, 256) < 0.05
        bits.reshape(-1)[:first + 1] = False
        bits.reshape(-1)[first] = True
        one(f"first run {first}", up(bits), 256)
    n = 512 * 512
    rungs = [eg.run_cap(n, 0), eg.run_cap(n, 0) + 1,
             eg.run_cap(n, 1), eg.run_cap(n, 1) + 1]
    bits = np.zeros((4, n), bool)
    for i, runs in enumerate(rungs):   # runs - 1 ones, the last pixel 0
        bits[i, rs.choice(n - 1, runs - 1, replace=False)] = True
    res = up(bits.reshape(4, 512, 512))
    got = eg.run_counts(res, 512).cpu().numpy()
    if list(got) != rungs:
        raise AssertionError(f"run counts {list(got)} != the rungs {rungs}")
    one(f"run counts {rungs}", res, 512)
    last = np.zeros((2, 300, 200), bool)
    last[:, -1, -1] = True            # one run across every chunk
    one("a single one at the last pixel", up(last), 200)
    ends = np.zeros((2, 100, 300), bool)
    ends[:, 0, :32] = rs.rand(2, 32) < 0.5
    ends[:, -1, 288:] = True
    one("ones only in the first and last words", up(ends), 300)
    full = rs.rand(2, 64, 512) < 0.05
    full[:, 5:7] = True               # rows of 16 words: chunks of 512 ones
    one("chunks of 512 ones", up(full), 512)
    one("37 x 70: 111 words, not whole chunks",
        up(rs.rand(3, 37, 70) < 0.3), 70)
    for name, gray in gray_cases(pnm):
        _, res = gray_residuals(compress, bitplanes, gray, dev)
        rows, cols = gray.shape
        counts = eg.run_counts(res, cols).tolist()   # plane 0 the lowest
        if name.startswith("noisy") and counts[0] <= eg.run_cap(rows * cols,
                                                                1):
            raise AssertionError(f"{name}: the low plane's {counts[0]} runs "
                                 f"are not past the ladder")
        one(f"{name} stack (runs per plane {counts})", res, cols)
    g = gray_cases(pnm)[0][1]
    planes = np.concatenate([bitplanes.decompose(ch ^ (ch >> 1), 255)
                             for ch in (g, np.roll(g, 100, axis=1), g.T)])
    res = compress.med_planes(up(planes), 512)
    one("a color page's 24 planes in one launch", res, 512)
    return worst


def gray_path(codec, pnm, backend: str):
    """Grayscale as a user calls it: ``encode_pgm`` of the bench stack, the
    letter page and the noisy page, and ``encode_ppm`` of an RGB page of three bench-like
    channels, with `backend` on the card; each stream decodes to its
    input, codec 10 == the host route (numpy MED, native EG) byte for byte,
    the bench stack at the JAX package's size.  Returns the K7 stacks it
    coded (device-rans: one per page, three per color page)."""
    p10 = codec.CodecParams(codec=10, W=0, T=0, R=0)
    params = None if backend == "device-rans" else p10
    what = "rans" if backend == "device-rans" else "codec 10"
    stacks = 0
    for name, gray in gray_cases(pnm):
        t0 = time.perf_counter()
        blob = codec.encode_pgm(gray, 255, params, backend=backend,
                                device="cuda")
        t = time.perf_counter() - t0
        stacks += 1
        if backend != "device-rans" and blob != codec.encode_pgm(
                gray, 255, p10, backend="host"):
            raise AssertionError(f"{name} ({backend}) != the host codec-10 "
                                 f"stream")
        if name.startswith("bench") and len(blob) != GRAY_BYTES[what]:
            raise AssertionError(f"{name} ({backend}) is {len(blob)} B, not "
                                 f"{GRAY_BYTES[what]}")
        back, maxval = codec.decode_pgm(blob)
        if maxval != 255 or not np.array_equal(back, gray):
            raise AssertionError(f"{name} ({backend}) does not decode")
        log(f"gray: {name} backend={backend} -> {len(blob)} B ({what}), "
            f"decodes{', == host codec 10' if what == 'codec 10' else ''} "
            f"({t * 1e3:.1f} ms wall, first call)")
    g = gray_cases(pnm)[0][1]
    rgb = (g << 16) | (np.roll(g, 100, axis=1) << 8) | g.T
    blob = codec.encode_ppm(rgb, 255, params, backend=backend, device="cuda")
    stacks += 3
    if backend != "device-rans" and blob != codec.encode_ppm(rgb, 255, p10):
        raise AssertionError(f"RGB ({backend}) != the host codec-10 stream")
    back, maxval = codec.decode_ppm(blob)
    if maxval != 255 or not np.array_equal(back, rgb):
        raise AssertionError(f"RGB ({backend}) does not decode")
    log(f"color: RGB 512x512 backend={backend} -> {len(blob)} B, decodes")
    return stacks


def gray_drives(codec, pnm, _cuda) -> dict:
    """The three device backends, each driven with the launch counts reset:
    one K8 launch per stack on device-assembly (every plane, the noisy
    page's dense low plane included, coded by K8) and none on the other
    routes, one K7 launch per stack on device-rans and none on the codec-10
    routes."""
    counts = {}
    for backend in GRAY_BACKENDS:
        stacks = []
        needs = {"device": (), "device-assembly": ("eg_encode",),
                 "device-rans": ("rans_encode",)}[backend]
        c = drive(f"gray {backend}", lambda: stacks.append(
            gray_path(codec, pnm, backend)), _cuda, needs)
        k8, k7 = c.get("eg_encode", 0), c.get("rans_encode", 0)
        if k8 != (stacks[0] if backend == "device-assembly" else 0):
            raise AssertionError(f"{k8} K8 launches for {stacks[0]} stacks "
                                 f"on the {backend} route")
        if k7 != (stacks[0] if backend == "device-rans" else 0):
            raise AssertionError(f"{k7} K7 launches for {stacks[0]} stacks "
                                 f"on the {backend} route")
        counts[backend] = c
    return counts


def gray_times(codec, compress, eg, rd, bitpack, bitplanes, pnm, roofline,
               dev, gpu):
    """The grayscale stages on each gray page: upload, MED, K8 (one launch
    for the stack; CUDA events, and torch.profiler kernel by kernel, the
    payload's zero fill beside them), the words' fetch, the K7 stack's
    stages and its fetch, then ``encode_pgm`` end to end per backend
    (host clock).  K8 beside its plain version and its bound
    (``roofline.eg_work``).  Returns the bench stack's kernels-line figures
    for K8, per launch: one launch codes the 8-plane stack."""
    figures = {}
    for (name, gray), reps in zip(gray_cases(pnm), (10, 3, 10)):
        rows, cols = gray.shape
        n = rows * cols
        planes = bitplanes.decompose(gray ^ (gray >> 1), 255)
        P = planes.shape[0]
        st = {}
        st["upload"] = host_ms(lambda: compress.upload_planes(planes, dev),
                               reps)
        packed = compress.upload_planes(planes, dev)
        st["MED"] = cuda_ms(lambda: compress.med_planes(packed, cols), reps)
        res = compress.med_planes(packed, cols)
        call = lambda: eg.eg_encode(res, cols)
        k8 = cuda_ms(call, reps)
        parts = device_split(call, ("k8_", "fill"), reps)
        k8d = sum(v for k, v in parts.items() if "k8_" in k) or None
        plain = cuda_ms(lambda: eg.eg_encode_plain(res, cols), 1)
        words, nbits = call()
        nw = max(1, -(-int(nbits.max()) // 32))
        st[f"K8 ({P} planes, 1 launch)"] = k8
        st["fetch (K8 words)"] = host_ms(lambda: words[:, :nw].cpu(), reps)
        runs = int(eg.run_counts(res, cols).sum())
        nbytes, floor = roofline.eg_work(n, runs, int(nbits.sum()), planes=P)
        bound = roofline.bound_ms(nbytes=nbytes)
        if floor > bound[0]:
            bound = (floor, "operations")
        log(f"K8 {name}: {P} planes in one launch, {runs} runs, {k8:.4f} ms "
            f"per launch (events), device {nd(k8d)} (torch.profiler: "
            + ", ".join(f"{k} {v:.4f}" for k, v in parts.items())
            + f" ms); bound {bound[0]:.6f} ms ({bound[1]}: {nbytes} B; the "
            f"scan's chain floor {floor:.6f} ms); plain {plain:.3f} ms "
            f"[{gpu}]")
        figures[name] = (k8, plain, bound, None)
        tmpl, S, sr = codec.scab_stripes(
            codec.CodecParams(codec=13, W=0, T=0, R=0), rows)
        bits_t = bitpack.unpack(packed, cols)
        st["unpack (rans)"] = cuda_ms(lambda: bitpack.unpack(packed, cols),
                                      reps)
        st["context maps"] = cuda_ms(
            lambda: compress.scab_ctx_map(bits_t, tmpl=tmpl,
                                          stripe_rows=sr), reps)
        ctx = compress.scab_ctx_map(bits_t, tmpl=tmpl, stripe_rows=sr)
        st["counts + tables"] = cuda_ms(
            lambda: rd.build_table(*rd.count_contexts(ctx, bits_t)), reps)
        p_used = rd.build_table(*rd.count_contexts(ctx, bits_t))[3]
        a = (bits_t, ctx.to(torch.int16), p_used.to(torch.int16))
        st["K7 stack (1 launch)"] = cuda_ms(
            lambda: rd.rans_encode(*a, stripe_rows=sr), reps)
        dk7 = device_ms(lambda: rd.rans_encode(*a, stripe_rows=sr),
                        "rans_encode_kernel", reps)
        out = rd.rans_stack_encode(bits_t, ctx, stripe_rows=sr)
        st["fetch (rans)"] = host_ms(lambda: compress.fetch_rans_stack(out),
                                     reps)
        log(f"gray stages, {name} ({P} planes) [{gpu}]: " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in st.items())
            + f"; K7 stack device {nd(dk7)}")
        e2e = {}
        p10 = codec.CodecParams(codec=10, W=0, T=0, R=0)
        for backend in GRAY_BACKENDS:
            params = None if backend == "device-rans" else p10
            e2e[backend] = host_ms(lambda: codec.encode_pgm(
                gray, 255, params, backend=backend, device="cuda"), reps)
        e2e["host (numpy MED, native EG)"] = host_ms(
            lambda: codec.encode_pgm(gray, 255, p10), reps)
        e2e["decode_pgm (codec 10)"] = host_ms(lambda: codec.decode_pgm(
            codec.encode_pgm(gray, 255, p10, backend="device",
                             device="cuda")), 1)
        log(f"encode_pgm end to end, {name} [{gpu}]: " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in e2e.items()))
    return figures["bench 512x512"]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--parallel-rank"]:      # parallel_world2's ranks
        return parallel_rank(int(sys.argv[2]), int(sys.argv[3]))
    sys.path.insert(0, REPO)
    from binary_image_compression_tpu_torch import cli, native
    from binary_image_compression_tpu_torch.models import (archive, bsvd,
                                                           codec, compress)
    from binary_image_compression_tpu_torch.ops import _cuda, bitpack
    from binary_image_compression_tpu_torch.ops import egdevice as eg
    from binary_image_compression_tpu_torch.ops import decide as dc
    from binary_image_compression_tpu_torch.ops import fused_search as fs
    from binary_image_compression_tpu_torch.ops import packed_dist as pd
    from binary_image_compression_tpu_torch.ops import ransdevice as rd
    from binary_image_compression_tpu_torch.ops import recpack as rp
    from binary_image_compression_tpu_torch.ops import search
    from binary_image_compression_tpu_torch.ops import select_windows as sw
    from binary_image_compression_tpu_torch.ops import strict as st
    from binary_image_compression_tpu_torch.utils import (bitplanes, pnm,
                                                          profiling, roofline,
                                                          threefry)

    dev = torch.device("cuda", 0)
    gpu = card()
    log(gpu)  # nvidia-smi name, power.limit
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    native.build()
    native.get_lib()
    log(f"build: native host library {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    serial_build = start_k2_serial_build(_cuda)
    report = _cuda.build()
    _cuda.get_lib()
    serial = load_k2_serial(_cuda, dc, serial_build)
    log(f"build: CUDA kernels (nvcc sm_90a), and K2's serial design beside "
        f"them, {time.perf_counter() - t0:.1f} s")
    for line in report.splitlines():
        if "registers" in line or "Compiling entry" in line:
            log("  ptxas: " + line.strip())

    err1, err1p = check_k1(fs, pnm, dev)
    err2 = check_k2(dc, compress, pnm, dev)
    err3 = check_k3(st, compress, pnm, dev)
    err4, err4p = check_k4(sw, fs, pnm, dev)
    err5 = check_k5(pd, bsvd, dev)
    err6 = check_k6(pd, bsvd, dev)
    err_p, letter = check_pursuit(pd, bsvd, dev)
    err7 = check_k7(rd, compress, codec, pnm, dev)
    err8 = check_k8(eg, compress, bitplanes, pnm, dev)
    err9 = check_k9(rp, compress, bitpack, codec, pnm, _cuda, dev)

    causal = drive("causal", lambda: main_path(compress, archive, codec,
                                               native, pnm),
                   _cuda, ("field_plane", "fused_search_select",
                           "decide_modes", "pack_records"))
    strict_c = drive("strict", lambda: strict_path(compress, codec, native,
                                                   pnm),
                     _cuda, ("strict_analyze", "pack_records"))
    banded = drive("banded", lambda: no_maps_on_card(
        search, lambda: banded_path(compress, codec, native, pnm)),
                   _cuda, ("banded_plane", "select_windows", "decide_modes"))
    if banded.get("pack_records"):
        raise AssertionError("K9 ran on the banded path (M > 256)")
    bsvd_c = drive("bsvd", lambda: pursuit_spy(
        bsvd, _cuda, lambda: bsvd_path(codec, bsvd, cli, pnm, dev)),
                   _cuda, ("packed_pursuit",))
    if bsvd_c.get("packed_dist_matrix") or bsvd_c.get("packed_row_weight"):
        raise AssertionError("K5 or K6 ran on the bsvd path")
    scab = drive("scab", lambda: no_plain_rans_on_card(
        rd, lambda: scab_path(compress, codec, pnm)), _cuda, ("rans_encode",))
    if scab["rans_encode"] != 2:
        raise AssertionError(f"{scab['rans_encode']} rans_encode launches "
                             f"for 2 mode-2 encodes")
    gray = gray_drives(codec, pnm, _cuda)
    c47_k1 = drive("codec47 W=16", lambda: codec47_path(
        compress, codec, native, pnm, profiling, 16, 128), _cuda,
                   ("field_plane", "fused_search_select"))
    c47_k4 = drive("codec47 W=64", lambda: codec47_path(
        compress, codec, native, pnm, profiling, 64, 128), _cuda,
                   ("banded_plane", "select_windows"))
    for name, c, other in (("W=16", c47_k1, ("banded_plane",
                                             "select_windows")),
                           ("W=64", c47_k4, ("field_plane",
                                             "fused_search_select"))):
        ran = [k for k in ("decide_modes", "pack_records") + other
               if c.get(k)]
        if ran:
            raise AssertionError(f"codec47 {name} path launched {ran}")
    host_codecs_phase(codec, pnm)
    l0 = drive("l0_api", lambda: l0_api(bitpack, bsvd, pnm, threefry, dev),
               _cuda, ("packed_dist_matrix", "packed_row_weight"))
    par1 = parallel_world1(compress, codec, native, pnm, _cuda, dev, gpu)
    parallel_world2(gpu)

    img, _, out = stage_times(compress, fs, bitpack, codec, pnm, dev, gpu)
    kt = kernel_times(compress, fs, dc, roofline, img, out, serial, dev,
                      gpu)
    k3, k3p, b3, k4t, plane4 = new_path_times(
        compress, codec, st, sw, fs, bitpack, pnm, roofline, dev, gpu)
    k5, k5p, k6, k6p, lib5, lib6, pur = bsvd_times(codec, bsvd, pd, pnm,
                                                   roofline, letter, dev, gpu)
    l0_times(bitpack, pd, dev, gpu)
    k7t = scab_times(compress, codec, rd, bitpack, pnm, roofline, dev, gpu)
    k8t = gray_times(codec, compress, eg, rd, bitpack, bitplanes, pnm,
                     roofline, dev, gpu)
    k9t = k9_times(rp, compress, codec, roofline, pnm, dev, gpu)
    pops5, bytes5 = roofline.k5_work(1024, 64, 8)
    pops6, bytes6 = roofline.k6_work(1024, 8)
    b5 = roofline.bound_ms(popcounts=pops5, nbytes=bytes5)
    b6 = roofline.bound_ms(popcounts=pops6, nbytes=bytes6)
    pkg = "binary_image_compression_tpu_torch/csrc/"
    jax_ops = "binary_image_compression_tpu/ops/"

    def entry(name, src, replaces, launches, err, ms, plain, bound, lib):
        return dict(name=name, route="cuda", source=pkg + src,
                    replaces=jax_ops + replaces, launches=launches,
                    max_abs_err=err, ms=ms, plain_ms=plain,
                    bound_ms=bound[0], bound_by=bound[1], library_ms=lib)
    kernels = [
        entry("field_plane", "fused_search.cu", "pallas_kernels.py:451",
              causal["field_plane"] + c47_k1["field_plane"]
              + par1["field_plane"], err1p, *kt["plane"]),
        entry("fused_search_select", "fused_search.cu",
              "pallas_kernels.py:541", causal["fused_search_select"]
              + c47_k1["fused_search_select"] + par1["fused_search_select"],
              err1, *kt["k1"]),
        entry("decide_modes", "decide_modes.cu", "pallas_decide.py:100",
              causal["decide_modes"], err2, *kt["k2"]),
        entry("strict_analyze", "strict_analyze.cu", "pallas_strict.py:61",
              strict_c["strict_analyze"], err3, k3, k3p, b3, None),
        entry("banded_plane", "select_windows.cu", "search.py:203",
              banded["banded_plane"] + c47_k4["banded_plane"]
              + par1["banded_plane"], err4p, *plane4),
        entry("select_windows", "select_windows.cu", "pallas_kernels.py:407",
              banded["select_windows"] + c47_k4["select_windows"]
              + par1["select_windows"], err4, *k4t),
        entry("packed_dist_matrix", "packed_dist.cu", "pallas_kernels.py:45",
              l0["packed_dist_matrix"], err5, k5, k5p, b5, lib5),
        entry("packed_row_weight", "packed_dist.cu", "pallas_kernels.py:728",
              l0["packed_row_weight"], err6, k6, k6p, b6, lib6),
        entry("packed_pursuit", "packed_pursuit.cuh",
              "pallas_kernels.py:45 and :728", bsvd_c["packed_pursuit"],
              err_p, pur[0], pur[2], pur[3], None),
        entry("rans_encode", "rans_encode.cu", "ransdevice.py:167",
              scab["rans_encode"], err7, *k7t),
        dict(entry("eg_encode", "eg_encode.cu", "egdevice.py:106",
                   gray["device-assembly"]["eg_encode"], err8, *k8t),
             note="ms, plain_ms and bound_ms per launch: one launch codes "
                  "the 8-plane 512x512 bench stack"),
        dict(entry("pack_records", "pack_records.cu", "", causal[
            "pack_records"] + strict_c["pack_records"], err9, *k9t[1][:4]),
             replaces=None, device_ms=k9t[1][4],
             batch32=dict(zip(("ms", "plain_ms", "bound_ms", "device_ms"),
                              (k9t[32][0], k9t[32][1], k9t[32][2][0],
                               k9t[32][4]))),
             note="replaces no TPU kernel (the host's bic_pack_tiles); ms "
                  "per launch at one fax page 1728x2376 W=16, batch32 at "
                  "32 pages a launch"),
    ]
    log(json.dumps({"kernels": kernels}))
    log(card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
