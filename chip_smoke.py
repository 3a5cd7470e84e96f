"""End-to-end check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the native host library and the CUDA kernels from this checkout,
holds each kernel (K1 search, K2 decision, K3 strict analysis, K4 banded
selection, K5 packed distances, K6 packed row weights) against its plain
PyTorch version on the card, then drives the port's four paths, each with
the launch counts reset just before it and read just after: the causal
encode (one 512x512 page, then a 64-page corpus through the archive
writer), strict mode (``encode_strict`` on a 512x512 and a 512x2048
page), the banded fallback (``encode`` at W = 64 and W = 40) and BSVD
(codec 11 on one page, ``learn`` on both distance routes, the ``bsvd`` CLI
at K = 512).  Every codec-8 stream is checked byte for byte against the
native host encoder, the codec-11 stream against the same encode on the
CPU, and each is round-tripped; stages and kernels are timed with CUDA
events (K3's kernels and K2's step also by torch.profiler's device times),
and each kernel's time is printed beside its least time on the card
(``utils/roofline``) and, for K5 and K6, the one PyTorch call that computes
the same function.  Imports no JAX.

Any failure raises and exits non-zero; without CUDA it exits 1 at once.  The
last line of standard output is a JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import os
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


def check_k1(fs, pnm, dev) -> int:
    """K1 == its plain version on the same CUDA tensors."""
    doc = pnm.read_pbm(os.path.join(FIXTURES, "doc512.pbm"))
    rag = pnm.read_pbm(os.path.join(FIXTURES, "ragged75x101.pbm"))
    rnd = np.random.RandomState(7).rand(256, 320) < 0.3
    rs = np.random.RandomState(1)
    batch = np.stack([np.roll(doc, (rs.randint(512), rs.randint(512)),
                              axis=(0, 1)) for _ in range(4)])
    cases = [("doc512", doc[None], 16, 128, True),
             ("ragged75x101", rag[None], 8, 16, True),
             ("ragged75x101 no-invert", rag[None], 8, 16, False),
             ("random256x320 (64-bit priority)", rnd[None], 32, 192, True),
             ("doc512 x4 batch", batch, 16, 128, True)]
    worst = 0
    for name, pages, W, R, invert in cases:
        B, rows, cols = pages.shape
        ny, nx = -(-rows // W), -(-cols // W)
        T_thresh = 2
        img = grid_of(pages, W, dev)
        He = fs.plane_height(ny * W, W, R)
        E = fs.to_i32(fs._field_plane(img, W, He, nx * W)).contiguous()
        kw = dict(W=W, R=R, T_thresh=T_thresh, cols=cols, invert=invert,
                  y_base=0)
        got = fs._launch(E, ny, nx, **kw)
        want = fs.fused_search_select_plain(E, ny, nx, **kw)
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        worst = max(worst, err)
        log(f"K1 {name}: W={W} R={R} B={B} T={ny * nx} "
            f"max_abs_err={err} found={int(got[..., 3].sum())}")
        if err != 0:
            raise AssertionError(f"K1 disagrees with its plain version on "
                                 f"{name}")
    return worst


def check_k2(dc, compress, dev) -> int:
    """K2 == its plain version == the host replay, at M = 256 and
    at M = 4096 (W = 64, an enb LUT of 4097 entries)."""
    rs = np.random.RandomState(11)
    worst = 0
    for M, T in ((256, 1024), (256, 4096), (4096, 1024)):
        B = 2
        enb = torch.from_numpy(compress.enb_lut(M)).to(dev)
        w4 = rs.randint(0, M + 1, size=(B, T, 4)).astype(np.int32)
        hc = (rs.rand(B, T) < 0.8).astype(np.int32)
        il = rs.randint(1, 12, size=(B, T)).astype(np.int32)
        tw4, thc, til = (torch.from_numpy(a).to(dev) for a in (w4, hc, il))
        for cid in (4, 7, 8):
            got = torch.stack(dc._launch(tw4, thc, til, enb, codec_id=cid))
            want = torch.stack(dc.decide_modes_plain(tw4, thc, til, enb,
                                                     codec_id=cid))
            err = int((got.to(torch.int64) - want.to(torch.int64))
                      .abs().max())
            worst = max(worst, err)
            g = got.cpu().numpy()
            for b in range(B):
                host = compress._decide_modes(
                    dict(weights4=w4[b], has_cands=hc[b] != 0,
                         idx_len=il[b]), M, cid)
                for k in range(3):
                    if not np.array_equal(g[k, b], host[k]):
                        raise AssertionError(
                            f"K2 != host replay (T={T}, codec {cid})")
            log(f"K2 M={M} T={T} B={B} codec {cid}: max_abs_err vs "
                f"plain={err}, == host replay")
            if err != 0:
                raise AssertionError(f"K2 disagrees with its plain version "
                                     f"(M={M}, T={T}, codec {cid})")
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


def banded_maps(search, pnm, W, R, dev):
    doc = pnm.read_pbm(os.path.join(FIXTURES, "doc512.pbm"))
    return search.window_distance_maps_banded(grid_of(doc[None], W, dev),
                                              W, R)


def check_k4(sw, search, pnm, dev) -> int:
    """K4 == its plain version on doc512's banded maps."""
    worst = 0
    for W, R in ((40, 64), (64, 128)):
        d, oy, ox = banded_maps(search, pnm, W, R, dev)
        kw = dict(W=W, R=R, T_thresh=1, cols=512, invert=True)
        nx = -(-512 // W)
        got = sw._launch(d, oy, ox, nx, **kw)
        want = sw.select_windows_plain(d, oy, ox, nx, **kw)
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        worst = max(worst, err)
        log(f"K4 doc512 banded maps W={W} R={R} {tuple(d.shape)}: "
            f"max_abs_err={err} found={int(got[..., 3].sum())}")
        if err != 0:
            raise AssertionError(f"K4 disagrees with its plain version at "
                                 f"W={W}")
    return worst


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
    return native.encode_windowed(img, hdr, 8, p.strict, p.W, p.resolved_T(),
                                  p.R)


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


def banded_path(compress, codec, native, pnm):
    """The banded fallback as a user calls it: encode at W = 64 and 40."""
    doc = pnm.read_pbm(os.path.join(FIXTURES, "doc512.pbm"))
    for W, R in ((64, 128), (40, 64)):
        p = codec.CodecParams(codec=8, W=W, R=R, strict=False)
        t0 = time.perf_counter()
        blob = compress.encode(doc, p, device="cuda")
        t = time.perf_counter() - t0
        if blob != host_stream(codec, native, doc, p):
            raise AssertionError(f"doc512 W={W} != native host stream")
        if not np.array_equal(codec.decode(blob), doc):
            raise AssertionError(f"doc512 W={W} does not round-trip")
        log(f"banded: doc512 W={W} R={R} -> {len(blob)} B, == host encoder, "
            f"round-trips ({t * 1e3:.1f} ms wall, first call)")


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
BENCH_BSVD = ((1024, 256, 64), (4096, 256, 256), (4096, 1024, 256),
              (2048, 2048, 128))


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
    if not np.array_equal(codec.decode(blob), doc):
        raise AssertionError("codec 11 doc512 does not round-trip")
    log(f"codec 11: doc512 W=16 K=64 -> {len(blob)} B, == the CPU encode, "
        f"round-trips ({t * 1e3:.1f} ms wall, first call)")

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


def nd(v) -> str:
    return "not measured" if v is None else f"{v:.4f} ms"


def bsvd_times(codec, bsvd, pd, pnm, dev, gpu):
    """K5 beside its plain version and the matmul route, K6 beside its plain
    version, codec 11 end to end split into learning and the writer, and
    learning on both distance routes with the atom loop's and the pursuit's
    shares."""
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
        log(f"K5 N={N} M={M} K={K}: kernel {t['k5']:.4f} ms, plain "
            f"{t['plain']:.3f} ms, mxu route (f32 matmul) {t['mxu']:.4f} ms, "
            f"packed route (pack + K5) {t['route']:.4f} ms [{gpu}]")
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
    for K in (64, 512):
        for route in ("packed", "mxu"):
            with _Timed(bsvd, ("update_coefficients",
                               "update_dictionary_steepest")) as tm:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, _, _, iters = bsvd.learn(X, K=K, init="random_centroids",
                                            distances=route)
                torch.cuda.synchronize()
                total = (time.perf_counter() - t0) * 1e3
            pursuit = tm.ms["update_coefficients"]
            atoms = tm.ms["update_dictionary_steepest"]
            log(f"learn doc512 W=16 K={K} distances={route}: {total:.3f} ms, "
                f"{iters} iterations; atom loop (update_dictionary_steepest) "
                f"{atoms:.3f} ms ({100 * atoms / total:.1f} %), pursuit "
                f"{pursuit:.3f} ms ({100 * pursuit / total:.1f} %) [{gpu}]")
    c11 = k5[(1024, 256, 64)]
    return c11["k5"], c11["plain"], k6, k6p, lib5, lib6


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
        st["end to end (encode_batch)"] = host_ms(
            lambda: compress.encode_batch(pages, p, device="cuda"), 3)
        parts = ", ".join(f"{k} {v:.3f} ms" for k, v in st.items())
        log(f"stages B={B} doc512 W=16 R=128 [{gpu}]: {parts}")
        log(f"  per page: {st['end to end (encode_batch)'] / B:.3f} ms, "
            f"{B * 1e3 / st['end to end (encode_batch)']:.1f} pages/s "
            f"[{gpu}]")
    return img, sel, out


def kernel_times(compress, fs, dc, roofline, img, out, dev, gpu):
    """K1 and K2 beside their plain versions at doc512's shapes."""
    W, R, T_thresh, rows, cols = 16, 128, 1, 512, 512
    ny = nx = 32
    E = fs.to_i32(fs._field_plane(img, W, fs.plane_height(512, W, R),
                                  512)).contiguous()
    kw = dict(W=W, R=R, T_thresh=T_thresh, cols=cols, invert=True, y_base=0)
    k1 = cuda_ms(lambda: fs._launch(E, ny, nx, **kw), 20)
    k1p = cuda_ms(lambda: fs.fused_search_select_plain(E, ny, nx, **kw), 3)
    i32 = lambda t: t.to(torch.int32).contiguous()
    a = (i32(out["weights4"]), i32(out["has_cands"]), i32(out["idx_len"]),
         torch.from_numpy(compress.enb_lut(W * W)).to(dev))
    k2 = cuda_ms(lambda: dc._launch(*a, codec_id=8), 20)
    k2p = cuda_ms(lambda: dc.decide_modes_plain(*a, codec_id=8), 2)
    log(f"K1 kernel {k1:.4f} ms vs plain {k1p:.3f} ms; K2 kernel {k2:.4f} ms "
        f"vs plain {k2p:.3f} ms (doc512 x{img.shape[0]}, W=16 R=128) [{gpu}]")
    T = ny * nx
    # K2's chain: the device time of one page's launch at T and 4T tiles
    # (random weights, M = 256) gives the time of one dependent step
    rs = np.random.RandomState(5)
    t2 = []
    for n in (T, 4 * T):
        b = [torch.from_numpy(x.astype(np.int32)).to(dev) for x in (
            rs.randint(0, W * W + 1, (1, n, 4)), rs.rand(1, n) < 0.8,
            rs.randint(1, 12, (1, n)))]
        t2.append(device_ms(lambda: dc._launch(*b, a[3], codec_id=8),
                            "decide_modes_kernel"))
    if None not in t2:
        step = (t2[1] - t2[0]) / (3 * T)
        log(f"K2 chain (torch.profiler, mean of 20): one page {t2[0]:.4f} ms "
            f"at T={T}, {t2[1]:.4f} ms at T={4 * T}: {step * 1e6:.2f} ns per "
            f"step ({step * 1e-3 * roofline.H100_CLOCK_HZ:.0f} clocks at 1.98 "
            f"GHz), so the chain is {step * T:.4f} ms of a page at T={T} "
            f"[{gpu}]")
    else:
        log(f"K2 chain: device time not measured [{gpu}]")
    k1_bound = roofline.bound_ms(
        popcounts=roofline.search_popcounts(rows, cols, W, R),
        nbytes=roofline.k1_bytes(*E.shape, T))
    k2_bound = roofline.bound_ms(nbytes=roofline.k2_bytes(1, T, W * W))
    return k1, k1p, k2, k2p, k1_bound, k2_bound


def new_path_times(compress, codec, st, sw, search, pnm, roofline, dev, gpu):
    """K3 (whole, and the device time of each of its kernels) and K4 beside
    their plain versions, and the strict and W = 64 encodes end to end, on
    doc512."""
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
    t_maps = cuda_ms(lambda: banded_maps(search, pnm, 64, 128, dev), 3)
    d, oy, ox = banded_maps(search, pnm, 64, 128, dev)
    kw4 = dict(W=64, R=128, T_thresh=1, cols=512, invert=True)
    k4 = cuda_ms(lambda: sw._launch(d, oy, ox, 8, **kw4), 20)
    k4p = cuda_ms(lambda: sw.select_windows_plain(d, oy, ox, 8, **kw4), 3)
    ps = codec.CodecParams(codec=8, W=16, R=128, strict=True)
    e_strict = host_ms(lambda: compress.encode_strict(doc, ps, device="cuda"),
                       5)
    p64 = codec.CodecParams(codec=8, W=64, R=128, strict=False)
    e64 = host_ms(lambda: compress.encode(doc, p64, device="cuda"), 5)
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
    log(f"K4 kernel {k4:.4f} ms vs plain {k4p:.3f} ms; banded maps (PyTorch) "
        f"{t_maps:.3f} ms (doc512, W=64 R=128) [{gpu}]")
    log(f"end to end: encode_strict doc512 W=16 R=128 {e_strict:.3f} ms; "
        f"encode doc512 W=64 R=128 {e64:.3f} ms [{gpu}]")
    k4_bound = roofline.bound_ms(nbytes=roofline.k4_bytes(*d.shape))
    return k3, k3p, b3, k4, k4p, k4_bound


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from binary_image_compression_tpu_torch import cli, native
    from binary_image_compression_tpu_torch.models import (archive, bsvd,
                                                           codec, compress)
    from binary_image_compression_tpu_torch.ops import _cuda, bitpack
    from binary_image_compression_tpu_torch.ops import decide as dc
    from binary_image_compression_tpu_torch.ops import fused_search as fs
    from binary_image_compression_tpu_torch.ops import packed_dist as pd
    from binary_image_compression_tpu_torch.ops import search
    from binary_image_compression_tpu_torch.ops import select_windows as sw
    from binary_image_compression_tpu_torch.ops import strict as st
    from binary_image_compression_tpu_torch.utils import pnm, roofline

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
    report = _cuda.build()
    _cuda.get_lib()
    log(f"build: CUDA kernels (nvcc sm_90a) {time.perf_counter() - t0:.1f} s")
    for line in report.splitlines():
        if "registers" in line or "Compiling entry" in line:
            log("  ptxas: " + line.strip())

    err1 = check_k1(fs, pnm, dev)
    err2 = check_k2(dc, compress, dev)
    err3 = check_k3(st, compress, pnm, dev)
    err4 = check_k4(sw, search, pnm, dev)
    err5 = check_k5(pd, bsvd, dev)
    err6 = check_k6(pd, bsvd, dev)

    causal = drive("causal", lambda: main_path(compress, archive, codec,
                                               native, pnm),
                   _cuda, ("fused_search_select", "decide_modes"))
    strict_c = drive("strict", lambda: strict_path(compress, codec, native,
                                                   pnm),
                     _cuda, ("strict_analyze",))
    banded = drive("banded", lambda: banded_path(compress, codec, native,
                                                 pnm),
                   _cuda, ("select_windows", "decide_modes"))
    bsvd_c = drive("bsvd", lambda: bsvd_path(codec, bsvd, cli, pnm, dev),
                   _cuda, ("packed_dist_matrix", "packed_row_weight"))

    img, _, out = stage_times(compress, fs, bitpack, codec, pnm, dev, gpu)
    k1, k1p, k2, k2p, b1, b2 = kernel_times(
        compress, fs, dc, roofline, img[:1],
        {k: v[:1] for k, v in out.items()}, dev, gpu)
    k3, k3p, b3, k4, k4p, b4 = new_path_times(
        compress, codec, st, sw, search, pnm, roofline, dev, gpu)
    k5, k5p, k6, k6p, lib5, lib6 = bsvd_times(codec, bsvd, pd, pnm, dev, gpu)
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
        entry("fused_search_select", "fused_search.cu",
              "pallas_kernels.py:541", causal["fused_search_select"], err1,
              k1, k1p, b1, None),
        entry("decide_modes", "decide_modes.cu", "pallas_decide.py:100",
              causal["decide_modes"], err2, k2, k2p, b2, None),
        entry("strict_analyze", "strict_analyze.cu", "pallas_strict.py:61",
              strict_c["strict_analyze"], err3, k3, k3p, b3, None),
        entry("select_windows", "select_windows.cu", "pallas_kernels.py:407",
              banded["select_windows"], err4, k4, k4p, b4, None),
        entry("packed_dist_matrix", "packed_dist.cu", "pallas_kernels.py:45",
              bsvd_c["packed_dist_matrix"], err5, k5, k5p, b5, lib5),
        entry("packed_row_weight", "packed_dist.cu", "pallas_kernels.py:728",
              bsvd_c["packed_row_weight"], err6, k6, k6p, b6, lib6),
    ]
    log(json.dumps({"kernels": kernels}))
    log(card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
