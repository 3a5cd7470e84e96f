"""K1-K8 and the BSVD pursuit kernel on the card against their plain
PyTorch versions, the port's
causal and strict encodes on the card against the native host encoder, and
codec 11, codec 13 (both payload modes), the grayscale backends and BSVD
learning on the card against the CPU run.

Needs an NVIDIA GPU with nvcc (marked ``cuda``; skipped without one).  The
file imports no JAX, so on a machine without JAX it runs on its own:

    python -m pytest tests/test_torch_cuda_kernels.py --noconftest -q
"""

import os

import numpy as np
import pytest
import torch

from binary_image_compression_tpu_torch import native
from binary_image_compression_tpu_torch.models import bsvd, codec, compress
from binary_image_compression_tpu_torch.ops import _cuda
from binary_image_compression_tpu_torch.ops import decide as dc
from binary_image_compression_tpu_torch.ops import fused_search as fs
from binary_image_compression_tpu_torch.ops import (bitpack, egdevice,
                                                    packed_dist, ransdevice)
from binary_image_compression_tpu_torch.ops import search
from binary_image_compression_tpu_torch.ops import select_windows as sw
from binary_image_compression_tpu_torch.ops import strict
from binary_image_compression_tpu_torch.utils import pnm

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda is not available)")
    return torch.device("cuda", 0)


def _k1_pages(rows, cols, W, B, dev):
    pages = np.random.RandomState(rows + W).rand(B, rows, cols) < 0.3
    ny, nx = -(-rows // W), -(-cols // W)
    grid = np.zeros((B, ny * W, nx * W), dtype=bool)
    grid[:, :rows, :cols] = pages
    return torch.from_numpy(grid).to(dev), ny, nx


# W = 5 and 12 take the kernel's run-time-W instance; y_base != 0 moves the
# masks and keys to absolute rows (negative under tile sharding)
K1_CASES = [(75, 101, 8, 16, True, 0), (96, 128, 16, 64, False, 0),
            (256, 320, 32, 192, True, 0), (40, 53, 5, 10, True, 0),
            (60, 84, 12, 24, True, 12), (96, 128, 16, 64, True, 32),
            (64, 80, 16, 48, True, -24)]


@pytest.mark.parametrize("rows,cols,W,R,invert,y_base", K1_CASES)
def test_k1_kernel_matches_plain(dev, rows, cols, W, R, invert, y_base):
    img, ny, nx = _k1_pages(rows, cols, W, 3, dev)
    kw = dict(W=W, R=R, T_thresh=1, cols=cols, invert=invert, y_base=y_base)
    before = dict(_cuda.launches)
    got, oy, E = fs.fused_search_select(img, ny, nx, **kw)
    for name in ("field_plane", "fused_search_select"):
        assert _cuda.launches[name] == before.get(name, 0) + 1
    want = fs.fused_search_select_plain(
        fs.to_i32(fs._field_plane(img, W, E.shape[1], nx * W)), ny, nx, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert int(got[..., 3].sum()) > 0


@pytest.mark.parametrize("rows,cols,W,R", [(75, 101, 8, 16), (40, 53, 5, 10),
                                           (60, 84, 12, 24),
                                           (96, 128, 16, 64),
                                           (256, 320, 32, 192)])
def test_field_plane_kernel_matches_plain(dev, rows, cols, W, R):
    img, ny, nx = _k1_pages(rows, cols, W, 2, dev)
    He = fs.plane_height(ny * W, W, R)
    got = fs._launch_plane(img, W, He)
    want = fs.to_i32(fs._field_plane(img, W, He, nx * W))
    torch.cuda.synchronize()
    assert got.shape == want.shape and torch.equal(got, want)


@pytest.mark.parametrize("codec_id", [4, 7, 8])
def test_k2_kernel_matches_plain_and_host(dev, codec_id):
    M, T, B = 256, 1000, 3
    rs = np.random.RandomState(codec_id)
    w4 = rs.randint(0, M + 1, size=(B, T, 4)).astype(np.int32)
    hc = (rs.rand(B, T) < 0.8).astype(np.int32)
    il = rs.randint(1, 12, size=(B, T)).astype(np.int32)
    args = [torch.from_numpy(a).to(dev) for a in (w4, hc, il)]
    enb = torch.from_numpy(compress.enb_lut(M)).to(dev)
    got = torch.stack(dc.decide_modes(*args, enb, codec_id=codec_id))
    want = torch.stack(dc.decide_modes_plain(*args, enb, codec_id=codec_id))
    assert torch.equal(got, want)
    host = compress._decide_modes(dict(weights4=w4[1], has_cands=hc[1] != 0,
                                       idx_len=il[1]), M, codec_id)
    np.testing.assert_array_equal(got[:, 1].cpu().numpy(), np.stack(host))


def test_k2_kernel_at_w64_matches_plain_and_host(dev):
    """M = 4096 needs an enb LUT of 4097 entries (W = 64)."""
    M, T, B = 4096, 300, 2
    rs = np.random.RandomState(64)
    w4 = rs.randint(0, M + 1, size=(B, T, 4)).astype(np.int32)
    hc = (rs.rand(B, T) < 0.8).astype(np.int32)
    il = rs.randint(1, 12, size=(B, T)).astype(np.int32)
    args = [torch.from_numpy(a).to(dev) for a in (w4, hc, il)]
    enb = torch.from_numpy(compress.enb_lut(M)).to(dev)
    got = torch.stack(dc.decide_modes(*args, enb, codec_id=8))
    want = torch.stack(dc.decide_modes_plain(*args, enb, codec_id=8))
    assert torch.equal(got, want)
    host = compress._decide_modes(dict(weights4=w4[0], has_cands=hc[0] != 0,
                                       idx_len=il[0]), M, 8)
    np.testing.assert_array_equal(got[:, 0].cpu().numpy(), np.stack(host))


def _k2_pages(case, dev):
    """(weights4, has_cands, idx_len, M) of one page, as numpy arrays."""
    if case == "adversarial":              # k changes on every tile
        T, M = 1024, 256
        w4 = np.full((T, 4), M, dtype=np.int32)
        w4[:, 2] = w4[:, 3] = np.where(np.arange(T) % 2 == 0, M, 0)
        return w4, np.zeros(T, bool), np.ones(T, np.int32), M
    if case == "M=4096":
        rs = np.random.RandomState(4096)
        return (rs.randint(0, 4097, size=(1024, 4)).astype(np.int32),
                rs.rand(1024) < 0.8,
                rs.randint(1, 12, size=1024).astype(np.int32), 4096)
    W = int(case.split("=")[1])
    doc = pnm.read_pbm(os.path.join(FIX, "doc512.pbm"))
    out = compress.encode_analyze(torch.from_numpy(doc[None]).to(dev), W=W,
                                  R=128, T_thresh=1, rows=512, cols=512)
    return (out["weights4"][0].to(torch.int32).cpu().numpy(),
            out["has_cands"][0].cpu().numpy(),
            out["idx_len"][0].to(torch.int32).cpu().numpy(), W * W)


@pytest.mark.parametrize("guard", [0, dc.GUARD])
@pytest.mark.parametrize("case", ["adversarial", "doc512 W=16",
                                  "doc512 W=32", "M=4096"])
def test_k2_rounds_match_model(dev, case, guard):
    """The kernel == the plain version, and its round counter == the CPU
    model's count (ops/decide.decide_rounds_model)."""
    w4, hc, il, M = _k2_pages(case, dev)
    args = [torch.from_numpy(a[None].astype(np.int32)).to(dev)
            for a in (w4, hc, il)]
    enb = torch.from_numpy(compress.enb_lut(M)).to(dev)
    rounds = torch.full((1,), -1, dtype=torch.int32, device=dev)
    got = torch.stack(dc._launch(*args, enb, codec_id=8, rounds=rounds,
                                 guard=guard))
    want = torch.stack(dc.decide_modes_plain(*args, enb, codec_id=8))
    assert torch.equal(got, want)
    model = dc.decide_rounds_model(w4, hc, il, compress.enb_lut(M),
                                   codec_id=8, guard=guard)
    assert int(rounds[0]) == model[3]


def _feedback_image():
    """Repeated tiles force matches on residuals earlier tiles substituted
    (the image of tests/test_pallas_strict.py, RandomState(12345))."""
    img = np.tile(np.random.RandomState(12345).rand(16, 16) < 0.4, (6, 6))
    img[40:48, 40:48] ^= True
    return img


@pytest.mark.parametrize("name,W,R", [
    ("text64.pbm", 8, 16), ("ragged75x101.pbm", 8, 24), ("feedback", 8, 40),
    ("text256.pbm", 16, 64), ("text256.pbm", 24, 32), ("text256.pbm", 32, 48),
    ("text64.pbm", 16, 9), ("doc512.pbm", 32, 64),
    ("doc512 2x2", 32, 1024)])        # wider than the serial pass's ring
def test_k3_kernel_matches_plain(dev, name, W, R):
    if name == "feedback":
        img = _feedback_image()
    elif name == "doc512 2x2":
        img = np.tile(pnm.read_pbm(os.path.join(FIX, "doc512.pbm")), (2, 2))
    else:
        img = pnm.read_pbm(os.path.join(FIX, name))
    rows, cols = img.shape
    grid = np.zeros((-(-rows // W) * W, -(-cols // W) * W), dtype=bool)
    grid[:rows, :cols] = img
    g = torch.from_numpy(grid).to(dev)
    enb = torch.from_numpy(compress.enb_lut(W * W)).to(dev)
    kw = dict(W=W, R=R, T_thresh=1, cols=cols)
    before = _cuda.launches["strict_analyze"]
    got = strict.strict_analyze(g, enb, **kw)
    assert _cuda.launches["strict_analyze"] == before + 1
    want = strict.strict_analyze_plain(g, enb, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])


@pytest.mark.parametrize("rows,cols,W,R,B", [(96, 128, 40, 64, 2),
                                             (192, 256, 64, 128, 2),
                                             (64, 200, 33, 40, 2),
                                             (100, 150, 48, 56, 1),
                                             (130, 150, 64, 128, 4),
                                             (16, 4000, 8, 8, 1)])
def test_k4_kernel_matches_plain(dev, rows, cols, W, R, B):
    """The plane kernel == ``_field_plane`` and the search == its plain
    version (the banded maps and the selection over them): W = 64 takes its
    own instance, the rest the run-time-W one; partial bottom and right
    tiles, a band taller than the page, a batch and a W = 8 strip."""
    pages = np.random.RandomState(W + B).rand(B, rows, cols) < 0.3
    ny, nx = -(-rows // W), -(-cols // W)
    grid = np.zeros((B, ny * W, nx * W), dtype=bool)
    grid[:, :rows, :cols] = pages
    img = torch.from_numpy(grid).to(dev)
    kw = dict(W=W, R=R, T_thresh=1, cols=cols, invert=True)
    before = dict(_cuda.launches)
    got, oy, E = sw.select_windows(img, ny, nx, **kw)
    for name in ("banded_plane", "select_windows"):
        assert _cuda.launches[name] == before.get(name, 0) + 1
    plain_E = fs._field_plane(img, W, E.shape[1], nx * W)
    want = sw.select_windows_plain(plain_E, ny, nx, **kw)
    torch.cuda.synchronize()
    assert torch.equal(E, plain_E)
    assert torch.equal(got, want)
    assert torch.equal(oy, search.banded_origins(ny * W, nx * W, W, R,
                                                 dev)[0])
    assert int(got[..., 3].sum()) > 0


def _shard_frame(grid, base, blk, R):
    """A shard's frame of padded tile grids [B, gh, gw]: the R rows above
    rows base..base+blk (zeros above the page), then those rows."""
    B, gh, gw = grid.shape
    frame = np.zeros((B, R + blk, gw), dtype=bool)
    lo = max(base - R, 0)
    frame[:, R - (base - lo):, :] = grid[:, lo:base + blk]
    return frame


# rows, cols, W, R, shard base row, shard rows: tiles at frame row R, masks
# and keys at absolute rows (y_base = base - R, negative for the top shard)
SHARD_CASES = [(256, 256, 16, 64, 128, 64), (256, 256, 16, 100, 0, 64),
               (96, 101, 8, 24, 40, 24), (512, 512, 64, 128, 256, 128),
               (256, 256, 40, 64, 0, 80), (128, 300, 40, 64, 80, 40)]


@pytest.mark.parametrize("rows,cols,W,R,base,blk", SHARD_CASES)
def test_k1_k4_shard_frame_match_plain(dev, rows, cols, W, R, base, blk):
    """K1 (W <= 32) and K4 on a shard frame (row0 = R, y_base = base - R)
    == their plain versions, field for field."""
    pages = np.random.RandomState(W + base).rand(2, rows, cols) < 0.3
    ny, nx = -(-rows // W), -(-cols // W)
    grid = np.zeros((2, ny * W, nx * W), dtype=bool)
    grid[:, :rows, :cols] = pages
    img = torch.from_numpy(_shard_frame(grid, base, blk, R)).to(dev)
    kw = dict(W=W, R=R, T_thresh=2, cols=cols, invert=True,
              y_base=base - R, row0=R)
    ny_loc = blk // W
    plain_E = fs._field_plane(img, W, img.shape[1], nx * W)
    if fs.fused_supported(ny_loc, nx, W, R):
        got, oy, _ = fs.fused_search_select(img, ny_loc, nx, **kw)
        want = fs.fused_search_select_plain(fs.to_i32(plain_E), ny_loc, nx,
                                            **kw)
    else:
        got, oy, _ = sw.select_windows(img, ny_loc, nx, **kw)
        want = sw.select_windows_plain(plain_E, ny_loc, nx, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert int(got[..., 3].sum()) > 0


def test_k4_kernel_no_invert_matches_plain_on_doc512(dev):
    """K4 with the complement trick off (codecs 4 and 7) at doc512 W=64
    R=128, field for field against its plain version."""
    doc = pnm.read_pbm(os.path.join(FIX, "doc512.pbm"))
    W, R = 64, 128
    img = torch.from_numpy(doc[None]).to(dev)
    kw = dict(W=W, R=R, T_thresh=1, cols=512, invert=False)
    got, _, E = sw.select_windows(img, 8, 8, **kw)
    want = sw.select_windows_plain(fs._field_plane(img, W, E.shape[1], 512),
                                   8, 8, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert not bool(got[..., 2].any())      # no tile inverted


def _host(img, p):
    hdr = codec._header(p, *img.shape, codec.image_crc(img))
    return native.encode_windowed(img, hdr, p.codec, p.strict, p.W,
                                  p.resolved_T(), p.R)


@pytest.mark.parametrize("codec_id", [4, 7])
@pytest.mark.parametrize("W,want", [(16, ("field_plane",
                                          "fused_search_select")),
                                    (64, ("banded_plane", "select_windows"))])
def test_codec47_on_card_matches_host_encoder(dev, codec_id, W, want):
    """Codecs 4 and 7 through K1 (W=16) or K4 (W=64) with the complement
    trick off and native bic_decide_pack; K2 does not run."""
    img = pnm.read_pbm(os.path.join(FIX, "doc512.pbm"))
    p = codec.CodecParams(codec=codec_id, W=W, R=128, strict=False)
    before = dict(_cuda.launches)
    blob = compress.encode(img, p, device="cuda")
    assert blob == _host(img, p)
    ran = {k for k, n in _cuda.launches.items() if n != before.get(k, 0)}
    assert ran == set(want)
    np.testing.assert_array_equal(codec.decode(blob), img)


def test_encode_on_card_matches_host_encoder(dev):
    img = pnm.read_pbm(os.path.join(FIX, "doc512.pbm"))
    p = codec.CodecParams(codec=8, W=16, R=128, strict=False)
    blob = compress.encode(img, p, device="cuda")
    assert blob == _host(img, p)
    assert len(blob) == 17207


@pytest.mark.parametrize("W,R", [(64, 128), (40, 64)])
def test_banded_encode_on_card_matches_host_encoder(dev, W, R):
    img = pnm.read_pbm(os.path.join(FIX, "doc512.pbm"))
    p = codec.CodecParams(codec=8, W=W, R=R, strict=False)
    before = dict(_cuda.launches)
    blob = compress.encode(img, p, device="cuda")
    assert blob == _host(img, p)
    for k in ("banded_plane", "select_windows", "decide_modes"):
        assert _cuda.launches[k] == before.get(k, 0) + 1
    np.testing.assert_array_equal(codec.decode(blob), img)


@pytest.mark.parametrize("tiles", [(1, 1), (1, 4)])
def test_strict_encode_on_card_matches_host_encoder(dev, tiles):
    img = np.tile(pnm.read_pbm(os.path.join(FIX, "doc512.pbm")), tiles)
    p = codec.CodecParams(codec=8, W=16, R=128, strict=True)
    blob = compress.encode_strict(img, p, device="cuda")
    assert blob == _host(img, p)
    np.testing.assert_array_equal(codec.decode(blob), img)


@pytest.mark.parametrize("n,k,words", [(1, 1, 1), (33, 65, 1), (77, 33, 5),
                                       (1024, 64, 8), (512, 512, 16),
                                       (100, 40, 70), (64, 40, 65),
                                       (64, 40, 128)])
def test_k5_k6_kernels_match_plain(dev, n, k, words):
    rs = np.random.RandomState(n + k + words)
    a = torch.from_numpy(rs.randint(-2 ** 31, 2 ** 31, size=(n, words),
                                    dtype=np.int64).astype(np.int32)).to(dev)
    b = torch.from_numpy(rs.randint(-2 ** 31, 2 ** 31, size=(k, words),
                                    dtype=np.int64).astype(np.int32)).to(dev)
    before = dict(_cuda.launches)
    d = packed_dist.packed_dist_matrix(a, b)
    w = packed_dist.packed_row_weight(a)
    for name in ("packed_dist_matrix", "packed_row_weight"):
        assert _cuda.launches[name] == before.get(name, 0) + 1
    torch.cuda.synchronize()
    assert torch.equal(d, packed_dist.packed_dist_matrix_plain(a, b))
    assert torch.equal(w, packed_dist.packed_row_weight_plain(a))


def test_codec11_on_card_matches_cpu(dev):
    """Codec 11's pursuit goes through the pursuit kernel alone: K5 and K6
    do not run on its path."""
    img = pnm.read_pbm(os.path.join(FIX, "ragged75x101.pbm"))
    p = codec.CodecParams(codec=11, W=8, T=0, R=0)
    before = dict(_cuda.launches)
    blob = codec.encode(img, p, device="cuda")
    assert _cuda.launches["packed_pursuit"] > before.get("packed_pursuit", 0)
    for name in ("packed_dist_matrix", "packed_row_weight"):
        assert _cuda.launches[name] == before.get(name, 0)
    assert blob == codec.encode(img, p, device="cpu")
    np.testing.assert_array_equal(codec.decode(blob), img)


def _planted(N, M, K, seed):
    """E = (A* D mod 2) ^ 5 % noise, D of density 1/4, about 3 atoms a row
    (chip_smoke's planted pursuit inputs), and A = 0."""
    rs = np.random.RandomState(seed)
    D = rs.rand(K, M) < 0.25
    Astar = rs.rand(N, K) < 3.0 / K
    E = ((Astar.astype(np.int64) @ D.astype(np.int64)) % 2 == 1) ^ (
        rs.rand(N, M) < 0.05)
    return [torch.from_numpy(x.astype(np.int8))
            for x in (E, D, np.zeros((N, K)))]


@pytest.mark.parametrize("stage", [0, 1])
@pytest.mark.parametrize("N,M,K", [(1, 1, 1), (33, 32, 65), (77, 130, 33),
                                   (1024, 256, 64), (512, 512, 512),
                                   (64, 2080, 40), (256, 4096, 64),
                                   (300, 64, 16)])
def test_pursuit_kernel_matches_plain(dev, N, M, K, stage):
    """The pursuit kernel == ``packed_pursuit_plain`` on the same CUDA
    tensors: E, A, the changed count and every row's passes; the dictionary
    in shared memory (1) and read from device memory (0); register rows (up
    to 16 words) and rows in place."""
    E, D, A = (x.to(dev) for x in _planted(N, M, K, N + M + K))
    Ep, Dp = bsvd._pack(E), bsvd._pack(D)
    Ep2, A2 = Ep.clone(), A.clone()
    before = _cuda.launches["packed_pursuit"]
    got = packed_dist._launch_pursuit(Ep, Dp, A, K, stage=stage)
    assert _cuda.launches["packed_pursuit"] == before + 1
    want = packed_dist.packed_pursuit_plain(Ep2, Dp, A2, K)
    torch.cuda.synchronize()
    assert torch.equal(Ep, Ep2) and torch.equal(A, A2)
    assert int(got[0]) == int(want[0])
    assert torch.equal(got[1], want[1])
    assert N == 1 or int(want[0]) > 0


@pytest.mark.parametrize("m", [2080, 4096])
def test_wide_pursuit_on_card_launches_k5(dev, m):
    """Rows wider than JAX's packed bound (2048 bits): one pursuit launch
    per ``update_coefficients`` call, no K5 or K6 launch and no host sync
    inside it, and the CPU's result."""
    rs = np.random.RandomState(m)
    D = rs.rand(8, m) < 0.25
    A = rs.rand(48, 8) < 0.15
    E = ((A.astype(np.int64) @ D.astype(np.int64)) % 2 == 1) ^ (
        rs.rand(48, m) < 0.3)
    args = [torch.from_numpy(x.astype(np.int8)) for x in (E, D, A)]
    want = bsvd.update_coefficients(*args)
    cargs = [x.to(dev) for x in args]
    torch.cuda.synchronize()
    before = dict(_cuda.launches)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = bsvd.update_coefficients(*cargs)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert _cuda.launches["packed_pursuit"] == before.get(
        "packed_pursuit", 0) + 1
    for name in ("packed_dist_matrix", "packed_row_weight"):
        assert _cuda.launches[name] == before.get(name, 0)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert int(want[2]) > 0


@pytest.mark.parametrize("distances", ["packed", "mxu"])
def test_bsvd_learn_on_card_matches_cpu(dev, distances):
    img = pnm.read_pbm(os.path.join(FIX, "text256.pbm"))
    X = bsvd.patchify_to_rows(torch.from_numpy(img), 16)
    want = bsvd.learn(X, K=32, init="random_centroids")
    got = bsvd.learn(X.to(dev), K=32, init="random_centroids",
                     distances=distances)
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g.cpu(), w)
    assert got[3] == want[3]


# (rows, cols, stripe_rows, n_lanes): pads at the stripes' ends, a short
# last stripe, one row, fewer pixels than lanes, part-filled warps, one
# lane and 255 lanes (8 warps)
K7_CASES = [(64, 64, 32, 32), (75, 101, 19, 4), (75, 101, 38, 8),
            (1, 7, 1, 32), (129, 67, 65, 64), (33, 65, 17, 33),
            (50, 50, 25, 255), (96, 80, 96, 1)]


@pytest.mark.parametrize("rows,cols,sr,n_lanes", K7_CASES)
def test_k7_kernel_matches_plain(dev, rows, cols, sr, n_lanes):
    rs = np.random.RandomState(rows * cols + n_lanes)
    bits = torch.from_numpy(rs.rand(2, rows, cols) < 0.3).to(dev)
    ctx = torch.stack([compress.scab_ctx_map(b, tmpl=12, stripe_rows=sr)
                       for b in bits])
    p_used = torch.from_numpy(
        rs.randint(1, 4096, (2, 4096)).astype(np.int16)).to(dev)
    before = _cuda.launches["rans_encode"]
    got = ransdevice.rans_encode(bits, ctx, p_used, stripe_rows=sr,
                                 n_lanes=n_lanes)
    assert _cuda.launches["rans_encode"] == before + 1
    want = ransdevice.rans_stripes_plain(bits, ctx, p_used, stripe_rows=sr,
                                         n_lanes=n_lanes)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _k7_matches_plain(bits, ctx, p_used, sr, n_lanes):
    before = _cuda.launches["rans_encode"]
    got = ransdevice.rans_encode(bits, ctx, p_used, stripe_rows=sr,
                                 n_lanes=n_lanes)
    assert _cuda.launches["rans_encode"] == before + 1
    want = ransdevice.rans_stripes_plain(bits, ctx, p_used, stripe_rows=sr,
                                         n_lanes=n_lanes)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    return got


# (rows, cols, stripe_rows, n_lanes): short last stripes (18 and 1 rows) at
# one lane, 33 lanes (two chain warps, the second part-filled) and 255
K7_DENSE = [(75, 101, 19, 1), (100, 37, 33, 33), (75, 101, 38, 255)]


@pytest.mark.parametrize("rows,cols,sr,n_lanes", K7_DENSE)
def test_k7_densest_emission_matches_plain(dev, rows, cols, sr, n_lanes):
    """Contexts 0 and 1 at p1 = 4095 and 1, the context the bit: f = 1 at
    every step, 12 bits a step, a word on about three steps in four."""
    rs = np.random.RandomState(rows + n_lanes)
    bits = torch.from_numpy(rs.rand(2, rows, cols) < 0.5).to(dev)
    p_used = torch.full((2, 4096), 4095, dtype=torch.int16, device=dev)
    p_used[:, 1] = 1
    got = _k7_matches_plain(bits, bits.to(torch.int16), p_used, sr, n_lanes)
    assert int(got[2].sum()) >= 16 * (4 * rows * cols // 3)


def test_k7_three_different_pages_in_one_launch(dev):
    rs = np.random.RandomState(3)
    bits = torch.from_numpy(
        rs.rand(3, 100, 37) < np.array([0.05, 0.3, 0.7])[:, None, None])
    bits = bits.to(dev)
    ctx = torch.stack([compress.scab_ctx_map(b, tmpl=12, stripe_rows=33)
                       for b in bits])
    p_used = torch.from_numpy(
        rs.randint(1, 4096, (3, 4096)).astype(np.int16)).to(dev)
    got = _k7_matches_plain(bits, ctx, p_used, 33, 32)
    assert len(set(got[2].sum(1).tolist())) == 3


@pytest.mark.parametrize("entropy", ["host", "device"])
@pytest.mark.parametrize("name,T", [("doc512.pbm", 0), ("text64.pbm", 2),
                                    ("ragged75x101.pbm", 4)])
def test_codec13_on_card_matches_cpu(dev, name, T, entropy):
    img = pnm.read_pbm(os.path.join(FIX, name))
    p = codec.CodecParams(codec=13, W=0, T=T, R=0)
    got = compress.encode_scab(img, p, entropy=entropy, device="cuda")
    assert got == compress.encode_scab(img, p, entropy=entropy,
                                       device="cpu")
    np.testing.assert_array_equal(codec.decode(got), img)


# (planes, rows, cols, density, first one, kind): odd widths, a first run
# of 0 and of >= 1, empty and full residuals, one tile and many; a single
# one at the last pixel (one run across every chunk), ones only in the
# first and last words, whole chunks of 512 ones, words that are not a
# whole number of chunks (37 x 70: 111 words), a color page's 24 planes,
# and a stack of 65,536 16-word chunks, which K8 takes in 64-word ones
K8_CASES = [(1, 64, 96, 0.02, None, None), (2, 33, 61, 0.5, None, None),
            (3, 75, 101, 0.1, None, None), (1, 180, 100, 0.05, 0, None),
            (1, 180, 100, 0.05, 5, None), (2, 300, 64, 0.0, None, None),
            (1, 32, 32, 1.0, None, None), (4, 512, 512, 0.2, None, None),
            (2, 300, 200, 0, None, "last pixel"),
            (2, 100, 300, 0, None, "first and last words"),
            (2, 64, 512, 0, None, "512 ones"),
            (3, 37, 70, 0.3, None, None), (24, 96, 130, -1, None, None),
            (8, 2048, 2048, 0.1, None, None)]


def _k8_planes(P, rows, cols, dens, first, kind, rs):
    """Residual planes; dens -1: each plane its own density."""
    if dens < 0:
        return rs.rand(P, rows, cols) < rs.rand(P)[:, None, None]
    res = rs.rand(P, rows, cols) < dens
    if kind == "last pixel":
        res[:] = False
        res[:, -1, -1] = True
    elif kind == "first and last words":
        res[:] = False
        res[:, 0, :32] = rs.rand(P, 32) < 0.5
        res[:, -1, (cols - 1) // 32 * 32:] = True
    elif kind == "512 ones":
        res = rs.rand(P, rows, cols) < 0.05
        res[:, 5:7] = True
    if first is not None:
        res.reshape(P, -1)[:, :first + 1] = False
        res.reshape(P, -1)[:, first] = True
    return res


@pytest.mark.parametrize("P,rows,cols,dens,first,kind", K8_CASES)
def test_k8_kernel_matches_plain(dev, P, rows, cols, dens, first, kind):
    rs = np.random.RandomState(rows * cols + P)
    res = _k8_planes(P, rows, cols, dens, first, kind, rs)
    r = torch.from_numpy(bitpack.np_pack(res).view(np.int32)).to(dev)
    before = _cuda.launches["eg_encode"]
    got = egdevice.eg_encode(r, cols)
    assert _cuda.launches["eg_encode"] == before + 1
    want = egdevice.eg_encode_plain(r, cols)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_k7_stack_one_launch_matches_pages(dev):
    """A stack of 8 planes in one K7 launch == rans_page_encode of each
    (250 rows: the last stripe is short)."""
    rs = np.random.RandomState(8)
    gray = (np.cumsum(rs.rand(250, 192) < 0.3, axis=1) * 7 % 256)
    planes = ((gray[None] >> np.arange(8)[:, None, None]) & 1).astype(bool)
    bits = torch.from_numpy(planes).to(dev)
    ctx = compress.scab_ctx_map(bits, tmpl=12, stripe_rows=64)
    before = _cuda.launches["rans_encode"]
    stack = ransdevice.rans_stack_encode(bits, ctx, stripe_rows=64)
    assert _cuda.launches["rans_encode"] == before + 1
    for i in range(8):
        one = ransdevice.rans_page_encode(bits[i], ctx[i], stripe_rows=64)
        for k, v in one.items():
            assert torch.equal(stack[k][i], v), k


@pytest.mark.parametrize("backend", ["device", "device-assembly",
                                     "device-rans"])
def test_pgm_on_card_matches_cpu(dev, backend):
    rs = np.random.RandomState(9)
    gray = (np.abs(np.cumsum(rs.randn(96, 130), axis=1)) * 9).astype(
        np.uint32) % 256
    p = None if backend == "device-rans" else codec.CodecParams(codec=10,
                                                                 W=0)
    got = codec.encode_pgm(gray, 255, p, backend=backend, device="cuda")
    assert got == codec.encode_pgm(gray, 255, p, backend=backend,
                                   device="cpu")
    np.testing.assert_array_equal(codec.decode_pgm(got)[0], gray)


def test_dense_planes_one_k8_launch(dev):
    """A stack whose planes lie past the run-array ladder (residuals of
    0.3 to 0.9 ones) is coded by one K8 launch, with the native coder's
    bytes."""
    rs = np.random.RandomState(10)
    planes = rs.rand(3, 120, 200) < np.array([0.3, 0.5, 0.9])[:, None, None]
    before = _cuda.launches["eg_encode"]
    got = compress.encode_planes_device(planes, "device", device="cuda")
    assert _cuda.launches["eg_encode"] == before + 1
    assert got == compress.encode_planes_device(planes, "native",
                                                device="cpu")
