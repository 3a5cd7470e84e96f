"""K1-K6 on the card against their plain PyTorch versions, the port's
causal and strict encodes on the card against the native host encoder, and
codec 11 and BSVD learning on the card against the CPU run.

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
from binary_image_compression_tpu_torch.ops import packed_dist
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


@pytest.mark.parametrize("rows,cols,W,R,invert", [
    (75, 101, 8, 16, True), (96, 128, 16, 64, False),
    (256, 320, 32, 192, True)])
def test_k1_kernel_matches_plain(dev, rows, cols, W, R, invert):
    pages = np.random.RandomState(rows).rand(2, rows, cols) < 0.3
    ny, nx = -(-rows // W), -(-cols // W)
    grid = np.zeros((2, ny * W, nx * W), dtype=bool)
    grid[:, :rows, :cols] = pages
    img = torch.from_numpy(grid).to(dev)
    E = fs.to_i32(fs._field_plane(img, W, fs.plane_height(ny * W, W, R),
                                  nx * W)).contiguous()
    kw = dict(W=W, R=R, T_thresh=1, cols=cols, invert=invert, y_base=0)
    before = _cuda.launches["fused_search_select"]
    got = fs._launch(E, ny, nx, **kw)
    assert _cuda.launches["fused_search_select"] == before + 1
    want = fs.fused_search_select_plain(E, ny, nx, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


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


@pytest.mark.parametrize("rows,cols,W,R", [(96, 128, 40, 64),
                                           (192, 256, 64, 128),
                                           (64, 200, 33, 40)])
def test_k4_kernel_matches_plain(dev, rows, cols, W, R):
    pages = np.random.RandomState(W).rand(2, rows, cols) < 0.3
    grid = np.zeros((2, -(-rows // W) * W, -(-cols // W) * W), dtype=bool)
    grid[:, :rows, :cols] = pages
    d, oy, ox = search.window_distance_maps_banded(
        torch.from_numpy(grid).to(dev), W, R)
    kw = dict(W=W, R=R, T_thresh=1, cols=cols, invert=True)
    nx = grid.shape[2] // W
    before = _cuda.launches["select_windows"]
    got = sw.select_windows(d, oy, ox, nx, **kw)
    assert _cuda.launches["select_windows"] == before + 1
    want = sw.select_windows_plain(d, oy, ox, nx, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert int(got[..., 3].sum()) > 0


def _host(img, p):
    hdr = codec._header(p, *img.shape, codec.image_crc(img))
    return native.encode_windowed(img, hdr, 8, p.strict, p.W, p.resolved_T(),
                                  p.R)


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
    for k in ("select_windows", "decide_modes"):
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
    img = pnm.read_pbm(os.path.join(FIX, "ragged75x101.pbm"))
    p = codec.CodecParams(codec=11, W=8, T=0, R=0)
    before = dict(_cuda.launches)
    blob = codec.encode(img, p, device="cuda")
    for name in ("packed_dist_matrix", "packed_row_weight"):
        assert _cuda.launches[name] > before.get(name, 0)
    assert blob == codec.encode(img, p, device="cpu")
    np.testing.assert_array_equal(codec.decode(blob), img)


@pytest.mark.parametrize("m", [2080, 4096])
def test_wide_pursuit_on_card_launches_k5(dev, m):
    """Rows wider than JAX's packed bound (2048 bits) still take K5."""
    rs = np.random.RandomState(m)
    D = rs.rand(8, m) < 0.25
    A = rs.rand(48, 8) < 0.15
    E = ((A.astype(np.int64) @ D.astype(np.int64)) % 2 == 1) ^ (
        rs.rand(48, m) < 0.3)
    args = [torch.from_numpy(x.astype(np.int8)) for x in (E, D, A)]
    want = bsvd.update_coefficients(*args)
    before = dict(_cuda.launches)
    got = bsvd.update_coefficients(*(x.to(dev) for x in args))
    assert _cuda.launches["packed_dist_matrix"] > before.get(
        "packed_dist_matrix", 0)
    assert _cuda.launches["packed_row_weight"] == before.get(
        "packed_row_weight", 0) + 1
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
