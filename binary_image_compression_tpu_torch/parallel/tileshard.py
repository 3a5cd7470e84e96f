"""One page's windowed-search analysis with its tile rows sharded over the
ranks of the 'data' axis.

Counterpart of ``binary_image_compression_tpu/parallel/tileshard.py``:
``_analyze_shard`` (:38), ``analyze_tile_sharded`` (:98) and
``encode_tile_sharded`` (:135).  In causal mode the search reads only the
original pixels, so each rank can analyse its own block of tile rows once
it has the R rows of causal context above the block, pulled from the ranks
above in ceil(R / block_rows) hops (a hop sends only the rows its receiver
keeps).  The rank then searches its *shard frame* (the R halo rows, then
its block) with K1 (``fused_search``) or, for shapes K1 does not take, K4
(``select_windows``), both with the tiles at frame row row0 = R and the
masks and scan keys in absolute rows (y_base = the block's first row - R),
and finishes the selection in frame rows (``compress.finish_analysis``).
Frame rows above the page (the top ranks' zero halo) have negative
absolute rows, which the windows never reach.

The analyses are gathered to the line's first rank, which drops the
records of the pad tile rows and assembles the stream with native
``bic_decide_pack``, as JAX's ``_assemble`` does: the stream is
byte-identical to ``compress.encode`` on one device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import compress
from ..ops import fused_search, select_windows
from ..ops._cuda import resolve_device
from ..utils.profiling import PipelineProfile
from .mesh import Mesh


def _halo_frame(mesh: Mesh, block: torch.Tensor, R: int) -> torch.Tensor:
    """[R + block_rows, gw]: the R rows above this rank's block (zeros
    above the page), then the block.  Hop h moves the bottom
    min(block_rows, R - (h-1) * block_rows) rows of each block h ranks
    down; all hops go in one batch."""
    n, idx = mesh.shape["data"], mesh.axis_index("data")
    blk = block.shape[0]
    hops = -(-R // blk)
    keep = [min(blk, R - (h - 1) * blk) for h in range(1, hops + 1)]
    sends = [(block[blk - k:], idx + h)
             for h, k in zip(range(1, hops + 1), keep) if idx + h < n]
    recvs = [((k, block.shape[1]), block.dtype, idx - h)
             for h, k in zip(range(1, hops + 1), keep) if idx - h >= 0]
    got = iter(mesh.permute(sends, recvs, "data"))
    parts = [next(got).to(block.device) if idx - h >= 0 else
             torch.zeros((k, block.shape[1]), dtype=block.dtype,
                         device=block.device)
             for h, k in zip(range(1, hops + 1), keep)]
    return torch.cat(parts[::-1] + [block])


def _analyze_shard(frame: torch.Tensor, *, base: int, W: int, R: int,
                   T_thresh: int, cols: int, invert: bool) -> dict:
    """K1 or K4 on the shard frame, then the finish; frame 0/1
    [R + block_rows, nx*W] on the compute device."""
    ny_loc = (frame.shape[0] - R) // W
    nx = frame.shape[1] // W
    kw = dict(W=W, R=R, T_thresh=T_thresh, cols=cols, invert=invert,
              y_base=base - R, row0=R)
    img = frame[None]
    if fused_search.fused_supported(ny_loc, nx, W, R):
        sel, oy, plane = fused_search.fused_search_select(img, ny_loc, nx,
                                                          **kw)
    else:
        sel, oy, _ = select_windows.select_windows(img, ny_loc, nx, **kw)
        plane = None
    return compress.finish_analysis(img, sel, oy, plane, W=W, nx=nx, row0=R)


def analyze_tile_sharded(mesh: Mesh, img_grid, *, W: int, R: int,
                         T_thresh: int, rows: int, cols: int,
                         invert: bool = True, device="cuda",
                         profile: PipelineProfile | None = None):
    """Windowed-search analysis of one page, tile rows sharded over 'data'.

    img_grid: 0/1 [gh, gw] padded tile grid (gh = ny*W, gw = nx*W), as
    every rank has it; a rank reads only its own block and receives its
    halo.  gh is zero-padded to a multiple of the rank count (the pad tile
    rows come after every real tile, so they cannot change a real tile's
    candidates).  Returns (the ``analysis_block`` of the padded grid's
    ny_pad * nx tiles in raster order as a host numpy array, on the line's
    first rank, else None; ny_pad).  profile: stages ``halo``,
    ``shard_analysis`` (to the analysis on the host), ``gather``."""
    prof = profile if profile is not None else PipelineProfile()
    dev = resolve_device(device)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    n, idx = mesh.shape["data"], mesh.axis_index("data")
    grid = torch.as_tensor(np.asarray(img_grid, dtype=np.uint8))
    gh, gw = grid.shape
    ny = gh // W
    ny_pad = -(-ny // n) * n
    blk = ny_pad * W // n
    base = idx * blk
    block = torch.zeros((blk, gw), dtype=torch.uint8)
    own = grid[base:min(base + blk, gh)]
    block[:own.shape[0]] = own
    with prof.stage("halo", R * gw // 8):
        frame = _halo_frame(mesh, block.to(mesh.comm_device), R).to(dev)
        sync()
    with prof.stage("shard_analysis"):
        out = _analyze_shard(frame.bool(), base=base, W=W, R=R,
                             T_thresh=T_thresh, cols=cols, invert=invert)
        local = compress.analysis_block(out)[0].cpu()
    with prof.stage("gather"):
        got = mesh.gather_cat(local, "data")
    return (None if got is None else got.numpy()), ny_pad


def encode_tile_sharded(mesh: Mesh, img: np.ndarray, params=None, *,
                        device="cuda",
                        profile: PipelineProfile | None = None):
    """Full encode of one page with the analysis tile-sharded over the
    mesh's 'data' ranks: the stream on the line's first rank (byte-
    identical to ``compress.encode`` on one device), None on the others.
    Codecs 4, 7 and 8 in causal mode, R >= W.  profile: the stages of
    ``analyze_tile_sharded`` and ``native_assembly``."""
    from .. import native
    from ..models.codec import CodecParams, _check_W, _header, image_crc
    params = params or CodecParams(codec=8, strict=False)
    if params.codec not in (4, 7, 8) or params.strict:
        raise ValueError("tile sharding takes codecs 4/7/8 in causal mode")
    if params.R < params.W:
        raise ValueError("the device band geometry requires R >= W")
    _check_W(params)
    prof = profile if profile is not None else PipelineProfile()
    img = np.asarray(img, dtype=bool)
    rows, cols = img.shape
    W = params.W
    ny, nx = -(-rows // W), -(-cols // W)
    grid = np.zeros((ny * W, nx * W), dtype=np.uint8)
    grid[:rows, :cols] = img
    block, _ = analyze_tile_sharded(
        mesh, grid, W=W, R=params.R, T_thresh=params.resolved_T(),
        rows=rows, cols=cols, invert=params.codec == 8, device=device,
        profile=prof)
    if block is None:
        return None
    with prof.stage("native_assembly"):
        out = compress.split_analysis(block[:ny * nx])   # drop the pad rows
        hdr = _header(params, rows, cols, image_crc(img))
        return native.decide_pack(
            hdr, W * W, params.codec, out["weights4"], out["has_cands"],
            out["idx_len"], out["inv"], out["rank"], out["residual4"])[0]
