"""Codec 10's adaptive exponential-Golomb run coder on the device (K8).

Counterpart of ``binary_image_compression_tpu/ops/egdevice.py``.  The coder
(native ``bic_eg_encode_runs``) codes each zero run of the MED residual, in
raster order, as one '1' per full block of the current LUT state (the state
grows by one each time) and then '0' plus the g-bit remainder (the state
shrinks by one).  The state space is the 32 LUT indices, so each run is a
map state -> state, and the entry state of every run is a prefix
composition of those maps; with the entry states known every run's code is
independent.

``eg_encode`` is kernel K8 (``csrc/eg_encode.cu``, note at its top): it
reads the packed residual itself, with no run array, in three kernels.
Warps take chunks of ``CHUNK_WORDS`` words (64 where the stack has many
chunks for the card's resident warps): each finds its chunk's ones and
walks the runs between them from each of the 32 states at once (lane s
from state s; a run step is a lookup in ``step_table`` or a closed form,
never a loop over blocks) for the chunk's aggregate (map, code length from
each state, first and last one); a block composes its tile of
``CHUNKS_PER_BLOCK`` chunks.  A block per plane scans the tiles in about
sqrt(tiles) segments.  Then each warp takes its chunk's entry state and
bit offset, re-walks its runs and its 32 lanes write the codes.  For CPU tensors it runs the plain version: the run
lengths by ``torch.nonzero`` (``runs_from_residual_flat``), the transition
maps of every run from every state (``_run_transitions``), a log-step
gather scan of their composition (``compose_scan``; torch has no
``associative_scan``), each run's code split into 32-bit chunks and
``bitstream.pack_varlen`` (``eg_encode_runs_plain``).  The plain version
sizes each plane's run array by JAX's capacity ladder (``run_cap``: 12.5 %,
then 25 % ones, then every pixel), from an exact run count
(``run_counts``); K8 needs neither.

As in the reference (eg.h's constructor), the coder starts off the LUT
with g = 1 and a block of 1: a first run of length >= 1 consumes one pixel
and lands on state 1, a first run of 0 writes '0' + a 1-bit remainder and
stays at state 0.  The payload buffer is ``n_pixels // 8 + 8`` words;
callers check that the bit count fits it.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from . import _cuda, bitpack
from .bitpack import U32
from .bitstream import pack_varlen
from .entropy import EG_BLOCKS, EGLUT

CHUNK_WORDS = 16                    # K8: words of a chunk (64 on big stacks)
CHUNKS_PER_BLOCK = 8                # K8: chunks of a tile (a block's warps)
RECORD_INTS = 42                    # K8: an aggregate's workspace record
TAB_RUNS = 64                       # K8: run lengths its step table holds


@lru_cache(maxsize=8)
def _geometry(n_pixels: int) -> tuple[int, int]:
    """(J_max, K): the most '1' prefix bits a run of up to n_pixels zeros can
    emit (from state 0, blocks growing along the LUT, then 2^15 each), and
    the 32-bit chunks of one run's code (at most J_max + 1 + 15 bits)."""
    if n_pixels >= 2 ** 30:
        raise ValueError(f"{n_pixels} pixels: codec 10 on the device takes "
                         "fewer than 2^30")
    acc, j = 0, 0
    while acc < n_pixels:
        acc += EG_BLOCKS[min(j, 31)]
        j += 1
    return j, -(-(j + 16) // 32)


def payload_words(n_pixels: int) -> int:
    """The payload buffer of one plane, in 32-bit words (JAX
    ``eg_encode_runs_device``'s bound: EG expands dense residuals, but stays
    well under 4 bits a pixel)."""
    return n_pixels // 8 + 8


def run_cap(n_pixels: int, level: int = 0) -> int:
    """The run capacity at a ladder level: level 0 a 12.5 % ones density
    (n/8 + 2), level 1 25 % (n/4 + 2), as JAX ``compress._eg_run_cap``
    :804.  The plain K8 sizes its run array by it."""
    return n_pixels // (8 >> level) + 2


def run_counts(res: torch.Tensor, cols: int) -> torch.Tensor:
    """Exact codec-10 run count per residual plane of int32 [P, rows, nw]
    (JAX ``compress._planes_run_counts`` :849): the ones (SWAR popcount),
    plus the trailing zero run, which exists iff the residual is empty or
    its last pixel is 0.  int64 [P]."""
    ones = bitpack.popcount(bitpack.from_i32(res)).sum((-2, -1))
    last_bit = (res[:, -1, -1] >> (31 - (cols - 1) % 32)) & 1
    return ones + ((ones == 0) | (last_bit == 0)).to(torch.int64)


def plain_cap(n_pixels: int, n_runs: int) -> int | None:
    """The plain K8's run array for a plane of n_runs runs: the first
    ladder rung that holds them, else None (n_pixels + 1, every pixel)."""
    return next((run_cap(n_pixels, lv) for lv in (0, 1)
                 if n_runs <= run_cap(n_pixels, lv)), None)


def runs_from_residual_flat(flat_bits: torch.Tensor, *, n_pixels: int,
                            cap: int | None = None):
    """Zero-run lengths of a flat 0/1 residual: the gap before each 1, then
    the trailing zero run when it is not empty (``codec._medrle_runs``).

    Returns (runs int64 [cap or n_pixels + 1], n_runs int64 []), zeros past
    the runs.  Whenever the true run count fits `cap` both are exact; when
    it does not, n_runs is still > cap (it counts from the first cap ones
    only), which is what callers test to route the plane elsewhere."""
    size = n_pixels + 1 if cap is None else cap
    dev = flat_bits.device
    flat = flat_bits.reshape(n_pixels).to(torch.int64)
    n_ones = flat.sum()
    idx = torch.nonzero(flat)[:size, 0]
    idx = torch.cat([idx, torch.full((size - idx.shape[0],), n_pixels,
                                     dtype=torch.int64, device=dev)])
    prev = torch.cat([torch.full((1,), -1, dtype=torch.int64, device=dev),
                      idx[:-1]])
    live = torch.arange(size, device=dev) < n_ones
    gaps = torch.where(live, idx - prev - 1, 0)
    last_one = torch.where(n_ones > 0,
                           idx[torch.clamp(n_ones - 1, 0, size - 1)], -1)
    trailing = n_pixels - 1 - last_one
    # the trailing run goes at index n_ones, dropped past the array
    runs = torch.cat([gaps, gaps.new_zeros(1)])
    runs.scatter_(0, torch.clamp(n_ones, max=size).reshape(1),
                  trailing.reshape(1))
    return runs[:size], n_ones + (trailing > 0).to(torch.int64)


def _run_transitions(runs: torch.Tensor, n_pixels: int):
    """Every run from every entry state: (exit, nb, rem, s_term), int64
    [N, 32]: the state after the run, its '1' prefix bits, the remainder
    and the state at its '0' terminator.  J_max elementwise steps, each
    consuming one more block where it fits (blocks never shrink along the
    LUT, so the blocks taken are a prefix)."""
    jmax, _ = _geometry(n_pixels)
    dev = runs.device
    s0 = torch.arange(32, device=dev)[None, :]
    blocks = torch.tensor(EG_BLOCKS, dtype=torch.int64, device=dev)
    rem = runs.to(torch.int64)[:, None].expand(-1, 32)
    nb = torch.zeros_like(rem)
    for t in range(jmax):
        blk = blocks[torch.clamp(s0 + t, max=31)]
        take = rem >= blk
        rem = rem - torch.where(take, blk, 0)
        nb = nb + take
    s_term = torch.clamp(s0 + nb, max=31)
    return torch.clamp(s_term - 1, min=0), nb, rem, s_term


def _compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a then b) on [..., 32] state maps: out[s] = b[a[s]]."""
    return torch.gather(b, -1, a)


def compose_scan(maps: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of map composition over dim 0 of int64 [N, 32]:
    out[i] = maps[0] then maps[1] ... then maps[i], in ceil(log2 N) gather
    steps (Hillis-Steele: out[i] = out[i - d] then out[i], d = 1, 2, 4...)."""
    out, d = maps, 1
    while d < out.shape[0]:
        out = torch.cat([out[:d], _compose(out[:-d], out[d:])])
        d *= 2
    return out


def eg_encode_runs_plain(runs: torch.Tensor, n_runs, *, n_pixels: int):
    """Plain PyTorch K8 on a run array (JAX ``eg_encode_runs_device`` :106).

    runs: int [N] zero-run lengths, entries at and past n_runs ignored.
    Returns (words int64 [payload_words(n_pixels)] of uint32 values,
    total_bits int64 []); ``bitstream.words_to_bytes`` gives the bytes of
    ``native.eg_encode_runs``."""
    _, K = _geometry(n_pixels)
    dev = runs.device
    runs = runs.to(torch.int64)
    N = runs.shape[0]
    live = torch.arange(N, device=dev) < n_runs
    # run 0: one '1' from the constructor's block of 1, then runs[0] - 1
    # coded from state 1; a first run of 0 is '0' + a 1-bit remainder
    L0 = runs[0]
    runs_adj = torch.cat([torch.clamp(L0 - 1, min=0).reshape(1), runs[1:]])
    exit_s, nb_all, rem_all, s_term_all = _run_transitions(runs_adj, n_pixels)
    ident = torch.arange(32, device=dev).expand(N, 32)
    exit_s = torch.where(live[:, None], exit_s, ident)   # identity tail
    exit0 = torch.where(L0 >= 1, exit_s[0, 1], 0)
    exit_s = torch.cat([exit0.expand(1, 32), exit_s[1:]])
    chain = compose_scan(exit_s)
    entry = torch.cat([torch.ones(1, dtype=torch.int64, device=dev),
                       chain[:-1, 0]])
    pick = lambda tab: tab.gather(1, entry[:, None])[:, 0]
    lut = torch.tensor(EGLUT, dtype=torch.int64, device=dev)
    nb, rem, g = pick(nb_all), pick(rem_all), lut[pick(s_term_all)]
    first = torch.arange(N, device=dev) == 0
    nb = torch.where(first, torch.where(L0 >= 1, nb + 1, 0), nb)
    g = torch.where(first & (L0 < 1), 1, g)
    rem = torch.where(first & (L0 < 1), 0, rem)
    cl = torch.where(live, nb + 1 + g, 0)

    # each code: nb ones, '0', the g-bit remainder, split MSB-first into K
    # 32-bit chunks at bits [32c, 32c + len_c)
    c = torch.arange(K, device=dev)[None, :]
    len_c = torch.clamp(cl[:, None] - 32 * c, 0, 32)
    ones_c = torch.minimum(torch.clamp(nb[:, None] - 32 * c, min=0), len_c)
    tail_len = len_c - ones_c
    toff = torch.clamp(32 * c + ones_c - nb[:, None], 0, 31)
    shift = torch.clamp((g + 1)[:, None] - toff - tail_len, 0, 31)
    low = lambda k: torch.where(k >= 32, U32,
                                (1 << torch.clamp(k, max=31)) - 1)
    tail = (rem[:, None] >> shift) & low(tail_len)
    value = ((low(ones_c) << torch.clamp(tail_len, max=31)) | tail) & U32
    return pack_varlen(value.reshape(-1), len_c.reshape(-1),
                       payload_words(n_pixels))


def eg_encode_plain(res: torch.Tensor, cols: int):
    """Plain PyTorch K8 on packed residual planes: for each plane its runs
    (``runs_from_residual_flat``, the array sized by ``plain_cap``) and
    ``eg_encode_runs_plain``.  Returns what ``eg_encode`` returns."""
    P, rows, _ = res.shape
    n = rows * cols
    flat = bitpack.unpack(res, cols).reshape(P, n)
    out = [eg_encode_runs_plain(*runs_from_residual_flat(
               f, n_pixels=n, cap=plain_cap(n, c)), n_pixels=n)
           for f, c in zip(flat, run_counts(res, cols).tolist())]
    return (bitpack.to_i32(torch.stack([w for w, _ in out])),
            torch.stack([b for _, b in out]))


def eg_encode(res: torch.Tensor, cols: int):
    """K8 over a stack of MED residual planes, every plane in one launch.

    res: int32 [P, rows, nwords(cols)] packed residuals (bits past `cols`
    zero).  Returns (words int32 [P, payload_words(rows * cols)], uint32
    bit patterns of each plane's codec-10 payload, MSB-first; bits int64
    [P], each payload's length).  Words past a payload's length are zero;
    a payload longer than its buffer is cut there, and its caller raises.
    CUDA tensors launch the kernel; CPU tensors run ``eg_encode_plain``."""
    if res.is_cuda:
        return _launch(res, cols)
    if res.device.type == "cpu":
        return eg_encode_plain(res, cols)
    raise RuntimeError(f"K8 has no kernel for device {res.device}")


def chunk_geometry(rows: int, nw: int) -> tuple[int, int]:
    """(chunks, tiles) of one plane of rows x nw words in K8 at
    ``CHUNK_WORDS``, the most it takes."""
    n_chunks = -(-(rows * nw) // CHUNK_WORDS)
    return n_chunks, -(-n_chunks // CHUNKS_PER_BLOCK)


def workspace_ints(P: int, rows: int, nw: int) -> int:
    """K8's workspace for P planes, in int32, as ``csrc/eg_encode.cu`` lays
    it out: a record and an entry (4 ints) per tile, each part rounded up
    to 32 ints, then a record per chunk."""
    NC, NT = chunk_geometry(rows, nw)
    r32 = lambda v: -(-v // 32) * 32
    return r32(P * NT * RECORD_INTS) + r32(P * NT * 4) + P * NC * RECORD_INTS


@lru_cache(maxsize=8)
def step_table(device: torch.device) -> torch.Tensor:
    """K8's step table on `device`, built once per device from
    ``_run_transitions``: int32 [TAB_RUNS * 32], entry L * 32 + s the run of
    L zeros from state s as the kernel carries a step (4 * exit | code
    bits << 8)."""
    exit_s, nb, _, s_term = _run_transitions(torch.arange(TAB_RUNS), TAB_RUNS)
    bits = nb + 1 + torch.tensor(EGLUT)[s_term]
    return (exit_s << 2 | bits << 8).to(torch.int32).reshape(-1).to(device)


def _launch(res: torch.Tensor, cols: int):
    """Launch csrc/eg_encode.cu's three kernels on the current stream."""
    P, rows, nw = res.shape
    dev = res.device
    if (res.dtype != torch.int32 or not res.is_contiguous()
            or nw != bitpack.nwords(cols) or P < 1 or rows < 1):
        raise ValueError(f"K8: res must be contiguous int32 [P, rows, "
                         f"{bitpack.nwords(cols)}], not {res.dtype} "
                         f"{tuple(res.shape)}")
    n = rows * cols
    _geometry(n)
    TW = payload_words(n)
    words = torch.zeros((P, TW), dtype=torch.int32, device=dev)
    nbits = torch.empty(P, dtype=torch.int64, device=dev)
    ws = torch.empty(workspace_ints(P, rows, nw), dtype=torch.int32,
                     device=dev)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    lib = _cuda.get_lib()
    _cuda.check(lib.bic_eg_encode(
        ptr(res), ptr(step_table(dev)), ptr(ws), ptr(words), ptr(nbits), P,
        rows, cols, nw, TW, ws.numel(), _cuda.stream(dev)), "bic_eg_encode")
    _cuda.launches["eg_encode"] += 1
    return words, nbits
