"""Process start-up, the pod grid, the page-sharded corpus encode and the
page-sharded archive.

Counterpart of ``binary_image_compression_tpu/parallel/multihost.py``:
``init_distributed`` (:25), ``make_pod_mesh`` (:55), ``page_shard_bounds``
(:69), ``merge_host_offsets`` (:78) and ``encode_corpus_sharded`` (:85).
JAX starts ``jax.distributed`` once per host; here every rank is one
process with one device, started by the caller (``torchrun``, or the
``BIC_*`` variables) and joined into a ``torch.distributed`` world.  The
corpus is split into contiguous page ranges, one per rank, each encoded
through the same batched engine as the single-device archive
(``archive.encode_pages``); the per-page byte counts are all-gathered and
scanned into the corpus's offsets, so no page crosses ranks.

``encode_archive_sharded`` makes one BICA file of that: each rank keeps
its own journal (``<checkpoint>.rank<r>``), writes its streams into the
file at their offsets, and removes its journal only once rank 0 has
fsynced the file.
"""

from __future__ import annotations

import os
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from ..utils.profiling import count, span
from .mesh import Mesh


def default_backend(device) -> str:
    """The collective backend for compute on `device`: BIC_DIST_BACKEND if
    set, else NCCL for a CUDA device and gloo for the CPU.  It follows the
    caller's device; it never probes for a GPU."""
    return os.environ.get("BIC_DIST_BACKEND") or (
        "nccl" if torch.device(device).type == "cuda" else "gloo")


def _bind_device(backend: str, device) -> None:
    """Under NCCL, make the rank's GPU current: `device`'s index if it has
    one, else LOCAL_RANK (torchrun), else 0."""
    if backend != "nccl":
        return
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"NCCL takes CUDA tensors; device={device}")
    idx = dev.index if dev.index is not None else int(
        os.environ.get("LOCAL_RANK", "0"))
    torch.cuda.set_device(idx)


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, *,
                     backend: str | None = None, device="cuda",
                     timeout: float | None = None) -> bool:
    """Join the torch.distributed world of a multi-process run.

    Resolution order: explicit args > BIC_COORDINATOR ("host:port") /
    BIC_NUM_PROCESSES / BIC_PROCESS_ID > torchrun's MASTER_ADDR /
    MASTER_PORT / WORLD_SIZE / RANK > no-op (single process, returns
    False).  backend: "nccl" or "gloo" (default ``default_backend``).
    timeout: seconds that joining, and later each collective, may wait
    for the other ranks (torch's default where None).  Returns True once
    the world is up (also when it already was)."""
    if dist.is_initialized():
        return True
    if coordinator is None:
        coordinator = os.environ.get("BIC_COORDINATOR")
        if coordinator is not None:
            num_processes = num_processes or int(
                os.environ["BIC_NUM_PROCESSES"])
            process_id = process_id if process_id is not None else int(
                os.environ["BIC_PROCESS_ID"])
    if coordinator is None and "MASTER_ADDR" in os.environ:
        coordinator = (f"{os.environ['MASTER_ADDR']}:"
                       f"{os.environ['MASTER_PORT']}")
        num_processes = int(os.environ["WORLD_SIZE"])
        process_id = int(os.environ["RANK"])
    if coordinator is None:
        return False
    backend = backend or default_backend(device)
    _bind_device(backend, device)
    extra = {} if timeout is None else {"timeout": timedelta(seconds=timeout)}
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            **extra)
    return True


def init_single_process(*, backend: str | None = None, device="cuda") -> None:
    """A world of one rank in this process (an in-memory store), for
    running the sharded paths without a launcher."""
    if dist.is_initialized():
        return
    backend = backend or default_backend(device)
    _bind_device(backend, device)
    dist.init_process_group(backend, store=dist.HashStore(), world_size=1,
                            rank=0)


def make_pod_mesh(model: int = 1) -> Mesh:
    """(hosts, data, model) grid: hosts outermost, so page-parallel work
    stays within a host's line.  A host's ranks are LOCAL_WORLD_SIZE
    (torchrun) consecutive ranks, else one rank (one process per host, as
    the BIC_* launch starts them)."""
    world = dist.get_world_size()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    if world % local or local % model:
        raise ValueError(f"{world} ranks, {local} per host, model={model}: "
                         "no (hosts, data, model) grid")
    return Mesh(np.arange(world).reshape(world // local, local // model,
                                         model), ("hosts", "data", "model"))


def page_shard_bounds(n_pages: int, n_shards: int,
                      shard: int) -> tuple[int, int]:
    """Contiguous page range for a shard (balanced, deterministic)."""
    base = n_pages // n_shards
    extra = n_pages % n_shards
    start = shard * base + min(shard, extra)
    size = base + (1 if shard < extra else 0)
    return start, start + size


def merge_host_offsets(page_bytes: np.ndarray) -> np.ndarray:
    """Exclusive byte offsets for every page of the corpus given per-page
    byte counts (already all-gathered): the bitstream-merge scan."""
    page_bytes = np.asarray(page_bytes, dtype=np.int64)
    return np.cumsum(page_bytes) - page_bytes


def _world() -> tuple[int, int]:
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _comm_device() -> torch.device:
    """Where the world's collectives take their tensors: the rank's GPU
    under NCCL, the host otherwise."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def job_barrier() -> None:
    """Wait until every rank of the world has arrived (span
    ``job.barrier``): an all-reduce of one element, read back on the host,
    so that it returns only once all ranks have sent theirs."""
    with span("job.barrier"):
        if _world()[0] > 1:
            flag = torch.zeros(1, dtype=torch.int32, device=_comm_device())
            dist.all_reduce(flag)
            flag.item()


def encode_corpus_sharded(pages, encode_fn=None, mesh: Mesh | None = None,
                          *, params=None, batch_size: int = 8,
                          device="cuda") -> list[bytes]:
    """Encode a batch of pages with page-level sharding.

    pages: [B, rows, cols] bool (every rank has the list).  Each rank
    encodes its contiguous page range through the same batched engine as
    the single-device archive (``archive.encode_pages`` on `device`), or
    page by page with `encode_fn`.  Returns this rank's blobs in page
    order.  `mesh` is unused (JAX's signature): the ranks are the world's."""
    n, rank = _world()
    lo, hi = page_shard_bounds(len(pages), n, rank)
    if encode_fn is not None:
        return [encode_fn(pages[i]) for i in range(lo, hi)]
    from ..models import archive
    return archive.encode_pages([pages[i] for i in range(lo, hi)], params,
                                batch_size=batch_size, device=device)


def gather_page_bytes(blobs: list[bytes], n_pages: int) -> np.ndarray:
    """Every page's byte count, in page order, from each rank's blobs of
    its contiguous range: one all-gather of the counts, each rank's padded
    to the longest range (counter ``allgather_bytes``: the gathered
    tensor's bytes)."""
    n, _ = _world()
    width = -(-n_pages // n)
    counts = torch.full((width,), -1, dtype=torch.int64)
    counts[:len(blobs)] = torch.tensor([len(b) for b in blobs],
                                       dtype=torch.int64)
    if n > 1:
        dev = _comm_device()
        parts = [torch.empty(width, dtype=torch.int64, device=dev)
                 for _ in range(n)]
        dist.all_gather(parts, counts.to(dev))
        counts = torch.cat(parts).cpu()
        count("allgather_bytes", n * width * 8)
    return counts[counts >= 0].numpy()


def corpus_offsets(blobs: list[bytes], n_pages: int) -> np.ndarray:
    """The whole corpus's exclusive page offsets from each rank's blobs of
    ``encode_corpus_sharded``: one all-gather of the per-page byte counts
    (``gather_page_bytes``), then ``merge_host_offsets``."""
    return merge_host_offsets(gather_page_bytes(blobs, n_pages))


def encode_archive_sharded(pages, params=None, *, batch_size: int = 8,
                           device="cuda", checkpoint: str | None = None,
                           output: str, on_progress=None) -> None:
    """Archive `pages` into the BICA file `output` over every rank of the
    world; byte-identical to ``archive.encode_archive`` of the same pages.

    Run on every rank, each with the whole page list.  Each rank encodes
    its ``page_shard_bounds`` range through ``archive.encode_pages``, with
    its own journal ``<checkpoint>.rank<r>`` (appended and fsynced after
    every batch; its fingerprint covers the settings, the world size, the
    range and the range's pages), so a killed job resumes rank by rank.
    One all-gather of the byte counts gives every page's offset; each rank
    writes its streams at them with ``os.pwrite``, and rank 0 the header
    and the file's length.  After a barrier rank 0 fsyncs the file and its
    directory; after another, each rank removes its journal.  `output`
    must be on a file system every rank sees.  A world of one runs the same
    steps in one process.  on_progress(n_done_pages) is called after every
    batch of this rank's.

    Spans, on each rank: ``archive_job`` (the request) > ``archive.shard``
    (the rank's encode, with ``archive.encode_journaled``'s spans),
    ``archive.offsets`` (the all-gather, which waits for the slowest
    rank's encode), ``archive.write``, ``job.barrier`` (two a job: after
    the writes, after the fsync), ``archive.fsync`` (rank 0).  Counters
    ``archive_bytes_written`` and ``allgather_bytes``."""
    from ..models import archive
    from ..models.codec import CodecParams
    params = params or CodecParams(codec=8, strict=False)
    n, rank = _world()
    lo, hi = page_shard_bounds(len(pages), n, rank)
    journal = f"{checkpoint}.rank{rank}" if checkpoint else None
    with span("archive_job"):
        with span("archive.shard"):
            blobs = archive.encode_journaled(
                [pages[i] for i in range(lo, hi)], params,
                batch_size=batch_size, device=device, checkpoint=journal,
                on_progress=on_progress, scope=(n, lo, hi))
        with span("archive.offsets"):
            sizes = gather_page_bytes(blobs, len(pages))
        offsets = merge_host_offsets(sizes)
        header = archive.container_header(offsets)
        with span("archive.write"):
            written = _write_at(output, rank, header, blobs,
                                len(header) + int(offsets[lo]) if blobs
                                else 0, len(header) + int(sizes.sum()))
            count("archive_bytes_written", written)
        job_barrier()
        if rank == 0:
            with span("archive.fsync"):
                _fsync(output)
        job_barrier()
        if journal and os.path.exists(journal):
            os.remove(journal)


def _write_at(path: str, rank: int, header: bytes, blobs: list[bytes],
              at: int, total: int) -> int:
    """This rank's part of the archive file: its streams at `at`, and on
    rank 0 the header and the file's length (`total`, which also cuts off
    what an older file left beyond it); the bytes written."""
    fd = os.open(path, os.O_WRONLY | os.O_CREAT, 0o644)
    try:
        written = 0
        if rank == 0:
            os.ftruncate(fd, total)
            written += os.pwrite(fd, header, 0)
        if blobs:
            data = b"".join(blobs)
            while data:
                k = os.pwrite(fd, data, at)
                data, at, written = data[k:], at + k, written + k
        return written
    finally:
        os.close(fd)


def _fsync(path: str) -> None:
    """Flush the file and the directory entry that names it to the disk."""
    for p, flags in ((path, os.O_RDONLY),
                     (os.path.dirname(os.path.abspath(path)), os.O_RDONLY)):
        fd = os.open(p, flags)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
