"""Closed loop of archive jobs over the ranks of one host, in lockstep: a
job archives the whole pool into one BICA file through the program's
``sharded_entry`` (``multihost.encode_archive_sharded``: each rank codes
its page range on its own card with its own journal, the byte counts are
all-gathered, each rank writes its streams at their offsets).

This process, the harness's, is rank 0.  It builds the program's kernels,
then starts ranks 1 .. n-1 itself, all at once, as this file run as a
script, with the variables torchrun gives its ranks; every rank joins over
a TCP store on 127.0.0.1 (NCCL on the card, gloo on the CPU) through the
program's ``join``, which binds it to its card.
Joining and every collective wait at most ``WORLD_TIMEOUT``; a rank that
fails ends the run (rank 0 watches the others' exit codes), and the others
end with rank 0 (the kernel's parent-death signal, and a thread that
watches the parent).

Set-up: every rank warms one batch and the collectives (a job of one batch
a rank).  The window opens on rank 0, then a "go" all-reduce starts every
rank's first job; after each job an all-reduce carries rank 0's decision
to stop, so the window closes at the end of the first job to end after
``--seconds``.  Each job writes its own file under ``TMPDIR``.  After the
window each rank hands rank 0 its journal records and host-route count
and, in a traced run, its spans (``profiling.write_jsonl`` files under
``TMPDIR``), which join rank 0's recorder with the rank in the high bits
of their request ids (``core/rank_spans``).  Rank 0's own trace is the
traced run's device trace.

``correct``: as the one-card archive's loop (every job's frame sound and
equal to the first job's, every header naming its page, the sampled pages
the reference's streams, every rank's journal holding exactly its
finished pages after each batch and removed after each job, no page sent
to the host encoder), and ``archive_unlike_one_card``: the first job's
file against ``archive.encode_archive`` of the same pool on rank 0's card,
run after the window.

The control (``core/control.py``) offers no sharded entry: given it in
the program's place, every rank runs ``ShardedControl``, the
configuration's own sharded entry over the pages as the control codes
them, each page with its isolated black pixels cleared.
"""

from __future__ import annotations

import collections.abc
import ctypes
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)
WORLD_TIMEOUT = 180.0     # s: joining, and each collective, may wait this
RANK_SHIFT = 40           # a rank's request ids carry it from this bit on
PREFIX = "benchmark-x4"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_env(rank: int, world: int, port: int) -> dict:
    """The variables torchrun gives a rank of a one-host world."""
    return {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
            "WORLD_SIZE": str(world), "RANK": str(rank),
            "LOCAL_RANK": str(rank), "LOCAL_WORLD_SIZE": str(world)}


def _decide(flag: int) -> int:
    """All-reduce (max) of one flag over the world, read on the host: a
    barrier that carries rank 0's decision."""
    from binary_image_compression_tpu_torch.parallel import multihost
    t = torch.tensor([flag], dtype=torch.int32,
                     device=multihost._comm_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return int(t.item())


class _Cleaned(collections.abc.Sequence):
    """The pages as the control codes them, each cleared once, when it is
    first read (so a rank clears only its own range)."""

    def __init__(self, pages, cache: dict):
        self.pages, self.cache = pages, cache

    def __len__(self) -> int:
        return len(self.pages)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[k] for k in range(*i.indices(len(self)))]
        from core.control import despeckle
        page = self.pages[i]
        if id(page) not in self.cache:
            self.cache[id(page)] = despeckle(page)
        return self.cache[id(page)]


class ShardedControl:
    """The control as a program of this loop: the configuration's sharded
    program (its ``join`` and ``sharded_entry``) fed the pages with their
    isolated black pixels cleared, which breaks the guarantee that the
    stream is lossless as ``core/control.py`` breaks it."""

    def __init__(self, config: dict):
        from core.cell import load
        self.program = load("programs", config["program"])
        self.cleaned: dict = {}

    def join(self, config: dict, device, timeout: float) -> None:
        self.program.join(config, device, timeout)

    def sharded_entry(self, config: dict, device):
        run = self.program.sharded_entry(config, device)
        return lambda pages, checkpoint, output, on_progress: run(
            _Cleaned(pages, self.cleaned), checkpoint, output, on_progress)


def _range(n_pages: int, world: int, rank: int) -> tuple[int, int]:
    from binary_image_compression_tpu_torch.parallel import multihost
    return multihost.page_shard_bounds(n_pages, world, rank)


def _drive(cell, pool, device, program, tmp, rank, world, seconds=None,
           win=None):
    """One rank's part of set-up and the window: the warm job, then jobs
    until rank 0 says stop.  Rank 0 (`win` given) opens and closes the
    window.  Returns (per job: (journal progress, journal left), the job
    files, rank 0's job end times)."""
    entry = program.sharded_entry(cell.config, device)
    bs = cell.config["archive_batch_size"]
    journal = os.path.join(tmp, f"{PREFIX}.journal")
    mine = f"{journal}.rank{rank}"
    warm = []
    for r in range(world):
        lo, hi = _range(len(pool), world, r)
        warm += pool[lo:min(hi, lo + bs)]
    warm_file = os.path.join(tmp, f"{PREFIX}-warm.bica")
    entry(warm, journal, warm_file, None)
    _decide(0)
    if rank == 0:
        os.remove(warm_file)
        win.begin(device)
    _decide(0)                                    # go

    def job(k):
        progress = []

        def seen(n_done):
            size = os.path.getsize(mine) if os.path.exists(mine) else -1
            progress.append((n_done, size))
        out = os.path.join(tmp, f"{PREFIX}-job{k}.bica")
        entry(pool, journal, out, seen)
        return (progress, os.path.exists(mine)), out

    records, files, ends = [], [], []
    while True:
        rec, out = job(len(records))
        records.append(rec)
        files.append(out)
        stop = 0
        if rank == 0:
            ends.append(time.perf_counter())
            stop = int(ends[-1] - win.t0 >= seconds)
        if _decide(stop):
            break
    if rank == 0:
        win.end()
    return records, files, ends


# --- rank 0: the harness's process ----------------------------------------

def _save_pool(pool, path: str) -> list:
    """The pool, each page's rows packed to bits, one after another in one
    file; returns the pages' shapes."""
    with open(path, "wb") as f:
        for p in pool:
            f.write(np.packbits(p, axis=1).tobytes())
    return [list(p.shape) for p in pool]


def _load_pool(path: str, shapes) -> list[np.ndarray]:
    data = np.fromfile(path, dtype=np.uint8)
    pool, pos = [], 0
    for rows, cols in shapes:
        n = rows * -(-cols // 8)
        pool.append(np.unpackbits(data[pos:pos + n].reshape(rows, -1),
                                  axis=1, count=cols).astype(bool))
        pos += n
    return pool


class _Ranks:
    """Ranks 1 .. n-1 as child processes, with a watch on their exit.
    They take rank 0's pool from a file (the harness makes it from the
    seed, which it does not hand the loop), written while they import."""

    def __init__(self, cell, pool, trace, device, world, port, tmp,
                 control):
        spec = os.path.join(tmp, f"{PREFIX}-cell.json")
        self.files = [spec, os.path.join(tmp, f"{PREFIX}-pool.bin")]
        for f in self.files:
            if os.path.exists(f):
                os.remove(f)
        self.tmp, self.done = tmp, False
        self.logs, self.procs = [], []
        env = dict(os.environ)
        if not str(device).startswith("cuda"):
            # the plain kernels' ranks share this host's cores
            env.setdefault("OMP_NUM_THREADS",
                           str(max(1, (os.cpu_count() or 1) // world)))
        for r in range(1, world):
            log = open(os.path.join(tmp, f"{PREFIX}-rank{r}.log"), "w+")
            self.logs.append(log)
            self.procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), spec,
                 str(int(trace)), str(device), str(r), tmp,
                 str(os.getpid())],
                env={**env, **_rank_env(r, world, port)},
                stdout=log, stderr=subprocess.STDOUT, cwd=REPO))
        threading.Thread(target=self._watch, daemon=True).start()
        shapes = _save_pool(pool, self.files[1])
        with open(spec + ".tmp", "w") as f:
            json.dump({"name": cell.name, "config": cell.config,
                       "traffic": cell.traffic, "shapes": shapes,
                       "control": control}, f)
        os.replace(spec + ".tmp", spec)          # the pool is complete

    def tails(self) -> str:
        out = []
        for r, (p, log) in enumerate(zip(self.procs, self.logs), start=1):
            log.flush()
            log.seek(0)
            out.append(f"--- rank {r} rc={p.poll()}\n{log.read()[-3000:]}")
        return "\n".join(out)

    def _watch(self) -> None:
        """A rank that exits with an error while the run needs it ends
        the run: rank 0 might otherwise wait in a collective."""
        while not self.done:
            if any(p.poll() not in (None, 0) for p in self.procs):
                print("a rank failed:\n" + self.tails(), file=sys.stderr,
                      flush=True)
                self.kill()
                os._exit(1)
            time.sleep(0.5)

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    def finish(self, timeout: float = 60.0) -> None:
        deadline = time.monotonic() + timeout
        try:
            for p in self.procs:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
        self.done = True
        bad = [p.poll() for p in self.procs if p.poll() != 0]
        text = self.tails() if bad else ""
        self.kill()
        for log in self.logs:
            log.close()
        if bad:
            raise RuntimeError(f"ranks exited with {bad}:\n{text}")
        for f in self.files + [log.name for log in self.logs]:
            os.remove(f)


def _load_spans(path: str, rank: int):
    """A rank's ``write_jsonl`` file as the recorder's spans and counts,
    the rank in the high bits of each request id."""
    from binary_image_compression_tpu_torch.utils import profiling
    spans, counts = profiling.read_jsonl(path)
    for s in spans:
        s.request |= rank << RANK_SHIFT
    return spans, counts


def run(cell, pool, seconds, device, program, win):
    from binary_image_compression_tpu_torch import native
    from binary_image_compression_tpu_torch.ops import _cuda
    from binary_image_compression_tpu_torch.utils import profiling
    world = cell.config["ranks"]
    tmp = tempfile.gettempdir()
    trace = win.profiler is not None
    from core.control import Control
    control = isinstance(program, Control)
    if control:
        program = ShardedControl(cell.config)
    native.get_lib()                  # built once, before any rank starts
    if str(device).startswith("cuda"):
        _cuda.get_lib()
    port = _free_port()
    saved = {k: os.environ.get(k) for k in _rank_env(0, world, port)}
    ranks = _Ranks(cell, pool, trace, device, world, port, tmp, control)
    os.environ.update(_rank_env(0, world, port))
    try:
        program.join(cell.config, device, WORLD_TIMEOUT)
        records, files, ends = _drive(cell, pool, device, program, tmp, 0,
                                      world, seconds, win)
        _decide(0)                   # every rank has written its results
        dist.destroy_process_group()
        ranks.finish()
    except BaseException:
        ranks.done = True
        ranks.kill()
        raise
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    rank_records, host_route = {0: records}, 0
    for r in range(1, world):
        path = os.path.join(tmp, f"{PREFIX}-rank{r}.json")
        with open(path) as f:
            got = json.load(f)
        os.remove(path)
        rank_records[r] = [([tuple(p) for p in prog], left)
                           for prog, left in got["records"]]
        host_route += got["host_route"]
        spans_file = os.path.join(tmp, f"{PREFIX}-rank{r}.spans")
        if os.path.exists(spans_file):
            spans, counts = _load_spans(spans_file, r)
            os.remove(spans_file)
            profiling.RECORDER.spans.extend(spans)
            profiling.RECORDER.counts.extend(counts)
    lo, hi = _range(len(pool), world, 0)
    bs = cell.config["archive_batch_size"]
    batches0 = [list(range(s, min(s + bs, hi))) for s in range(lo, hi, bs)]
    jobs = len(files)
    return SimpleNamespace(
        t_window=win.t0, seconds=win.t1 - win.t0, jobs=jobs,
        pages=jobs * len(pool), job_batches=batches0,
        batches=jobs * len(batches0),
        pixels=jobs * sum(p.size for p in pool), records=records,
        rank_records=rank_records, files=files, host_route=host_route,
        served=list(range(len(pool))) * jobs,
        steps=np.diff([win.t0] + ends))


def _unlike(a: bytes, b: bytes, n_pages: int) -> int:
    """0 where two archives are the same bytes; else the pages whose
    streams differ (every page where either frame is unreadable), at
    least 1."""
    if a == b:
        return 0
    from reference import archive as ref_archive
    try:
        pa, pb = ref_archive.split(a), ref_archive.split(b)
    except ValueError:
        return n_pages
    return max(1, sum(x != y for x, y in zip(pa, pb))
               + abs(len(pa) - len(pb)))


def compare(cell, w, pool, seed, device, ck, reference) -> None:
    from core import checks
    from core.cell import load
    from reference import archive as ref_archive
    world = cell.config["ranks"]
    n, bs = len(pool), cell.config["archive_batch_size"]
    first, pages0, layout, differ = None, None, 0, 0
    for path in w.files:
        with open(path, "rb") as f:
            blob = f.read()
        os.remove(path)
        bad = checks.archive_layout_errors(blob, n)
        layout += bad
        if first is None:
            first = blob
            pages0 = ref_archive.split(blob) if not bad else [b""] * n
        elif not bad and len(pages0) == n:
            differ += sum(a != b for a, b in zip(ref_archive.split(blob),
                                                 pages0))
    ck.add("archive_frame_faults", layout)
    ck.add("pages_unlike_first_job", differ)
    heads = sum(checks.header_faults(b, pool[i])
                for i, b in enumerate(pages0))
    ck.add("header_faults", heads * w.jobs)
    off = left = 0
    for r, records in w.rank_records.items():
        lo, hi = _range(n, world, r)
        for prog, was_left in records:
            off += checks.journal_errors(prog, pages0[lo:hi],
                                         -(-(hi - lo) // bs))
            left += bool(was_left)
    ck.add("journal_bytes_off", off)
    ck.add("journals_left", left)
    value, limit = ck.items["host_route_pages"]
    ck.add("host_route_pages", value + w.host_route, limit)
    pick = checks.sample(w.served, cell.traffic["check_pages"], seed)
    wrong = sum(reference.stream(pool[i], cell.config, device) != pages0[i]
                for i in pick)
    ck.add("sampled_pages_wrong", wrong * w.jobs)
    one_card = load("programs", cell.config["program"]).archive_entry(
        cell.config, device)(pool, os.path.join(
            tempfile.gettempdir(), f"{PREFIX}-one-card.journal"), None)
    ck.add("archive_unlike_one_card", _unlike(one_card, first, n))
    w.failed = (wrong + heads) * w.jobs + differ
    w.first = dict(enumerate(pages0))
    ck.add("no_page_checked", int(not pick))


# --- ranks 1 .. n-1: this file run as a script ---------------------------

def _die_with_parent(ppid: int) -> None:
    """End this rank when rank 0's process ends: the kernel's parent-death
    signal, and a thread that checks the parent every second."""
    try:
        ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)  # PDEATHSIG
    except (OSError, AttributeError):
        pass

    def watch():
        while os.getppid() == ppid:
            time.sleep(1.0)
        os._exit(1)
    if os.getppid() != ppid:
        os._exit(1)
    threading.Thread(target=watch, daemon=True).start()


def child_main(argv) -> int:
    spec, trace, device, rank, tmp, ppid = argv
    rank = int(rank)
    _die_with_parent(int(ppid))
    sys.path[:0] = [BENCH, REPO]
    from binary_image_compression_tpu_torch.models import compress
    from binary_image_compression_tpu_torch.utils import profiling
    from core.cell import Cell, load
    deadline = time.monotonic() + WORLD_TIMEOUT
    while not os.path.exists(spec) and time.monotonic() < deadline:
        time.sleep(0.02)
    with open(spec) as f:
        d = json.load(f)
    cell = Cell(name=d["name"], chips=d["config"]["ranks"], config=d["config"],
                traffic=d["traffic"])
    world = cell.config["ranks"]
    if int(trace):
        profiling.record(True)
    program = (ShardedControl(cell.config) if d["control"]
               else load("programs", cell.config["program"]))
    pool = _load_pool(spec.replace("-cell.json", "-pool.bin"), d["shapes"])
    host_route0 = compress.host_route["pages"]
    program.join(cell.config, device, WORLD_TIMEOUT)
    records, _, _ = _drive(cell, pool, device, program, tmp, rank, world)
    with open(os.path.join(tmp, f"{PREFIX}-rank{rank}.json"), "w") as f:
        json.dump({"records": records,
                   "host_route": compress.host_route["pages"] - host_route0},
                  f)
    if int(trace):
        profiling.write_jsonl(os.path.join(tmp, f"{PREFIX}-rank{rank}.spans"),
                              *profiling.take())
    _decide(0)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(child_main(sys.argv[1:]))
