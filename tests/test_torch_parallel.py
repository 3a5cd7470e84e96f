"""The port's ``parallel/`` on the CPU against the JAX package's.

A module fixture starts one 4-rank gloo world (tests/torch_parallel_world.py,
four processes, free local port, its own 180 s limit) that runs every
sharded path of the port once: the tile-sharded encode at 4 shards (two-hop
halo, a pad tile row, K4 at W=40), the halo MED both ways, the BSVD train
step on a (data=2, model=2) grid, the page-sharded corpus, the sharded
archive (from scratch and resumed), the offset scan and the page-sharded
analysis.  Meanwhile the JAX references run here, on
the 8-device CPU mesh of tests/conftest.py.  World-of-1 paths run in this
process on a FileStore under tmp_path, torn down with their test.
"""

import importlib.util
import os
import socket
import subprocess
import sys
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import NamedSharding, PartitionSpec as P

from binary_image_compression_tpu.models import bsvd as jbsvd
from binary_image_compression_tpu.models import codec as jcodec
from binary_image_compression_tpu.ops import bitpack as jbitpack
from binary_image_compression_tpu.parallel import bitmerge as jbitmerge
from binary_image_compression_tpu.parallel import halo as jhalo
from binary_image_compression_tpu.parallel import mesh as jmesh
from binary_image_compression_tpu.parallel import multihost as jmultihost
from binary_image_compression_tpu.parallel import tileshard as jtileshard
from binary_image_compression_tpu_torch import cli
from binary_image_compression_tpu_torch.models import (archive, bsvd, codec,
                                                       compress)
from binary_image_compression_tpu_torch.ops import bitpack
from binary_image_compression_tpu_torch.parallel import (bitmerge, halo,
                                                         mesh, multihost,
                                                         tileshard)
from binary_image_compression_tpu_torch.utils import pnm

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import torch_parallel_world as world_mod  # noqa: E402

WORLD = 4
WORLD_TIMEOUT = 180


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """This file's torch work is small tensors: one intra-op thread keeps
    it from contending for cores with the other test workers and the
    world's ranks."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _World:
    """The 4-rank world, started at once; ``[key]`` waits for it (so the
    JAX references of the first test run while the ranks do) and reads
    rank 0's ``results.pt``."""

    def __init__(self, out):
        self.out, self._res = out, None
        port = _free_port()
        self.logs = [open(out / f"rank{r}.log", "w+") for r in range(WORLD)]
        self.procs = [subprocess.Popen(
            [sys.executable, world_mod.__file__, str(r), str(WORLD),
             str(port), str(out)], stdout=self.logs[r],
            stderr=subprocess.STDOUT) for r in range(WORLD)]
        self.deadline = time.monotonic() + WORLD_TIMEOUT

    def close(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in self.logs:
            f.close()

    def __getitem__(self, key):
        if self._res is None:
            try:
                for p in self.procs:
                    p.wait(timeout=max(1.0,
                                       self.deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pass
            text = []
            for r, (p, f) in enumerate(zip(self.procs, self.logs)):
                f.flush()
                f.seek(0)
                text.append(f"--- rank {r} rc={p.poll()}\n"
                            + f.read()[-3000:])
            if any(p.poll() != 0 for p in self.procs):
                self.close()
                pytest.fail("the 4-rank gloo world failed or timed out "
                            f"({WORLD_TIMEOUT} s):\n" + "\n".join(text))
            self._res = torch.load(self.out / "results.pt",
                                   weights_only=False)
        return self._res[key]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = _World(tmp_path_factory.mktemp("world"))
    try:
        yield w
    finally:
        w.close()


def _jmesh(data, model):
    return jmesh.make_mesh(data * model, data=data, model=model)


def _page(name):
    return pnm.read_pbm(os.path.join(HERE, "fixtures", name))


# --- tile sharding --------------------------------------------------------

@pytest.mark.parametrize("name,W,R", world_mod.TILE_CASES)
def test_tile_sharded_matches_jax(world, name, W, R):
    """4 shards: the port's stream == JAX's tile-sharded stream at 4 shards
    == JAX's host encoder, and decodes to the page."""
    img = _page(name)
    jp = jcodec.CodecParams(codec=8, W=W, R=R, strict=False)
    want = jtileshard.encode_tile_sharded(_jmesh(WORLD, 1), img, jp)
    got = world[f"tile/{name}/{W}/{R}"]
    assert got == want
    assert got == jcodec.encode(img, jp)
    np.testing.assert_array_equal(codec.decode(got), img)


@pytest.fixture
def world_of_one(tmp_path):
    """A 1-rank gloo world in this process on a FileStore, destroyed with
    the test."""
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        yield mesh.make_mesh()
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("codec_id,W,R", [(8, 8, 16), (4, 8, 16),
                                          (7, 16, 24)])
def test_tile_sharded_world_of_one(world_of_one, codec_id, W, R):
    """One shard: the frame is R zero rows over the whole page (row0 = R,
    y_base = -R); codecs 4 and 7 too; == compress.encode and JAX's host
    encoder; the profile has every stage."""
    from binary_image_compression_tpu_torch.utils.profiling import \
        PipelineProfile
    img = _page("ragged75x101.pbm")
    p = codec.CodecParams(codec=codec_id, W=W, R=R, strict=False)
    prof = PipelineProfile()
    got = tileshard.encode_tile_sharded(world_of_one, img, p, device="cpu",
                                        profile=prof)
    assert got == compress.encode(img, p, device="cpu")
    assert got == jcodec.encode(img, jcodec.CodecParams(
        codec=codec_id, W=W, R=R, strict=False))
    assert set(prof.stages) == {"halo", "shard_analysis", "gather",
                                "native_assembly"}


def test_tile_sharded_refusals(world_of_one):
    img = np.zeros((16, 16), dtype=bool)
    for p in (codec.CodecParams(codec=8, W=8, R=16, strict=True),
              codec.CodecParams(codec=6, W=8, R=16, strict=False),
              codec.CodecParams(codec=8, W=16, R=8, strict=False)):
        with pytest.raises(ValueError):
            tileshard.encode_tile_sharded(world_of_one, img, p,
                                          device="cpu")


# rows, cols, W, R, shard base row, shard rows (K1, R not a multiple of W,
# K4 at W=40)
FRAME_CASES = [(128, 128, 16, 64, 64, 32), (128, 128, 16, 100, 0, 48),
               (96, 101, 8, 24, 40, 24), (128, 300, 40, 64, 80, 40)]


@pytest.mark.parametrize("rows,cols,W,R,base,blk", FRAME_CASES)
def test_shard_frame_search_equals_full_page(rows, cols, W, R, base, blk):
    """K1's and K4's plain versions on a shard frame (row0 = R, y_base =
    base - R) select what they select on the whole page for those tiles:
    every field, with the band origin moved from frame to page rows."""
    from binary_image_compression_tpu_torch.ops import fused_search as fs
    from binary_image_compression_tpu_torch.ops import select_windows as sw
    pages = np.random.RandomState(W + base).rand(2, rows, cols) < 0.3
    ny, nx = -(-rows // W), -(-cols // W)
    grid = np.zeros((2, ny * W, nx * W), dtype=bool)
    grid[:, :rows, :cols] = pages
    frame = np.zeros((2, R + blk, nx * W), dtype=bool)
    lo = max(base - R, 0)
    frame[:, R - (base - lo):] = grid[:, lo:base + blk]
    kw = dict(W=W, R=R, T_thresh=2, cols=cols, invert=True)
    search = (fs.fused_search_select if fs.fused_supported(blk // W, nx, W, R)
              else sw.select_windows)
    got, oy, _ = search(torch.from_numpy(frame), blk // W, nx,
                        y_base=base - R, row0=R, **kw)
    want, woy, _ = search(torch.from_numpy(grid), ny, nx, **kw)
    t = slice(base // W * nx, (base + blk) // W * nx)
    want, woy = want[:, t], woy[t]
    same = [0, 2, 3, 4, 5, 6, 7]
    assert torch.equal(got[..., same], want[..., same])
    found = got[..., 3] > 0
    assert torch.equal(torch.where(found, oy + base - R + got[..., 1], 0),
                       torch.where(found, woy + want[..., 1], 0))
    assert int(found.sum()) > 0


# --- halo MED -------------------------------------------------------------

def _jhalo(way, m):
    """JAX's sharded MED under jit (eager shard_map compiles op by op)."""
    return jax.jit(partial(getattr(jhalo, f"{way}_sharded"), m),
                   static_argnums=1)


@pytest.mark.parametrize("name", world_mod.HALO_PAGES)
@pytest.mark.parametrize("way", ["med_forward", "med_inverse"])
def test_halo_matches_jax(world, way, name):
    img = _page(name)
    cols = img.shape[1]
    packed = np.asarray(jbitpack.pack(img))
    m = _jmesh(WORLD, 1)
    res = _jhalo("med_forward", m)(packed, cols)
    want = res if way == "med_forward" else _jhalo("med_inverse", m)(
        res, cols)
    got = world[f"{way}/{name}"].view(np.uint32)
    np.testing.assert_array_equal(got, np.asarray(want))
    if way == "med_inverse":
        np.testing.assert_array_equal(got, packed)


def test_halo_world_of_one(world_of_one):
    img = _page("text64.pbm")
    packed = torch.from_numpy(bitpack.np_pack(img).view(np.int32))
    r = halo.med_forward_sharded(world_of_one, packed, 64)
    np.testing.assert_array_equal(
        r.numpy().view(np.uint32),
        np.asarray(_jhalo("med_forward", _jmesh(1, 1))(
            np.asarray(jbitpack.pack(img)), 64)))
    assert torch.equal(halo.med_inverse_sharded(world_of_one, r, 64), packed)


# --- the sharded BSVD step ------------------------------------------------

def _train_state():
    X, E, D, A = (t.numpy() for t in world_mod.train_state())
    Dj, Aj = jbsvd.initialize_random_centroids(
        jax.random.PRNGKey(world_mod.TRAIN["seed"]), jnp.asarray(X),
        world_mod.TRAIN["K"])
    np.testing.assert_array_equal(D, np.asarray(Dj))   # the threefry replay
    np.testing.assert_array_equal(A, np.asarray(Aj))
    return X, E, D, A


@pytest.mark.parametrize("route", ["sharded", "single"])
def test_train_step_matches_jax(world, route):
    """(data=2, model=2): the sharded step == JAX's sharded step == JAX's
    and the port's single-device learn_train_step."""
    X, E, D, A = _train_state()
    steps = world_mod.TRAIN["steps"]
    if route == "sharded":
        m = _jmesh(2, 2)
        state = jmesh.shard_bsvd_state(m, *(jnp.asarray(x)
                                             for x in (X, E, D, A)))[1:]
        step = jmesh.sharded_train_step(m)
        got = world["train/sharded"]
    else:
        state = tuple(jnp.asarray(x) for x in (E, D, A))
        step = jbsvd.learn_train_step
        got = tuple(torch.from_numpy(x) for x in (E, D, A))
        for _ in range(steps):
            got = bsvd.learn_train_step(*got)
        got = tuple(t.numpy() for t in got)
    for _ in range(steps):
        state = step(*state)
    for g, w in zip(got, state):
        np.testing.assert_array_equal(g, np.asarray(w))
    if route == "sharded":
        for g, w in zip(got, world["train/sharded"]):
            np.testing.assert_array_equal(g, w)


def test_train_step_world_of_one(world_of_one):
    X, E, D, A = (torch.from_numpy(x) for x in _train_state())
    step = mesh.sharded_train_step(world_of_one)
    got = step(*mesh.shard_bsvd_state(world_of_one, X, E, D, A)[1:])
    want = bsvd.learn_train_step(E, D, A)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_init_distributed_and_pod_mesh(monkeypatch):
    """init_distributed: a no-op with nothing set; the BIC_* variables
    start a world (here of 1, gloo); make_pod_mesh's (hosts, data, model)
    grid; the group is destroyed with the test."""
    for k in ("BIC_COORDINATOR", "MASTER_ADDR", "BIC_DIST_BACKEND",
              "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert multihost.init_distributed(device="cpu") is False
    assert not dist.is_initialized()
    assert multihost.default_backend("cpu") == "gloo"
    assert multihost.default_backend("cuda") == "nccl"
    monkeypatch.setenv("BIC_DIST_BACKEND", "gloo")
    assert multihost.default_backend("cuda") == "gloo"
    monkeypatch.setenv("BIC_COORDINATOR", f"127.0.0.1:{_free_port()}")
    monkeypatch.setenv("BIC_NUM_PROCESSES", "1")
    monkeypatch.setenv("BIC_PROCESS_ID", "0")
    assert multihost.init_distributed(device="cpu") is True
    try:
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        pod = multihost.make_pod_mesh()
        assert pod.shape == {"hosts": 1, "data": 1, "model": 1}
        with pytest.raises(ValueError):
            multihost.make_pod_mesh(model=2)
        with pytest.raises(ValueError):
            mesh.make_mesh(1, data=2, model=1)
    finally:
        dist.destroy_process_group()


# --- the sharded archive and the host share -------------------------------

def _bench_reference(name):
    """A plain reference of the benchmark's (``benchmark/reference``),
    loaded from its file: it imports nothing of the port."""
    path = os.path.join(os.path.dirname(HERE), "benchmark", "reference",
                        f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"bench_ref_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _archive_params():
    A = world_mod.ARCHIVE
    return codec.CodecParams(codec=8, W=A["W"], R=A["R"], strict=False)


def test_archive_sharded_equals_one_process(world):
    want = archive.encode_archive(world_mod.archive_pages(),
                                  _archive_params(),
                                  batch_size=world_mod.ARCHIVE["batch"],
                                  device="cpu")
    assert world["archive/a"] == want


def test_archive_sharded_equals_reference(world):
    ref8, ref_archive = _bench_reference("codec8"), _bench_reference("archive")
    A = world_mod.ARCHIVE
    cfg = {"codec": 8, "W": A["W"], "R": A["R"], "T": None}
    want = ref_archive.build([ref8.stream(p, cfg, "cpu")
                              for p in world_mod.archive_pages()])
    assert world["archive/a"] == want


def test_archive_sharded_resumes_rank_by_rank(world):
    """Ranks 1 and 3 found their first (and only) batch in their journals
    and coded nothing; the file is the uninterrupted one; no journal is
    left."""
    A = world_mod.ARCHIVE
    assert world["archive/resumed"] == world["archive/a"]
    assert world["archive/resume_batches"] == [
        [] if r in A["resume"] else [A["batch"]] for r in range(WORLD)]
    assert world["archive/journals_left"] == [False] * WORLD


def test_archive_world_of_one_through_the_cli(world_of_one, tmp_path):
    """``archive`` in a world that is up (here of one) takes the sharded
    path and gives the bytes of the one-device archive; its journal is
    gone, and an older, longer file at the output is cut to the archive."""
    pages = world_mod.archive_pages()[:3]
    names = []
    for i, img in enumerate(pages):
        names.append(str(tmp_path / f"p{i}.pbm"))
        pnm.write_pbm(img, names[-1])
    out = tmp_path / "out.bica"
    out.write_bytes(b"x" * 100_000)
    cli.main(["archive", *names, str(out), "-W", "8", "-R", "16",
              "--device", "cpu", "--batch-size", "2",
              "--checkpoint", str(tmp_path / "journal")])
    want = archive.encode_archive(pages, _archive_params(), batch_size=2,
                                  device="cpu")
    assert out.read_bytes() == want
    assert not any(n.startswith("journal") for n in os.listdir(tmp_path))


def test_archive_sharded_world_of_one_progress(world_of_one, tmp_path):
    """A world of one: on_progress after every batch, the one-device
    archive's bytes, the journal removed once the file is fsynced."""
    pages = world_mod.archive_pages()[:3]
    seen = []
    journal = str(tmp_path / "j")
    out = str(tmp_path / "a.bica")
    multihost.encode_archive_sharded(pages, _archive_params(), batch_size=2,
                                     device="cpu", checkpoint=journal,
                                     output=out, on_progress=seen.append)
    assert seen == [2, 3]
    with open(out, "rb") as f:
        assert f.read() == archive.encode_archive(
            pages, _archive_params(), batch_size=2, device="cpu")
    assert not os.path.exists(journal + ".rank0")


def test_gather_page_bytes_world_of_one(world_of_one):
    assert list(multihost.gather_page_bytes([b"ab", b"cde", b""], 3)) == \
        [2, 3, 0]
    assert list(multihost.corpus_offsets([b"ab", b"cde", b""], 3)) == \
        [0, 2, 5]


def test_encode_journaled_resumes_and_keeps_its_journal(tmp_path):
    """A journal with the first batch under the same fingerprint and
    scope: only the rest is coded, the streams are the uninterrupted
    ones, and the journal stays for the caller to remove."""
    pages = world_mod.archive_pages()[:4]
    p, journal = _archive_params(), str(tmp_path / "j")
    want = archive.encode_pages(pages, p, batch_size=2, device="cpu")
    fp = archive._corpus_fingerprint(pages, p, (4, 0, 4))
    archive._journal_append(journal, fp, {0: want[0], 1: want[1]})
    coded = []
    enc = compress.encode_batch
    compress.encode_batch = lambda b, *a, **k: coded.append(len(b)) or \
        enc(b, *a, **k)
    try:
        got = archive.encode_journaled(pages, p, batch_size=2, device="cpu",
                                       checkpoint=journal, scope=(4, 0, 4))
    finally:
        compress.encode_batch = enc
    assert got == want and coded == [2] and os.path.exists(journal)


def test_fingerprint_scope():
    """The scope keeps a rank's journal from another world's or range's;
    with none the fingerprint is the one-device archive's."""
    pages, p = world_mod.archive_pages()[:2], _archive_params()
    one = archive._corpus_fingerprint(pages, p)
    assert archive._corpus_fingerprint(pages, p, ()) == one
    assert len({one, archive._corpus_fingerprint(pages, p, (4, 0, 2)),
                archive._corpus_fingerprint(pages, p, (2, 0, 2))}) == 3


def test_container_header():
    """The header before the first stream: magic, count, u64 offsets; the
    one-device archive is it and the streams joined."""
    import struct
    assert archive.container_header([0, 7, 19]) == \
        b"BICA" + struct.pack("<IQQQ", 3, 0, 7, 19)
    pages, p = world_mod.archive_pages()[:2], _archive_params()
    blobs = archive.encode_pages(pages, p, batch_size=2, device="cpu")
    assert archive.encode_archive(pages, p, batch_size=2, device="cpu") == \
        archive.container_header([0, len(blobs[0])]) + b"".join(blobs)


def test_spans_jsonl_round_trip(tmp_path):
    """``profiling.write_jsonl`` then ``read_jsonl``: the spans with their
    names, times, threads, requests and parents, the counts with the span
    they were counted within."""
    from binary_image_compression_tpu_torch.utils import profiling
    rec = profiling.Recorder()
    rec.record(True)
    with rec.span("archive_job"):
        with rec.span("archive.shard"):
            rec.count("h2d_bytes", 12)
        rec.count("allgather_bytes", 32)
    spans, counts = rec.take()
    path = str(tmp_path / "s.jsonl")
    profiling.write_jsonl(path, spans, counts)
    got, got_counts = profiling.read_jsonl(path)
    key = lambda s: (s.name, s.start, s.end, s.thread, s.request)
    assert [key(s) for s in got] == [key(s) for s in spans]
    assert [s.parent and s.parent.name for s in got] == ["archive_job", None]
    assert [(n, k, t, w.name) for n, k, t, w in got_counts] == \
        [(n, k, t, w.name) for n, k, t, w in counts]


def test_init_distributed_passes_its_timeout(monkeypatch):
    from datetime import timedelta
    got = {}
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **k: got.update(k))
    assert multihost.init_distributed("127.0.0.1:1", 2, 1, backend="gloo",
                                      device="cpu", timeout=7.5)
    assert got["timeout"] == timedelta(seconds=7.5)
    assert got["world_size"] == 2 and got["rank"] == 1
    got.clear()
    multihost.init_distributed("127.0.0.1:1", 2, 1, backend="gloo",
                               device="cpu")
    assert "timeout" not in got


def test_pack_threads_follow_the_affinity(monkeypatch):
    """``compress._on_threads`` runs on no more threads than the CPUs the
    process may use."""
    import threading
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: {0, 1})
    seen = set()

    def fn(b):
        seen.add(threading.get_ident())
        time.sleep(0.01)
        return b
    assert compress._on_threads(fn, 8) == list(range(8))
    assert 1 <= len(seen) <= 2


# --- page-sharded corpus, offsets, bit streams ----------------------------

def test_corpus_sharded_matches_jax(world):
    pages = world_mod.corpus_pages()
    jp = jcodec.CodecParams(codec=8, W=world_mod.CORPUS["W"],
                            R=world_mod.CORPUS["R"], strict=False)
    want = [jcodec.encode(p, jp) for p in pages]
    assert world["corpus/blobs"] == want
    np.testing.assert_array_equal(
        world["corpus/offsets"],
        jmultihost.merge_host_offsets([len(b) for b in want]))
    for i in range(len(pages) + 3):
        assert multihost.page_shard_bounds(len(pages), 4, i % 4) == \
            jmultihost.page_shard_bounds(len(pages), 4, i % 4)


def test_exclusive_offsets_matches_jax(world):
    nbits, got = zip(*world["exclusive_offsets"])
    m = _jmesh(WORLD, 1)
    nb = jax.device_put(jnp.asarray(nbits, jnp.uint32),
                        NamedSharding(m, P("data")))
    offs_fn = jbitmerge.exclusive_offsets(m, "data", None)
    fn = partial(jax.shard_map, mesh=m, in_specs=P("data"),
                 out_specs=P("data"))(lambda x: offs_fn(x[0])[None])
    np.testing.assert_array_equal(np.asarray(fn(nb)), np.asarray(got))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_bit_streams_matches_jax(seed):
    rng = np.random.RandomState(seed)
    nbits = [int(rng.randint(0, 200)) for _ in range(4)] + [0, 32, 1]
    words = [rng.randint(0, 2 ** 32, size=(b + 31) // 32 + 1,
                         dtype=np.uint64).astype(np.uint32) for b in nbits]
    for w, b in zip(words, nbits):       # bits past each stream are 0
        if b % 32:
            w[b // 32] &= np.uint32((0xFFFFFFFF << (32 - b % 32)) &
                                    0xFFFFFFFF)
        w[(b + 31) // 32:] = 0
    got, total = bitmerge.merge_bit_streams(words, nbits)
    want, wtotal = jbitmerge.merge_bit_streams(words, nbits)
    assert total == wtotal == sum(nbits)
    np.testing.assert_array_equal(got, want)


def test_sharded_encode_analyze_equals_one_device(world):
    img = _page("text64.pbm")
    grid = np.stack([np.roll(img, 5 * i, axis=1) for i in range(WORLD)])
    want = compress.analysis_block(compress.encode_analyze(
        torch.from_numpy(grid), W=8, R=16, T_thresh=2, rows=64, cols=64))
    np.testing.assert_array_equal(world["encode_analyze"], want.numpy())
