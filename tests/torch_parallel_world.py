"""One rank of the gloo world that tests/test_torch_parallel.py starts: runs
the port's sharded paths on the CPU and, on rank 0, saves what they give.

    python tests/torch_parallel_world.py RANK WORLD PORT OUT_DIR

Imports no JAX; the test holds the results against the JAX package.
"""

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from binary_image_compression_tpu_torch.models import (  # noqa: E402
    archive, bsvd, codec, compress)
from binary_image_compression_tpu_torch.ops import bitpack  # noqa: E402
from binary_image_compression_tpu_torch.parallel import (  # noqa: E402
    bitmerge, halo, mesh as pmesh, multihost, tileshard)
from binary_image_compression_tpu_torch.utils import (  # noqa: E402
    pnm, threefry)

FIX = os.path.join(REPO, "tests", "fixtures")

# (fixture, W, R): 4 shards; W=8 R=120 on text256 needs two hops, the
# ragged page a pad tile row, W=40 takes K4
TILE_CASES = [("text256.pbm", 16, 64), ("text64.pbm", 8, 16),
              ("text256.pbm", 8, 120), ("ragged75x101.pbm", 8, 24),
              ("text256.pbm", 40, 64)]
HALO_PAGES = ["text256.pbm", "ragged75x101.pbm"]
TRAIN = dict(page="text256.pbm", W=8, K=16, seed=3, steps=2)
CORPUS = dict(page="text64.pbm", n=6, W=8, R=16)
# the sharded archive: 2 pages a rank, one batch; ranks 1 and 3 resume
ARCHIVE = dict(page="text64.pbm", n=8, W=8, R=16, batch=2, resume=(1, 3))


def page(name):
    return pnm.read_pbm(os.path.join(FIX, name))


def train_state():
    """(X, E, D, A) int8: text256's 8x8 patches, random-centroid init."""
    X = bsvd.patchify_to_rows(torch.from_numpy(page(TRAIN["page"])),
                              TRAIN["W"])
    D, A = bsvd.initialize_random_centroids(
        threefry.PRNGKey(TRAIN["seed"]), X, TRAIN["K"])
    return X, bsvd.residual(X, D, A), D, A


def corpus_pages():
    img = page(CORPUS["page"])
    return [np.roll(img, (7 * i, 3 * i), axis=(0, 1))
            for i in range(CORPUS["n"])]


def archive_pages():
    img = page(ARCHIVE["page"])
    return [np.roll(img, (5 * i, 11 * i), axis=(0, 1))
            for i in range(ARCHIVE["n"])]


def sharded_archive(rank, world, out_dir, res):
    """The sharded archive twice: from scratch, then with the resuming
    ranks' journals pre-written with their first batch (their encodes
    counted: a resumed batch is not coded again)."""
    pages = archive_pages()
    p = codec.CodecParams(codec=8, W=ARCHIVE["W"], R=ARCHIVE["R"],
                          strict=False)
    bs, journal = ARCHIVE["batch"], os.path.join(out_dir, "journal")
    multihost.encode_archive_sharded(pages, p, batch_size=bs, device="cpu",
                                     checkpoint=journal,
                                     output=os.path.join(out_dir, "a.bica"))
    lo, hi = multihost.page_shard_bounds(len(pages), world, rank)
    if rank in ARCHIVE["resume"]:
        mine = pages[lo:hi]
        first = archive.encode_pages(mine[:bs], p, batch_size=bs,
                                     device="cpu")
        fp = archive._corpus_fingerprint(mine, p, (world, lo, hi))
        archive._journal_append(f"{journal}.rank{rank}", fp,
                                dict(enumerate(first)))
    batches = []
    enc = compress.encode_batch
    compress.encode_batch = lambda b, *a, **k: batches.append(len(b)) or \
        enc(b, *a, **k)
    try:
        multihost.encode_archive_sharded(
            pages, p, batch_size=bs, device="cpu", checkpoint=journal,
            output=os.path.join(out_dir, "resumed.bica"))
    finally:
        compress.encode_batch = enc
    every = [None] * world
    dist.all_gather_object(every, (batches, os.path.exists(
        f"{journal}.rank{rank}")))
    if rank == 0:
        for name in ("a", "resumed"):
            with open(os.path.join(out_dir, f"{name}.bica"), "rb") as f:
                res[f"archive/{name}"] = f.read()
        res["archive/resume_batches"] = [b for b, _ in every]
        res["archive/journals_left"] = [left for _, left in every]


def main(rank, world, port, out_dir):
    multihost.init_distributed(f"127.0.0.1:{port}", world, rank,
                               backend="gloo", device="cpu")
    m4 = pmesh.make_mesh(world, data=world, model=1)
    m22 = pmesh.make_mesh(world, data=2, model=2)
    res = {}

    for name, W, R in TILE_CASES:
        p = codec.CodecParams(codec=8, W=W, R=R, strict=False)
        res[f"tile/{name}/{W}/{R}"] = tileshard.encode_tile_sharded(
            m4, page(name), p, device="cpu")

    for name in HALO_PAGES:
        img = page(name)
        packed = torch.from_numpy(bitpack.np_pack(img).view(np.int32))
        r = halo.med_forward_sharded(m4, packed, img.shape[1])
        res[f"med_forward/{name}"] = r.numpy()
        res[f"med_inverse/{name}"] = halo.med_inverse_sharded(
            m4, r, img.shape[1]).numpy()

    X, E, D, A = train_state()
    _, Es, Ds, As = pmesh.shard_bsvd_state(m22, X, E, D, A)
    step = pmesh.sharded_train_step(m22)
    for _ in range(TRAIN["steps"]):
        Es, Ds, As = step(Es, Ds, As)
    res["train/sharded"] = tuple(
        t.numpy() for t in (m22.all_gather_cat(Es, "data"),
                            m22.all_gather_cat(Ds, "model"),
                            m22.all_gather_cat(As, "data")))

    pages = corpus_pages()
    p = codec.CodecParams(codec=8, W=CORPUS["W"], R=CORPUS["R"],
                          strict=False)
    blobs = multihost.encode_corpus_sharded(pages, params=p, batch_size=2,
                                            device="cpu")
    offs = multihost.corpus_offsets(blobs, len(pages))
    every = [None] * world
    dist.all_gather_object(every, blobs)
    res["corpus/blobs"] = [b for part in every for b in part]
    res["corpus/offsets"] = offs

    nbits = 37 * (rank + 1) + rank * rank
    every = [None] * world
    dist.all_gather_object(every, (nbits, bitmerge.exclusive_offsets(
        m4, "data", nbits)))
    res["exclusive_offsets"] = every

    sharded_archive(rank, world, out_dir, res)

    W, R = 8, 16
    img = page("text64.pbm")
    grid = np.stack([np.roll(img, 5 * i, axis=1) for i in range(world)])
    fn = pmesh.sharded_encode_analyze(m4, W, R, 2, 64, 64, device="cpu")
    mine = compress.analysis_block(fn(torch.from_numpy(grid)))
    res["encode_analyze"] = m4.gather_cat(mine, "data")
    if rank == 0:
        res["encode_analyze"] = res["encode_analyze"].numpy()
        torch.save(res, os.path.join(out_dir, "results.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    torch.set_num_threads(1)
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
