"""Rank grids over ``torch.distributed``, and the sharded training and
page-batch analysis steps.

Counterpart of ``binary_image_compression_tpu/parallel/mesh.py``:
``make_mesh`` (:28), ``shard_bsvd_state`` (:43), ``sharded_train_step``
(:53) and ``sharded_encode_analyze`` (:75).  JAX lays devices out in a
``jax.sharding.Mesh`` and lets GSPMD insert the collectives; here a
``Mesh`` lays the world's ranks (one process and one device each) out in a
named grid, holds one process group per axis line, and the steps call the
collectives themselves:

* **data parallelism**: rows of X, E and A (BSVD samples) and pages on the
  ``data`` axis.  The pursuit is per row, so it needs no collective; each
  atom's majority vote is one all-reduce over ``data``.
* **model parallelism**: atoms stored sharded on ``model`` and
  all-gathered for the step.  The dictionary is at most K x M int8, so
  every rank of a data line computes the same update and the results equal
  one device's.
* **spatial parallelism**: one page's tile rows on ``data``, with a halo
  from the ranks above (``halo``, ``tileshard``).

Collectives run on the group's device: the rank's GPU under NCCL, host
tensors under gloo; the compute runs on the caller's device, and tensors
move between the two where they differ.  The backend is the caller's
choice (``multihost.init_distributed``), never a fallback.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist


class Mesh:
    """A named grid of the world's ranks.

    ranks: int array whose shape gives the axis sizes and whose entries are
    global ranks.  Every rank of the world must build the same Mesh at the
    same point of its program (``new_group`` is collective)."""

    def __init__(self, ranks: np.ndarray, axis_names):
        self.ranks = np.asarray(ranks, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        if self.ranks.ndim != len(self.axis_names):
            raise ValueError("one axis name per grid dimension")
        if sorted(self.ranks.ravel().tolist()) != list(
                range(dist.get_world_size())):
            raise ValueError(f"a mesh of {self.ranks.size} ranks in a world "
                             f"of {dist.get_world_size()}")
        self.shape = dict(zip(self.axis_names, self.ranks.shape))
        me = dist.get_rank()
        self.coords = {a: int(c[0]) for a, c in
                       zip(self.axis_names, np.nonzero(self.ranks == me))}
        self._lines = {}
        for i, axis in enumerate(self.axis_names):
            lines = np.moveaxis(self.ranks, i, -1).reshape(
                -1, self.ranks.shape[i])
            for line in lines.tolist():
                group = dist.new_group(line)     # collective: every line
                if me in line:
                    self._lines[axis] = (group, line)

    def axis_index(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, axis: str):
        return self._lines[axis][0]

    def axis_ranks(self, axis: str) -> list[int]:
        """Global ranks of this rank's line along `axis`, in axis order."""
        return self._lines[axis][1]

    @property
    def comm_device(self) -> torch.device:
        """Where collectives take their tensors: the rank's GPU under
        NCCL, the host under gloo."""
        if dist.get_backend() == "nccl":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cpu")

    def all_reduce_sum(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """Sum `t` over the line along `axis`, in place."""
        if self.shape[axis] > 1:
            c = t.to(self.comm_device)
            dist.all_reduce(c, group=self.group(axis))
            if c is not t:
                t.copy_(c)
        return t

    def all_gather_cat(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """Every rank's `t` (same shape on each) along `axis`, concatenated
        on dim 0 in axis order, on `t`'s device."""
        if self.shape[axis] == 1:
            return t
        c = t.contiguous().to(self.comm_device)
        parts = [torch.empty_like(c) for _ in range(self.shape[axis])]
        dist.all_gather(parts, c, group=self.group(axis))
        return torch.cat(parts).to(t.device)

    def gather_cat(self, t: torch.Tensor, axis: str):
        """Every rank's `t` along `axis`, concatenated on dim 0 on the
        line's first rank (on `t`'s device); None on the others."""
        if self.shape[axis] == 1:
            return t
        c = t.contiguous().to(self.comm_device)
        line = self.axis_ranks(axis)
        first = self.coords[axis] == 0
        parts = [torch.empty_like(c) for _ in line] if first else None
        dist.gather(c, parts, dst=line[0], group=self.group(axis))
        return torch.cat(parts).to(t.device) if first else None

    def permute(self, sends, recvs, axis: str) -> list[torch.Tensor]:
        """One batch of point-to-point transfers along `axis` (JAX's
        ``ppermute``): sends [(tensor, to_index)], recvs [(shape, dtype,
        from_index)], indices along the axis.  Returns the received
        tensors on the comm device, in the order of `recvs`."""
        line, dev = self.axis_ranks(axis), self.comm_device
        got = [torch.empty(shape, dtype=dtype, device=dev)
               for shape, dtype, _ in recvs]
        ops = [dist.P2POp(dist.isend, t.contiguous().to(dev), line[j])
               for t, j in sends]
        ops += [dist.P2POp(dist.irecv, buf, line[j])
                for buf, (_, _, j) in zip(got, recvs)]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return got


def make_mesh(n_devices: int | None = None, data: int | None = None,
              model: int | None = None) -> Mesh:
    """2-D (data, model) grid of the world's ranks, rank = d * model + m;
    by default all on data with model=1, unless n is even and >= 4 (then
    model=2), as JAX splits."""
    n = n_devices or dist.get_world_size()
    if data is None or model is None:
        model = 2 if n % 2 == 0 and n >= 4 else 1
        data = n // model
    if data * model != n:
        raise ValueError(f"data={data} x model={model} is not {n} ranks")
    return Mesh(np.arange(n).reshape(data, model), ("data", "model"))


def _rows(n: int, parts: int, i: int) -> slice:
    if n % parts:
        raise ValueError(f"{n} rows do not split evenly over {parts} ranks")
    k = n // parts
    return slice(i * k, (i + 1) * k)


def shard_bsvd_state(mesh: Mesh, X, E, D, A):
    """This rank's shards of a BSVD state: rows of X, E and A on data,
    atoms of D on model (JAX's shardings, A's columns left whole)."""
    r = _rows(X.shape[0], mesh.shape["data"], mesh.axis_index("data"))
    k = _rows(D.shape[0], mesh.shape["model"], mesh.axis_index("model"))
    return X[r], E[r], D[k], A[r]


def sharded_train_step(mesh: Mesh):
    """The BSVD alternation step (``bsvd.learn_train_step``) on sharded
    state: step(E, D, A) takes and returns this rank's shards
    (``shard_bsvd_state``).  The atoms are all-gathered over model; the
    pursuit runs on the rank's rows; each atom's vote is all-reduced over
    data, so every rank takes one device's dictionary."""
    from ..models import bsvd

    def step(E, D, A):
        Dfull = mesh.all_gather_cat(D, "model")
        E, Dfull, A = bsvd.learn_train_step(
            E, Dfull, A, allreduce=lambda t: mesh.all_reduce_sum(t, "data"))
        k = _rows(Dfull.shape[0], mesh.shape["model"],
                  mesh.axis_index("model"))
        return E, Dfull[k].contiguous(), A

    return step


def sharded_encode_analyze(mesh: Mesh, W: int, R: int, T_thresh: int,
                           rows: int, cols: int, *, device="cuda"):
    """Tile-codec analysis with the pages sharded on data: fn(batch) takes
    the 0/1 [B, ny*W, nx*W] page batch (B divisible by the data axis),
    runs ``compress.encode_analyze`` on this rank's contiguous pages on
    `device` and returns their dict.  No collective, as JAX's shard_map
    compiles none; each rank keeps its own pages' analysis."""
    from ..models import compress
    from ..ops._cuda import resolve_device
    dev = resolve_device(device)

    def fn(batch):
        r = _rows(batch.shape[0], mesh.shape["data"],
                  mesh.axis_index("data"))
        return compress.encode_analyze(
            torch.as_tensor(batch[r]).to(dev), W=W, R=R, T_thresh=T_thresh,
            rows=rows, cols=cols)

    return fn
