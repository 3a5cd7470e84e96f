"""Multi-device encode and learning on ``torch.distributed``.

Counterpart of ``binary_image_compression_tpu/parallel/`` (all but
``scaling.py``): ``mesh`` (rank grids, the sharded BSVD step, page-sharded
analysis), ``halo`` (the row-sharded MED), ``tileshard`` (one page's tile
rows over the ranks, through K1 or K4 on shard frames), ``bitmerge``
(offsets and bit-stream merging) and ``multihost`` (process start-up and the
page-sharded corpus).  One rank per process and per device; the collectives
run on the backend the caller names (NCCL on the rank's GPU, or gloo on
host tensors).
"""
