"""Codec 8 in causal mode over the ranks of one host, as the port's CLI
runs ``archive`` under ``torchrun --nproc-per-node N``: each rank joins
the world (``join``) and archives its page range on its own card into the
one output file (``sharded_entry``, ``multihost.encode_archive_sharded``).
The one-card entries of ``causal_windowed`` come along, for the check
that the sharded archive equals the one-card archive."""

from binary_image_compression_tpu_torch.parallel import multihost
from binary_image_compression_tpu_torch.parallel.multihost import \
    encode_archive_sharded
from programs.causal_windowed import (  # noqa: F401
    archive_entry, page_entry, params)


def join(config: dict, device, timeout: float) -> None:
    """Join the world as a rank that torchrun started (its variables set
    by the caller), bound to its card."""
    multihost.init_distributed(device=device, timeout=timeout)


def sharded_entry(config: dict, device):
    """(pages, journal path, output path, on_progress) -> None, on every
    rank: the BICA archive of `pages` written to the output path."""
    p, bs = params(config), config["archive_batch_size"]

    def run(pages, checkpoint, output, on_progress):
        encode_archive_sharded(pages, p, batch_size=bs, device=device,
                               checkpoint=checkpoint, output=output,
                               on_progress=on_progress)
    return run
