"""compress._upload, ms a batch: pad to the tile grid, pack to words on the
host and copy to the card."""

COMPRESS = "binary_image_compression_tpu_torch.models.compress"
SPANS = [(COMPRESS, "_upload", "upload", False)]


def read(ctx):
    return sum(ctx.spans["upload"]) * 1e3 / ctx.window.batches
