"""compress.pack_pages, ms a batch: native.pack_tiles of every page of the
batch on host threads."""

COMPRESS = "binary_image_compression_tpu_torch.models.compress"
SPANS = [(COMPRESS, "pack_pages", "pack", False)]


def read(ctx):
    return sum(ctx.spans["pack"]) * 1e3 / ctx.window.batches
