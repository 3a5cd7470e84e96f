"""compress._serialize_scab_rans, ms a page: the mode-2 body from the
fetched fields, on the host."""

COMPRESS = "binary_image_compression_tpu_torch.models.compress"
SPANS = [(COMPRESS, "_serialize_scab_rans", "serialize", False)]


def read(ctx):
    return sum(ctx.spans["serialize"]) * 1e3 / ctx.window.pages
