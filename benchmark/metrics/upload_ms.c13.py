"""compress.scab_upload, ms a page: pack the page, copy it to the card and
unpack it there."""

COMPRESS = "binary_image_compression_tpu_torch.models.compress"
SPANS = [(COMPRESS, "scab_upload", "upload", False)]


def read(ctx):
    return sum(ctx.spans["upload"]) * 1e3 / ctx.window.pages
