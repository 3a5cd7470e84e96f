"""Share of the traced window in which no operation ran on the card: the
window minus the union of the device operations' intervals.  The spans
around archive.encode_archive and compress.encode_batch only label the
idle gaps that the layers' own spans leave (the breakdown's idle_gaps)."""

COMPRESS = "binary_image_compression_tpu_torch.models.compress"
ARCHIVE = "binary_image_compression_tpu_torch.models.archive"
SPANS = [(ARCHIVE, "encode_archive", "encode_archive", False),
         (COMPRESS, "encode_batch", "encode_batch", False)]


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
