"""The archive's own work, ms a batch: the corpus fingerprint and the
journal appends (each with its fsync) of models/archive.py."""

ARCHIVE = "binary_image_compression_tpu_torch.models.archive"
SPANS = [(ARCHIVE, "_corpus_fingerprint", "fingerprint", False),
         (ARCHIVE, "_journal_append", "journal", False)]


def read(ctx):
    s = ctx.spans
    ms = (sum(s["fingerprint"]) + sum(s["journal"])) * 1e3
    return ms / ctx.window.batches
