"""compress.encode_analyze_decided, ms a batch, ended by a synchronise:
unpack, K1's plane and search, the finish, K2 and the record block."""

COMPRESS = "binary_image_compression_tpu_torch.models.compress"
SPANS = [(COMPRESS, "encode_analyze_decided", "analysis", True)]


def read(ctx):
    return sum(ctx.spans["analysis"]) * 1e3 / ctx.window.batches
