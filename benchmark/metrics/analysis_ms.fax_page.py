"""compress.encode's own stage 'device_analysis' (PipelineProfile), ms a
page: unpack, K1, the finish, K2, the record block and its fetch."""

COMPRESS = "binary_image_compression_tpu_torch.models.compress"
SPANS = [(COMPRESS, "encode_analyze_decided", "analysis", False)]


def read(ctx):
    st = ctx.profile.stages.get("device_analysis")
    return st.seconds * 1e3 / ctx.window.pages if st else None
