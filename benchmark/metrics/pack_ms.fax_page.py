"""compress.encode's own stage 'native_pack' (PipelineProfile), ms a page:
the header, the CRC and native.pack_tiles on one host thread."""

COMPRESS = "binary_image_compression_tpu_torch.models.compress"
SPANS = [(COMPRESS, "pack_pages", "pack", False)]


def read(ctx):
    st = ctx.profile.stages.get("native_pack")
    return st.seconds * 1e3 / ctx.window.pages if st else None
