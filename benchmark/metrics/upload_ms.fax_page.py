"""compress.encode's own stage 'grid_prep' (PipelineProfile), ms a page:
pad, pack and copy the page to the card."""

COMPRESS = "binary_image_compression_tpu_torch.models.compress"
SPANS = [(COMPRESS, "_upload", "upload", False)]


def read(ctx):
    st = ctx.profile.stages.get("grid_prep")
    return st.seconds * 1e3 / ctx.window.pages if st else None
