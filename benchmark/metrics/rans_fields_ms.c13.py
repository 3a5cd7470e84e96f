"""compress.scab_rans_page and fetch_rans_fields, ms a page: the context
map, the counts (bincount, with its host sync), the table, K7, the table
pack and the fetch of the payload's fields."""

COMPRESS = "binary_image_compression_tpu_torch.models.compress"
SPANS = [(COMPRESS, "scab_rans_page", "rans_fields", False),
         (COMPRESS, "fetch_rans_fields", "fetch", False)]


def read(ctx):
    s = ctx.spans
    return (sum(s["rans_fields"]) + sum(s["fetch"])) * 1e3 / ctx.window.pages
