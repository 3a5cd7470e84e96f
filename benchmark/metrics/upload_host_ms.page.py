"""The host's part of the upload, ms a page: the zero pad to the tile grid
and ``bitpack.np_pack`` in ``compress._upload`` (the program's span
``upload.host``)."""

from core import program_spans


def read(ctx):
    return program_spans.ms_a_page(ctx, "upload.host")
