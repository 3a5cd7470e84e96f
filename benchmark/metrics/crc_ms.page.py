"""The BIC1 header with the page's CRC (``codec.image_crc``: packbits and
zlib.crc32), ms a page: the program's span ``crc``, on the page's pack
thread for codec 8 and after the serializer for codec 13."""

from core import program_spans


def read(ctx):
    return program_spans.ms_a_page(ctx, "crc")
