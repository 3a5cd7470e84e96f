"""Share of the codec-8 record pack that is the native packer, %: the
program's ``pack.native`` spans (``native.pack_tiles``) over its
``pack.page`` spans (the header and CRC, the split and ``np_unpack``, and
the native pack of one page on its thread), in thread time."""

from core import program_spans


def read(ctx):
    return program_spans.share_pct(ctx, "pack.native", "pack.page")
