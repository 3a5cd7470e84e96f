"""The upload's copy to the card, GB/s: the bytes of the packed words (the
program's counter ``h2d_bytes``) over the time of its ``upload.h2d``
spans, which hold the copy from pageable host memory."""

from core import program_spans


def read(ctx):
    return program_spans.h2d_gb_s(ctx)
