"""Codec 13's context counts, ms a page: the program's span
``rans.counts`` over ``ransdevice.count_contexts``, whose ``bincount``
makes the host wait for the device's work queued before it (the upload's
unpack and the context map) and then for the histogram itself."""

from core import program_spans


def read(ctx):
    return program_spans.ms_a_page(ctx, "rans.counts")
