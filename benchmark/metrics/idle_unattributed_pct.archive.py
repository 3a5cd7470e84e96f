"""Share of the card's idle time that no layer of the program claims, %:
of the traced window's gaps between device operations, the time during
which the innermost program span open on the host is a request root
(``page``, ``archive_job``) or no program span is open at all.  It
measures how much of the idle time the program's spans explain."""

from core import program_spans


def read(ctx):
    return program_spans.idle_unattributed_pct(ctx)
