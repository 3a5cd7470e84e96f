"""K7 (csrc/rans_encode.cu) against its roofline, %: the least time of its
bytes (reference/roofline.rans_work, a frozen copy: the page's bits and
contexts read once, the table once, the states and the served stream's
words written once, at 3.35 TB/s) over the kernel's device time in the
trace.  K7 is a chain per lane; its chain floor is a yardstick in PERF.md,
not this metric."""

from reference import codec13, roofline

KERNEL = "rans_encode_kernel"


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    dev_s, launches = t.kernel_seconds(KERNEL)
    w = ctx.window
    if not launches or launches != w.pages:
        return None
    cfg = ctx.cell.config
    N = cfg["n_lanes"]
    nbytes = 0
    for i in w.served:
        rows, cols = ctx.pool[i].shape
        S, sr = codec13.stripes(rows, cfg["T"])
        nbytes += roofline.rans_work(rows * cols, -(-(sr * cols) // N), S, N,
                                     codec13.word_bytes(w.first[i]))[0]
    least_s = nbytes / roofline.H100_HBM_BYTES_PER_S
    return 100.0 * least_s / dev_s
