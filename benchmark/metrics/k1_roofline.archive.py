"""K1's search kernel against its roofline, %: the least time the card
could take for the work these pages need, over the kernel's device time
in the trace.

Work (reference/roofline, a frozen copy): per page, the candidate windows
that the serial scan reads before it stops (the reference's search counts
them: up to the first window within T, else all), 8 popcounts each at
W = 16; bytes, the field plane in and the selection out once.  A launch's
least time is the larger of the popcount time and the byte time."""

from reference import codec8, roofline

KERNEL = "fused_search_kernel"


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    dev_s, launches = t.kernel_seconds(KERNEL)
    cfg, w, pool = ctx.cell.config, ctx.window, ctx.pool
    W, R = cfg["W"], cfg["R"]
    if not launches or launches != w.batches:
        return None
    least_ms = 0.0
    for batch in w.job_batches:
        rows, cols = pool[batch[0]].shape
        gh, gw = -(-rows // W) * W, -(-cols // W) * W
        He = roofline.k1_plane_height(gh, W, R)
        T = (gh // W) * (gw // W)
        pops = sum(codec8.scanned(pool[i], codec=cfg["codec"], W=W,
                                  T=cfg["T"], R=R, device=ctx.device)
                   for i in batch) * roofline.window_popcounts(W)
        least_ms += roofline.bound_ms(
            popcounts=pops, nbytes=roofline.k1_bytes(len(batch), He, gw, T))[0]
    return 100.0 * least_ms * w.jobs / (dev_s * 1e3)
