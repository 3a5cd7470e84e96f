"""Dictionary-atom mosaic rendering (reference render_mosaic, util.cpp:53-82).

Counterpart of ``binary_image_compression_tpu/utils/mosaic.py``: tiles the
K rows of a packed dictionary (each a vectorized sqrt(M) x sqrt(M) patch)
into one binary image with 1-px gutters, as bsvd_test.cpp:123-151 writes
atoms_mosaic.pbm and residual_mosaic.pbm.
"""

from __future__ import annotations

import math

import numpy as np

from ..ops import bitpack


def render_mosaic(dict_packed: np.ndarray, M: int) -> np.ndarray:
    """packed [K, nwords(M)] -> bool mosaic image, layout as util.cpp:53-82."""
    rows_bits = bitpack.np_unpack(np.asarray(dict_packed), M)
    n = rows_bits.shape[0]
    w = int(math.isqrt(M))
    gn = int(math.ceil(math.sqrt(n)))
    gm = int(math.ceil(n / gn))
    gw = w + 1
    img = np.zeros((gm * gw, gn * gw), dtype=bool)
    li = 0
    for i in range(gm):
        for j in range(gn):
            if li >= n:
                break
            img[gw * i: gw * i + w, gw * j: gw * j + w] = \
                rows_bits[li].reshape(w, w)
            li += 1
        if li >= n:
            break
    return img
