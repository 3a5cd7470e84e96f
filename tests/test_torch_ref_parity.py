"""The port's ``models/ref_parity`` (the reference drivers' codelength
simulators behind ``estimate``) against the compiled reference's goldens
and against the JAX package's functions on the same pages: text64,
noise96x80 and sparse128, no run on doc512 or text256."""

import json
import os

import pytest

from binary_image_compression_tpu.models import ref_parity as jrp
from binary_image_compression_tpu_torch.models import ref_parity as rp
from binary_image_compression_tpu_torch.utils import pnm

HERE = os.path.dirname(__file__)
FIX = os.path.join(HERE, "fixtures")
with open(os.path.join(HERE, "goldens", "reference_goldens.json")) as f:
    GOLDENS = json.load(f)

# (golden name or None, driver, page, kwargs)
RUNS = [
    ("c1_text64_w5", 1, "text64.pbm", dict(W=5)),
    ("c1_text64_w8", 1, "text64.pbm", dict(W=8)),
    ("c2_text64_w8", 2, "text64.pbm", dict(W=8)),
    ("c2_sparse_w16", 2, "sparse128.pbm", dict(W=16)),
    ("c3_text64_w8_t4", 3, "text64.pbm", dict(W=8, T=4)),
    ("c3_noise_w16_t64", 3, "noise96x80.pbm", dict(W=16, T=64)),
    ("c4_noise_w8", 4, "noise96x80.pbm", dict(W=8, T=2, R=32)),
    ("c4_text64_w16_t8", 4, "text64.pbm", dict(W=16, T=8, R=64)),
    (None, 5, "text64.pbm", dict(W=8, T=0, R=32)),
    (None, 6, "noise96x80.pbm", dict(W=8, T=0, R=32)),
    ("c7_text64_w8", 7, "text64.pbm", dict(W=8, T=1, R=32)),
    ("c7_sparse_w16", 7, "sparse128.pbm", dict(W=16, T=2, R=64)),
    ("c8_text64_w8", 8, "text64.pbm", dict(W=8, T=2, R=32)),
    ("c8_text64_w4", 8, "text64.pbm", dict(W=4, T=1, R=16)),
    ("c8_sparse_w16", 8, "sparse128.pbm", dict(W=16)),
]


def _fn(mod, driver):
    return getattr(mod, f"compress{driver}")


@pytest.mark.parametrize("name,driver,image,kw", RUNS,
                         ids=[r[0] or f"c{r[1]}_{r[2][:-4]}" for r in RUNS])
def test_ref_parity_equals_goldens_and_jax(name, driver, image, kw):
    img = pnm.read_pbm(os.path.join(FIX, image))
    got = _fn(rp, driver)(img, **kw)
    # the whole report, tiles, map and histograms included, equals JAX's
    want = _fn(jrp, driver)(img, **kw)
    assert json.dumps(got, default=str, sort_keys=True) == \
        json.dumps(want, default=str, sort_keys=True)
    if name is None:
        return
    gold = GOLDENS[name]
    assert got["tiles"] == gold["tiles"]
    gf, wf = got["final"], gold["final"]
    for k in ("matches", "avg_weight", "avg_golomb_match",
              "avg_golomb_nomatch", "raw_bytes"):
        if k in wf:
            assert gf.get(k) == wf[k], f"final.{k}"
    for k in ("comp_bytes", "ratio", "comp_bits"):
        if k in wf:
            a, b = float(gf.get(k)), float(wf[k])
            # the reference prints 6 significant digits
            assert abs(a - b) <= max(1e-4 * abs(b), 5e-3), f"final.{k}"
    if "map" in wf:
        assert gf["map"] == wf["map"]


@pytest.mark.parametrize("x", [0.0, 0.5, 1.0, 3.0, 1e-9])
def test_helpers_equal_jax(x):
    assert rp.ceil_log2(x) == jrp.ceil_log2(x)
    assert rp.c_ulong(x) == jrp.c_ulong(x)
