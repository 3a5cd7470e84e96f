"""The port's ``models/bsvd_ref`` (the rand48 replay of bsvd.cpp behind
``bsvd --backend ref`` and codec 11's ``learn_backend="ref"``) and
``utils/rand48`` against the compiled reference's goldens and the JAX
package's functions, on text64 and noise96x80."""

import hashlib
import io
import json
import os

import numpy as np
import pytest

from binary_image_compression_tpu.models import bsvd_ref as jref
from binary_image_compression_tpu.utils.rand48 import Rand48 as JRand48
from binary_image_compression_tpu_torch.models import bsvd_ref
from binary_image_compression_tpu_torch.utils import pnm
from binary_image_compression_tpu_torch.utils.rand48 import Rand48

HERE = os.path.dirname(__file__)
FIX = os.path.join(HERE, "fixtures")
with open(os.path.join(HERE, "goldens", "reference_goldens.json")) as f:
    GOLDENS = json.load(f)

RUNS = [
    ("bsvd_img_mi0_cu0_du0", "text64.pbm",
     dict(W=8, K=16, image_mode=True, mi=0, cu=0, du=0, lm=0)),
    ("bsvd_img_mi1_cu1_du1", "text64.pbm",
     dict(W=8, K=16, image_mode=True, mi=1, cu=1, du=1, lm=0)),
    ("bsvd_img_mi2_cu0_du0", "text64.pbm",
     dict(W=8, K=12, image_mode=True, mi=2, cu=0, du=0, lm=0)),
    ("bsvd_img_mi3_cu0_du1", "text64.pbm",
     dict(W=8, K=12, image_mode=True, mi=3, cu=0, du=1, lm=0)),
    ("bsvd_mat_mi0_cu0_du0", "noise96x80.pbm",
     dict(W=16, K=8, image_mode=False, mi=0, cu=0, du=0, lm=0)),
    ("bsvd_img_alter1", "text64.pbm",
     dict(W=8, K=8, image_mode=True, mi=0, cu=0, du=0, lm=1)),
    ("bsvd_img_alter2", "text64.pbm",
     dict(W=8, K=8, image_mode=True, mi=0, cu=0, du=0, lm=2)),
    ("bsvd_img_seed7", "text64.pbm",
     dict(W=8, K=16, image_mode=True, mi=0, cu=0, du=0, lm=0, seed=7)),
    ("bsvd_img_graphgrow", "text64.pbm",
     dict(W=8, K=8, image_mode=True, mi=4, cu=0, du=0, lm=0)),
    ("bsvd_img_alter3_prox", "text64.pbm",
     dict(W=8, K=8, image_mode=True, mi=0, cu=0, du=1, lm=3)),
]


def _sha(mat):
    buf = io.BytesIO()
    pnm.write_pbm(mat, buf)
    return hashlib.sha256(buf.getvalue()).hexdigest()


@pytest.mark.parametrize("name,image,kw", RUNS, ids=[r[0] for r in RUNS])
def test_run_bsvd_test_equals_goldens_and_jax(name, image, kw):
    img = pnm.read_pbm(os.path.join(FIX, image))
    D, A, E, wE, res_img = bsvd_ref.run_bsvd_test(img, **kw)
    g = GOLDENS[name]
    assert wE == g["final_E_weight"]
    assert _sha(D) == g["dictionary_sha"]
    assert _sha(A) == g["coefficients_sha"]
    assert _sha(res_img if res_img is not None else E) == g["residual_sha"]
    jD, jA, jE, jwE, _ = jref.run_bsvd_test(img, **kw)
    assert wE == jwE
    for a, b in ((D, jD), (A, jA), (E, jE)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("direction,K0", [("forward", 4), ("backward", 8)])
def test_run_mdl_equals_jax(direction, K0):
    img = pnm.read_pbm(os.path.join(FIX, "text64.pbm"))
    kw = dict(W=8, K0=K0, image_mode=True, direction=direction, max_steps=3)
    got, want = bsvd_ref.run_mdl(img, **kw), jref.run_mdl(img, **kw)
    assert got["bestL"] == want["bestL"] > 0
    for k in ("D", "A", "E"):
        np.testing.assert_array_equal(got[k], want[k])


def test_run_mdl_full_search_equals_jax():
    img = pnm.read_pbm(os.path.join(FIX, "text64.pbm"))
    kw = dict(W=8, Kmax=8, Kstep=4, reps=2)
    got = bsvd_ref.run_mdl_full_search(img, **kw)
    want = jref.run_mdl_full_search(img, **kw)
    assert (got["bestK"], got["bestL"]) == (want["bestK"], want["bestL"])
    for k in ("D", "A", "E"):
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("seed", [34503498, 0, 1, 7, 0xFFFFFFFF])
def test_rand48_stream_equals_jax(seed):
    a, b = Rand48(seed), JRand48(seed)
    assert [a.get() for _ in range(64)] == [b.get() for _ in range(64)]
    assert [a.uniform() for _ in range(16)] == [b.uniform()
                                                 for _ in range(16)]
    assert [a.uniform_int(n) for n in (1, 2, 3, 7, 1000, 2 ** 31)] == \
        [b.uniform_int(n) for n in (1, 2, 3, 7, 1000, 2 ** 31)]
    assert [a.bernoulli(0.3) for _ in range(16)] == [b.bernoulli(0.3)
                                                     for _ in range(16)]
