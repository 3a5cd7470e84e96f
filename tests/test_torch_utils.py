"""The port's utils: ``galois`` against JAX's ``GF``, checkpoints that
cross between the packages in both directions, ``PipelineProfile``, and
``pnm.write_pbm_packed`` against JAX's file (the span recorder:
``test_torch_spans.py``)."""

import io
import os

import numpy as np
import pytest
import torch

from binary_image_compression_tpu.ops import bitpack as jbitpack
from binary_image_compression_tpu.utils import checkpoint as jcheckpoint
from binary_image_compression_tpu.utils import galois as jgalois
from binary_image_compression_tpu.utils import pnm as jpnm
from binary_image_compression_tpu_torch.ops import bitpack, predict
from binary_image_compression_tpu_torch.utils import (checkpoint, galois, pnm,
                                                      profiling)


@pytest.mark.parametrize("m", [2, 4, 8, 12])
def test_gf_tables_and_field_axioms_equal_jax(m):
    gf, jgf = galois.GF(m), jgalois.GF(m)
    np.testing.assert_array_equal(gf.exp, jgf.exp)
    np.testing.assert_array_equal(gf.log, jgf.log)
    rng = np.random.RandomState(m)
    q = gf.q
    a, b = rng.randint(1, q, 64), rng.randint(1, q, 64)
    c = rng.randint(0, q, 64)
    np.testing.assert_array_equal(gf.mul(a, gf.inv(a)), np.ones(64, int))
    np.testing.assert_array_equal(gf.mul(a, gf.add(b, c)),
                                  gf.add(gf.mul(a, b), gf.mul(a, c)))
    np.testing.assert_array_equal(gf.mul(gf.mul(a, b), c),
                                  gf.mul(a, gf.mul(b, c)))
    np.testing.assert_array_equal(gf.div(gf.mul(a, b), b), a)
    for n in (0, 1, 5, q - 1, q + 3):
        np.testing.assert_array_equal(gf.pow(c, n), jgf.pow(c, n))
    np.testing.assert_array_equal(gf.mul(a, c), jgf.mul(a, c))
    assert gf.mul(0, q - 1) == 0
    with pytest.raises(ZeroDivisionError):
        gf.inv(0)


def test_gf_polynomials_equal_jax():
    gf, jgf = galois.GF(8), jgalois.GF(8)
    p, q = [1, 2, 3, 0, 9], [5, 7]
    prod = gf.poly_mul(p, q)
    np.testing.assert_array_equal(prod, jgf.poly_mul(p, q))
    quot, rem = gf.poly_divmod(prod, q)
    np.testing.assert_array_equal(quot, gf.poly_trim(p))
    assert rem.sum() == 0
    for a, b in zip(gf.poly_divmod([3, 1, 4, 1, 5], [2, 7, 1]),
                    jgf.poly_divmod([3, 1, 4, 1, 5], [2, 7, 1])):
        np.testing.assert_array_equal(a, b)
    xs = np.arange(1, 10)
    np.testing.assert_array_equal(gf.poly_eval(prod, xs),
                                  jgf.poly_eval(prod, xs))
    np.testing.assert_array_equal(gf.poly_add(p, q), jgf.poly_add(p, q))


def _state(seed):
    rs = np.random.RandomState(seed)
    return rs.rand(6, 16) < 0.5, rs.rand(3, 16) < 0.5, rs.rand(6, 3) < 0.5


@pytest.mark.parametrize("writer,reader", [
    ("jax", "port"), ("port", "jax"), ("port", "port")])
def test_checkpoint_crosses_packages(tmp_path, writer, reader):
    """A BSVD checkpoint written by one package restores in the other to
    equal arrays and metadata (npz plus the .meta.json sidecar)."""
    save = (jcheckpoint if writer == "jax" else checkpoint).save_bsvd
    load = (jcheckpoint if reader == "jax" else checkpoint).restore_bsvd
    E, D, A = _state(3)
    path = str(tmp_path / "ckpt_7")
    save(path, E, D, A, step=7, config={"K": 3, "W": 4})
    assert sorted(os.listdir(tmp_path)) == ["ckpt_7.meta.json",
                                            "ckpt_7.npz"]
    E2, D2, A2, meta = load(path)
    for a, b in ((E, E2), (D, D2), (A, A2)):
        np.testing.assert_array_equal(a, b)
        assert b.dtype == a.dtype
    assert meta == {"step": 7, "config": {"K": 3, "W": 4}, "kind": "bsvd"}
    assert checkpoint.latest_step(str(tmp_path)) == 7
    assert checkpoint.latest_step(str(tmp_path / "none")) is None


def test_checkpoint_arrays_and_meta_cross_packages(tmp_path):
    E, D, _ = _state(4)
    path = str(tmp_path / "ckpt_1")
    checkpoint.save(path, {"E": E, "D": D.astype(np.uint32)},
                    {"note": "port"})
    arrays, meta = jcheckpoint.restore(path)
    np.testing.assert_array_equal(arrays["E"], E)
    assert arrays["D"].dtype == np.uint32
    assert meta == {"note": "port"}
    with pytest.raises(FileNotFoundError):
        checkpoint.restore(str(tmp_path / "absent"))


def test_pipeline_profile_stages():
    prof = profiling.PipelineProfile()
    for _ in range(2):
        with prof.stage("pack", nbytes=1 << 20):
            pass
    with prof.stage("fetch"):
        pass
    assert list(prof.stages) == ["pack", "fetch"]
    st = prof.stages["pack"]
    assert st.calls == 2 and st.bytes_moved == 2 << 20
    assert st.seconds >= 0 and prof.stages["fetch"].mbps == 0.0
    lines = prof.report().splitlines()
    assert len(lines) == 2 and lines[0].startswith("pack") and "x2" in \
        lines[0]
    with pytest.raises(RuntimeError):
        with prof.stage("fails"):
            raise RuntimeError
    assert prof.stages["fails"].calls == 1


@pytest.mark.parametrize("rows,cols", [(1, 1), (101, 237), (7, 64),
                                       (3, 250)])
def test_write_pbm_packed_equals_jax(tmp_path, rows, cols):
    """The same P4 bytes as JAX's writer from numpy uint32 words, from int64
    and int32 torch words, and through a file object; padding bits in the
    words are not written."""
    bits = np.random.RandomState(rows + cols).rand(rows, cols) < 0.3
    words = jbitpack.np_pack(bits)
    jpnm.write_pbm_packed(words, cols, str(tmp_path / "j.pbm"))
    with open(tmp_path / "j.pbm", "rb") as f:
        want = f.read()
    t64 = torch.from_numpy(words.astype(np.int64))
    dirty = words | ~jbitpack.trail_mask(cols)
    for i, w in enumerate([words, t64, bitpack.to_i32(t64), dirty]):
        pnm.write_pbm_packed(w, cols, str(tmp_path / f"{i}.pbm"))
        with open(tmp_path / f"{i}.pbm", "rb") as f:
            assert f.read() == want
    buf = io.BytesIO()
    pnm.write_pbm_packed(t64, cols, buf)
    assert buf.getvalue() == want


def test_canonical_drive_round_trips(tmp_path):
    """The PBM round trip through the port's names: read packed, MED
    forward and inverse on int32 words, write packed, the same file."""
    img = np.random.RandomState(0).rand(101, 237) < 0.15
    orig, rt = str(tmp_path / "orig.pbm"), str(tmp_path / "rt.pbm")
    pnm.write_pbm(img, orig)
    packed, rows, cols = pnm.read_pbm_packed(orig)
    words = bitpack.to_i32(torch.from_numpy(packed.astype(np.int64)))
    back = predict.med_inverse(predict.med_forward(words, cols), cols)
    pnm.write_pbm_packed(back, cols, rt)
    with open(orig, "rb") as f1, open(rt, "rb") as f2:
        assert f1.read() == f2.read()
