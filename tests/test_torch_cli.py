"""The port's CLI on the CPU, and the port's independence from JAX."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest

from binary_image_compression_tpu.models import codec as jcodec
from binary_image_compression_tpu_torch import cli
from binary_image_compression_tpu_torch.utils import pnm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "binary_image_compression_tpu_torch")
FIX = os.path.join(REPO, "tests", "fixtures")


def test_cli_compress_decompress_round_trip(tmp_path, capsys):
    src = os.path.join(FIX, "text64.pbm")
    bic, out = str(tmp_path / "a.bic"), str(tmp_path / "b.pbm")
    cli.main(["compress", src, bic, "-W", "8", "-R", "32", "--device",
              "cpu"])
    assert "B raw ->" in capsys.readouterr().out
    img = pnm.read_pbm(src)
    with open(bic, "rb") as f:
        assert f.read() == jcodec.encode(img, jcodec.CodecParams(
            codec=8, W=8, R=32, strict=False))
    cli.main(["decompress", bic, out])
    with open(src, "rb") as f1, open(out, "rb") as f2:
        assert f1.read() == f2.read()


def test_cli_archive_extract(tmp_path):
    srcs = []
    for i in range(3):
        path = str(tmp_path / f"p{i}.pbm")
        pnm.write_pbm(np.random.RandomState(i).rand(24, 40) < 0.3, path)
        srcs.append(path)
    arc = str(tmp_path / "c.bica")
    cli.main(["archive", *srcs, arc, "-W", "8", "-R", "16", "--device",
              "cpu", "--batch-size", "2"])
    out = str(tmp_path / "x.pbm")
    cli.main(["extract", arc, out, "--page", "2"])
    with open(srcs[2], "rb") as f1, open(out, "rb") as f2:
        assert f1.read() == f2.read()
    with pytest.raises(SystemExit, match="out of range"):
        cli.main(["extract", arc, out, "--page", "3"])


@pytest.mark.parametrize("codec_id", ["10", "11", "13"])
def test_cli_archive_codecs_10_11_13_equal_jax_cli(tmp_path, codec_id):
    """archive --codec 10/11/13 writes the archive JAX's ``cmd_archive``
    builds, byte for byte (codec 11 learns from the same threefry draw),
    and extracts each page; an unknown codec is refused.  JAX's CLI hands
    ``--codec`` to ``CodecParams`` as a string, which its encoder refuses,
    so its ``encode_archive`` is called here with the integer."""
    from binary_image_compression_tpu.models import archive as jarchive
    srcs = [os.path.join(FIX, n) for n in ("text64.pbm",
                                           "ragged75x101.pbm")]
    arc = str(tmp_path / "a.bica")
    cli.main(["archive", *srcs, arc, "--codec", codec_id, "-W", "8",
              "--device", "cpu"])
    want = jarchive.encode_archive(
        [pnm.read_pbm(f) for f in srcs],
        jcodec.CodecParams(codec=int(codec_id), W=8, T=None, R=128,
                           strict=False), use_tpu=True)
    with open(arc, "rb") as f:
        assert f.read() == want
    out = str(tmp_path / "x.pbm")
    cli.main(["extract", arc, out, "--page", "1"])
    with open(srcs[1], "rb") as f1, open(out, "rb") as f2:
        assert f1.read() == f2.read()
    with pytest.raises(SystemExit, match="unknown codec"):
        cli.main(["compress", srcs[0], str(tmp_path / "a.bic"), "--codec",
                  "5", "--device", "cpu"])


def _both(capsys, argv, jargv=None):
    """stdout of the port's CLI and of JAX's for the same arguments."""
    from binary_image_compression_tpu import cli as jcli
    cli.main(argv)
    got = capsys.readouterr().out
    jcli.main(jargv or argv)
    return got, capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    ["--driver", "1", "-W", "8"], ["--driver", "3", "-W", "8", "-T", "4"],
    ["--driver", "4", "-W", "8", "-T", "2", "-R", "32"],
    ["--driver", "8", "-W", "8", "-R", "32"]])
def test_cli_estimate_prints_what_jax_prints(capsys, argv):
    src = os.path.join(FIX, "text64.pbm")
    got, want = _both(capsys, ["estimate", src, *argv])
    assert got == want and got.startswith("{")


def test_cli_compare_and_info_print_what_jax_prints(tmp_path, capsys):
    src = os.path.join(FIX, "noise96x80.pbm")
    got, want = _both(capsys, ["compare", src, "-W", "8", "-R", "32"])
    assert got == want
    assert len(got.splitlines()) == 9 and "[" not in got
    bic, arc = str(tmp_path / "a.bic"), str(tmp_path / "c.bica")
    cli.main(["compress", src, bic, "--codec", "7", "-W", "8", "-R", "16",
              "--mode", "strict", "--device", "cpu"])
    cli.main(["archive", src, src, arc, "--codec", "2", "-W", "8",
              "--device", "cpu"])
    gray = os.path.join(FIX, "gray64.pgm")
    bicg = str(tmp_path / "g.bic")
    cli.main(["compress", gray, bicg, "--device", "cpu"])
    capsys.readouterr()
    for path in (bic, arc, bicg):
        got, want = _both(capsys, ["info", path])
        assert got == want
    assert '"codec": 7, "mode": "strict"' in _both(capsys, ["info", bic])[0]
    with pytest.raises(SystemExit, match="not a BIC"):
        cli.main(["info", src])


@pytest.mark.parametrize("codec_id,argv", [
    ("1", ["-W", "8"]), ("2", ["-W", "8"]), ("3", ["-W", "8", "-T", "4"]),
    ("4", ["-W", "8", "-R", "32"]), ("6", ["-W", "8", "--mode", "strict"]),
    ("7", ["-W", "8", "-R", "32"]), ("12", [])])
def test_cli_host_codecs_equal_jax_cli(tmp_path, codec_id, argv):
    """compress --codec 1/2/3/4/6/7/12 writes the JAX CLI's bytes (both on
    the host) and decompress gives the page back."""
    from binary_image_compression_tpu import cli as jcli
    src = os.path.join(FIX, "text64.pbm")
    bic, jbic = str(tmp_path / "a.bic"), str(tmp_path / "j.bic")
    out = str(tmp_path / "b.pbm")
    cli.main(["compress", src, bic, "--codec", codec_id, *argv, "--device",
              "cpu"])
    jcli.main(["compress", src, jbic, "--codec", codec_id, *argv])
    with open(bic, "rb") as f1, open(jbic, "rb") as f2:
        assert f1.read() == f2.read()
    cli.main(["decompress", bic, out])
    with open(src, "rb") as f1, open(out, "rb") as f2:
        assert f1.read() == f2.read()


def test_cli_compress_profile_prints_the_stages(tmp_path, capsys):
    src = os.path.join(FIX, "text64.pbm")
    cli.main(["compress", src, str(tmp_path / "a.bic"), "-W", "8", "-R",
              "32", "--profile", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[0] for ln in lines[:3]] == [
        "grid_prep", "device_analysis", "native_pack"]
    assert all("MB/s" in ln and ln.endswith("x1") for ln in lines[:3])
    assert "B raw ->" in lines[3]


@pytest.mark.parametrize("flags", [
    ["-w", "8", "-k", "16", "-I", "1"],
    ["-w", "8", "-k", "8", "-I", "1", "-i", "1", "-c", "1", "-d", "1"],
    ["-w", "8", "-k", "16", "-I", "1", "-l", "4"]])
def test_cli_bsvd_reference_backend_equals_jax_cli(tmp_path, capsys, flags):
    """bsvd --backend ref is JAX's default backend: the same PBMs and the
    same |E| line."""
    from binary_image_compression_tpu import cli as jcli
    src = os.path.join(FIX, "text64.pbm")
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    cli.main(["bsvd", src, *flags, "--backend", "ref", "--out-dir",
              str(tmp_path / "port")])
    got = capsys.readouterr().out
    jcli.main(["bsvd", src, *flags, "--backend", "ref", "--out-dir",
               str(tmp_path / "jax")])
    assert got == capsys.readouterr().out
    for f in sorted(os.listdir(tmp_path / "jax")):
        with open(tmp_path / "port" / f, "rb") as f1, \
                open(tmp_path / "jax" / f, "rb") as f2:
            assert f1.read() == f2.read(), f


@pytest.mark.parametrize("argv", [["--codec", "13"],
                                  ["--codec", "13", "--entropy", "device"],
                                  ["--codec", "13", "-W", "10", "-T", "2"]])
def test_cli_codec13_round_trip(tmp_path, capsys, argv):
    """compress --codec 13 (host or device entropy) writes the JAX
    package's stream; decompress gives the page back."""
    from binary_image_compression_tpu.models import compress as jcompress
    src = os.path.join(FIX, "text64.pbm")
    bic, out = str(tmp_path / "a.bic"), str(tmp_path / "b.pbm")
    cli.main(["compress", src, bic, *argv, "--device", "cpu"])
    assert "codec 13" in capsys.readouterr().out
    img = pnm.read_pbm(src)
    W = int(argv[argv.index("-W") + 1]) if "-W" in argv else 16
    T = int(argv[argv.index("-T") + 1]) if "-T" in argv else None
    jp = jcodec.CodecParams(codec=13, W=W, T=T, R=128, strict=False)
    want = (jcompress.encode_scab(img, jp, entropy="device")
            if "device" in argv else jcodec.encode(img, jp))
    with open(bic, "rb") as f:
        assert f.read() == want
    cli.main(["decompress", bic, out])
    with open(src, "rb") as f1, open(out, "rb") as f2:
        assert f1.read() == f2.read()


@pytest.mark.parametrize("name,mode,extra", [
    pytest.param("text64.pbm", "causal", [], id="text64.pbm-causal"),
    pytest.param("noise96x80.pbm", "causal", [], id="noise96x80.pbm-causal"),
    pytest.param("text64.pbm", "strict", [], id="text64.pbm-strict"),
    pytest.param("text64.pbm", "causal", ["--shard", "tiles"],
                 id="text64.pbm-causal-shard-tiles")])
def test_cli_codec_auto_keeps_the_smaller(tmp_path, capsys, name, mode,
                                          extra):
    """--codec auto: the smaller of JAX's codec-13 and codec-8 streams;
    with --shard tiles too, which auto ignores, as JAX's CLI does."""
    src = os.path.join(FIX, name)
    bic = str(tmp_path / "a.bic")
    cli.main(["compress", src, bic, "--codec", "auto", "-W", "8", "-R", "32",
              "--mode", mode, "--device", "cpu"] + extra)
    img = pnm.read_pbm(src)
    want = min((jcodec.encode(img, jcodec.CodecParams(codec=13, W=0, T=0,
                                                      R=0)),
                jcodec.encode(img, jcodec.CodecParams(
                    codec=8, W=8, R=32, strict=mode == "strict"))), key=len)
    with open(bic, "rb") as f:
        blob = f.read()
    assert blob == want
    assert f"codec {want[8]}" in capsys.readouterr().out
    np.testing.assert_array_equal(jcodec.decode(blob), img)


def _small_ppm(path):
    rs = np.random.RandomState(11)
    ch = [(np.abs(np.cumsum(rs.randn(24, 40), axis=1)) * 9).astype(
        np.uint32) % 256 for _ in range(3)]
    pnm.write_ppm((ch[0] << 16) | (ch[1] << 8) | ch[2], 255, path)
    return path


@pytest.mark.parametrize("argv", [[], ["--codec", "10"],
                                  ["--entropy", "device"]])
@pytest.mark.parametrize("kind", ["pgm", "ppm"])
def test_cli_gray_and_color_equal_jax_cli(tmp_path, argv, kind):
    """compress of gray64.pgm and a small PPM writes the JAX CLI's bytes
    for the same flags (bare: per-plane best of codecs 13 and 10; --codec
    10; --entropy device: codec 13 mode 2); decompress writes the file
    back."""
    from binary_image_compression_tpu import cli as jcli
    src = (os.path.join(FIX, "gray64.pgm") if kind == "pgm"
           else _small_ppm(str(tmp_path / "c.ppm")))
    bic, jbic = str(tmp_path / "a.bic"), str(tmp_path / "j.bic")
    out = str(tmp_path / f"b.{kind}")
    cli.main(["compress", src, bic, *argv, "--device", "cpu"])
    jcli.main(["compress", src, jbic, *argv])
    with open(bic, "rb") as f1, open(jbic, "rb") as f2:
        blob = f1.read()
        assert blob == f2.read()
    assert blob[:4] == (b"BICG" if kind == "pgm" else b"BICC")
    cli.main(["decompress", bic, out])
    with open(src, "rb") as f1, open(out, "rb") as f2:
        assert f1.read() == f2.read()


def test_cli_codec10_pbm_round_trip(tmp_path):
    src = os.path.join(FIX, "text64.pbm")
    bic, out = str(tmp_path / "a.bic"), str(tmp_path / "b.pbm")
    cli.main(["compress", src, bic, "--codec", "10", "--device", "cpu"])
    img = pnm.read_pbm(src)
    with open(bic, "rb") as f:
        assert f.read() == jcodec.encode(img, jcodec.CodecParams(codec=10,
                                                                 W=0))
    cli.main(["decompress", bic, out])
    with open(src, "rb") as f1, open(out, "rb") as f2:
        assert f1.read() == f2.read()


def test_cli_bitplanes_planes2pgm_round_trip(tmp_path, capsys):
    """bitplanes writes the JAX CLI's PBMs; planes2pgm puts them back
    together, maxval the final mask as in plane2pgm_tool."""
    from binary_image_compression_tpu import cli as jcli
    src = os.path.join(FIX, "gray64.pgm")
    pre, jpre = str(tmp_path / "p_"), str(tmp_path / "j_")
    cli.main(["bitplanes", src, "--prefix", pre])
    jcli.main(["bitplanes", src, "--prefix", jpre])
    assert "wrote 8 planes" in capsys.readouterr().out
    for i in range(8):
        with open(f"{pre}{i:02d}.pbm", "rb") as f1, \
                open(f"{jpre}{i:02d}.pbm", "rb") as f2:
            assert f1.read() == f2.read()
    out = str(tmp_path / "back.pgm")
    cli.main(["planes2pgm", pre, out])
    gray, maxval = pnm.read_pnm(src)
    back, m = pnm.read_pnm(out)
    np.testing.assert_array_equal(back, gray)
    assert m == 255
    with pytest.raises(SystemExit, match="no "):
        cli.main(["planes2pgm", str(tmp_path / "none_"), out])


def _port_modules():
    mods = []
    for root, _, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py") and f != "__main__.py":
                rel = os.path.relpath(os.path.join(root, f), REPO)[:-3]
                mods.append(rel.replace(os.sep, ".").removesuffix(
                    ".__init__"))
    return mods


def test_port_imports_no_jax():
    """Importing every port module leaves jax (and the JAX package) out of
    sys.modules, and no port source imports either."""
    mods = _port_modules()
    assert len(mods) >= 15
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'binary_image_compression_tpu' "
            "or m.startswith('binary_image_compression_tpu.')]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, (r.stdout, r.stderr)
    for root, _, files in os.walk(PKG):
        for f in files:
            if not f.endswith(".py"):
                continue
            with open(os.path.join(root, f)) as fh:
                tree = ast.parse(fh.read())
            for node in ast.walk(tree):
                names = ([a.name for a in node.names]
                         if isinstance(node, ast.Import) else
                         [node.module or ""]
                         if isinstance(node, ast.ImportFrom) and
                         node.level == 0 else [])
                for n in names:
                    top = n.split(".")[0]
                    assert top not in ("jax", "jaxlib",
                                       "binary_image_compression_tpu"), \
                        (f, n)


@pytest.mark.parametrize("codec_id,argv", [("8", ["-W", "8", "-R", "16"]),
                                           ("4", ["-W", "16", "-R", "32"])])
def test_cli_shard_tiles_world_of_one(tmp_path, capsys, codec_id, argv):
    """compress --shard tiles alone is a world of 1 (gloo for --device cpu):
    the same bytes as compress without it, and no process group left."""
    import torch.distributed as dist
    src = os.path.join(FIX, "ragged75x101.pbm")
    a, b = str(tmp_path / "a.bic"), str(tmp_path / "b.bic")
    cli.main(["compress", src, a, "--codec", codec_id, *argv, "--device",
              "cpu", "--shard", "tiles", "--profile"])
    out = capsys.readouterr().out
    assert "1 tile shards" in out and "native_assembly" in out
    assert not dist.is_initialized()
    cli.main(["compress", src, b, "--codec", codec_id, *argv, "--device",
              "cpu"])
    with open(a, "rb") as f1, open(b, "rb") as f2:
        assert f1.read() == f2.read()
    with pytest.raises(SystemExit, match="causal"):
        cli.main(["compress", src, a, "--mode", "strict", "--shard", "tiles",
                  "--device", "cpu"])
    with pytest.raises(SystemExit, match="causal"):
        cli.main(["compress", src, a, "--codec", "12", "--shard", "tiles",
                  "--device", "cpu"])
