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


@pytest.mark.parametrize("argv,item", [
    (["--codec", "13"], "item 7"), (["--codec", "7"], "item 12"),
    (["--codec", "4"], "item 12")])
def test_cli_unported_options_name_the_roadmap_item(tmp_path, argv, item):
    src = os.path.join(FIX, "text64.pbm")
    with pytest.raises(SystemExit, match=item):
        cli.main(["compress", src, str(tmp_path / "a.bic"), *argv,
                  "--device", "cpu"])


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
