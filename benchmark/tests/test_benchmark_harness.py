"""The harness on the CPU at sizes a test holds (the program's plain
versions stand in for its kernels): cells found from their names alone,
pages made from the seed, the result line's keys, the trace readers, no
JAX loaded, and ``correct`` false for the control and for each fault the
cells can have."""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

from core import control, harness, pages, tracing
from core.cell import (BENCH_DIR, REPO, find_cell, load, load_reader,
                       load_spec)

SPEC = load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]
TINY = {"archive": dict(rows=48, cols=80, count=4),
        "page": dict(rows=140, cols=96, count=3)}
ENTRY = {"archive": "archive_entry", "page": "page_entry"}


def tiny(name):
    cell = find_cell(name)
    size = TINY[cell.traffic["loop"]]
    cell.traffic = {**cell.traffic, "check_pages": 2,
                    "pages": [{**k, **size} for k in cell.traffic["pages"]]}
    if "archive_batch_size" in cell.config:
        cell.config = {**cell.config, "archive_batch_size": 2}
    return cell


def run_tiny(name, trace=False, program=None, seed=2 ** 31 + 11):
    return harness.run(tiny(name), seed, 0.3, trace, device="cpu",
                       t_start=time.perf_counter(), program=program)[0]


@pytest.mark.parametrize("traffic", sorted({w["traffic"]
                                             for w in SPEC["workloads"]}))
def test_pages_deterministic_per_seed(traffic):
    with open(os.path.join(BENCH_DIR, "traffic", f"{traffic}.json")) as f:
        kinds = json.load(f)["pages"]
    kinds = [{**k, "count": 2} for k in kinds]
    a = pages.make_pool(kinds, 2 ** 33 + 5)
    b = pages.make_pool(kinds, 2 ** 33 + 5)
    c = pages.make_pool(kinds, 2 ** 33 + 6)
    assert [p.shape for p in a] == [(k["rows"], k["cols"]) for k in kinds
                                    for _ in range(2)]
    assert all(p.dtype == bool for p in a)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not all(np.array_equal(x, y) for x, y in zip(a, c))
    # every seed the same work: the same ink on every page
    assert len({int(p.sum()) for p in a + c}) == 1


def test_pool_of_mixed_kinds():
    kinds = [{"rows": 60, "cols": 50, "content": "text", "count": 2},
             {"rows": 30, "cols": 50, "content": "blank", "count": 1},
             {"rows": 30, "cols": 50, "content": "text", "count": 2}]
    pool = pages.make_pool(kinds, 2 ** 32 + 9)
    assert [p.shape for p in pool] == [(60, 50)] * 2 + [(30, 50)] * 3
    assert not pool[2].any() and pool[3].any() and pool[4].any()
    # a kind's pages are the text pages that its size and the seed give
    assert np.array_equal(pool[0], pages.make_pages(60, 50, 1, 2 ** 32 + 9)[0])
    from loops import archive
    assert archive.job_batches(pool, 2) == [[0, 1], [2, 3], [4]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_found_from_its_name(name):
    cell = find_cell(name)
    assert cell.chips == 1
    loop = load("loops", cell.traffic["loop"])
    assert callable(loop.run) and callable(loop.compare)
    program = load("programs", cell.config["program"])
    assert callable(getattr(program, ENTRY[cell.traffic["loop"]]))
    assert callable(load("reference", cell.config["reference"]).stream)
    names = [m["name"] for m in cell.end_to_end + cell.per_layer]
    assert "setup_s" in names
    for m in names:
        assert callable(load_reader(m).read)


def test_new_files_found_without_edits(tmp_path):
    """A configuration, two traffic mixes (one of mixed page sizes with a
    blank back), a loop, a program, a reference and a metric, each added
    as a new file with its entries, are found and run on the CPU in a
    copy of the benchmark, and no file that was there changes."""
    root = tmp_path / "checkout"
    bench = root / "benchmark"
    shutil.copytree(BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = load_spec()
    (bench / "configs/dummy.json").write_text(json.dumps(
        {"name": "dummy", "program": "dummy_program",
         "reference": "dummy_reference", "codec": 8, "W": 8, "R": 16,
         "T": None, "archive_batch_size": 2}))
    (bench / "traffic/duplex_mix.json").write_text(json.dumps(
        {"loop": "archive", "check_pages": 5, "trace_seconds": None,
         "pages": [{"rows": 40, "cols": 48, "content": "text", "count": 2},
                   {"rows": 40, "cols": 48, "content": "blank", "count": 1},
                   {"rows": 24, "cols": 48, "content": "text", "count": 2}]}))
    (bench / "traffic/tiny_page.json").write_text(json.dumps(
        {"loop": "dummy_loop", "check_pages": 1, "trace_seconds": None,
         "pages": [{"rows": 32, "cols": 40, "content": "text",
                    "count": 2}]}))
    (bench / "loops/dummy_loop.py").write_text(
        "from loops.page import compare, run  # noqa: F401\n")
    (bench / "programs/dummy_program.py").write_text(
        "from programs.causal_windowed import (  # noqa: F401\n"
        "    archive_entry, page_entry)\n")
    (bench / "reference/dummy_reference.py").write_text(
        "from reference.codec8 import stream  # noqa: F401\n")
    (bench / "metrics/dummy_ms.py").write_text(
        "def read(ctx):\n    return 1.5\n")
    spec["configs"].append({"name": "dummy", "source": "x",
                            "file": "benchmark/configs/dummy.json",
                            "reduced": [], "why": "x"})
    for traffic in ("duplex_mix", "tiny_page"):
        spec["workloads"].append({"name": f"dummy.{traffic}",
                                  "config": "dummy", "traffic": traffic,
                                  "chips": 1, "why": "x"})
    spec["per_layer"].append({"name": "dummy_ms", "unit": "ms",
                              "better": "lower", "source": "host_clock",
                              "layer": "x", "moves": "page_ms",
                              "workloads": ["dummy.tiny_page"]})
    for m in spec["end_to_end"]:
        if "workloads" in m and m["name"] == "page_ms":
            m["workloads"].append("dummy.tiny_page")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    code = (
        "import sys, time, json; sys.path[:0] = [%r, %r]\n"
        "from core import harness\n"
        "from core.cell import find_cell\n"
        "out = {}\n"
        "for name, trace in (('dummy.duplex_mix', False),\n"
        "                    ('dummy.tiny_page', True)):\n"
        "    r, _ = harness.run(find_cell(name), 2 ** 31 + 3, 0.2, trace,\n"
        "                       device='cpu', t_start=time.perf_counter())\n"
        "    out[name] = [r['correct'], r['attempted'],\n"
        "                 sorted(r['metrics']), r['checks']]\n"
        "print(json.dumps(out))\n") % (str(bench), REPO)
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=root)
    assert run.returncode == 0, run.stderr[-3000:]
    out = json.loads(run.stdout.splitlines()[-1])
    correct, attempted, _, ck = out["dummy.duplex_mix"]
    assert correct and attempted % 5 == 0
    assert ck["sampled_pages_wrong"]["value"] == 0
    assert ck["journal_bytes_off"]["value"] == 0
    correct, attempted, metrics, _ = out["dummy.tiny_page"]
    assert correct and attempted > 0 and "dummy_ms" in metrics
    # the files that were there are untouched
    for sub in ("configs", "traffic", "metrics", "core", "reference",
                "loops", "programs"):
        for f in os.listdir(os.path.join(BENCH_DIR, sub)):
            p = os.path.join(BENCH_DIR, sub, f)
            if os.path.isfile(p):
                with open(p, "rb") as a, open(bench / sub / f, "rb") as b:
                    assert a.read() == b.read()


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_result_keys(name, trace):
    r = run_tiny(name, trace)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    keys += ["breakdown"] if trace else []
    assert list(r) == keys + ["card", "set_up", "checks"]
    assert r["set_up"]["built"] in (True, False)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    want = find_cell(name).per_layer if trace else find_cell(name).end_to_end
    device_metrics = {m["name"] for m in want
                      if m["source"] == "device_trace"}
    got = set(r["metrics"])
    assert got == {m["name"] for m in want} - (device_metrics - got)
    assert all(set(v) == {"value", "unit"} for v in r["metrics"].values())
    assert all(set(v) == {"value", "limit"} for v in r["checks"].values())
    assert ("busy_s" in r["device"]) == trace


def _summary():
    # kernels a [0, 10), b [5, 20) overlap, c [30, 40); span "pack" over
    # [20, 30) and "fetch" inside it over [22, 26); ns
    device = [(0, 10, "a"), (5, 20, "b"), (30, 40, "rans_encode_kernel")]
    spans = [(19, 31, "pack"), (22, 26, "fetch")]
    return tracing.TraceSummary(device, spans, window_s=50e-9)


def test_trace_union_and_idle():
    t = _summary()
    assert t.busy == [(0, 20), (30, 40)] and t.busy_s == pytest.approx(30e-9)
    idle = load_reader("device_idle_pct.page")
    ctx = dataclasses.make_dataclass("C", ["trace"])(t)
    assert idle.read(ctx) == pytest.approx(40.0)
    assert t.idle_by_span() == {"pack": pytest.approx(6e-9),
                                "fetch": pytest.approx(4e-9)}
    assert t.kernel_seconds("rans_encode") == (pytest.approx(10e-9), 1)
    assert t.op_seconds()["b"] == pytest.approx(15e-9)


def test_k7_roofline_reader_on_a_synthetic_trace():
    from reference import codec13, roofline
    img = pages.make_pages(140, 96, 1, 3)[0]
    stream = codec13.encode(img)
    t = tracing.TraceSummary([(0, 2_000, "rans_encode_kernel<int>")], [],
                             1e-3)
    w = dataclasses.make_dataclass("W", ["pages", "served", "first"])(
        1, [0], {0: stream})
    cell = tiny("c13_rans.check_page")
    ctx = dataclasses.make_dataclass(
        "C", ["trace", "window", "pool", "cell"])(t, w, [img], cell)
    S, sr = codec13.stripes(140, None)
    nbytes = roofline.rans_work(140 * 96, -(-sr * 96 // 32), S, 32,
                                codec13.word_bytes(stream))[0]
    want = 100 * nbytes / roofline.H100_HBM_BYTES_PER_S / 2e-6
    assert load_reader("k7_roofline").read(ctx) == pytest.approx(want)


def test_no_jax_module_loaded():
    here = os.path.dirname(os.path.abspath(__file__))
    code = ("import sys; sys.path[:0] = [%r, %r, %r]; import run; "
            "from test_benchmark_harness import run_tiny; "
            "run_tiny('c8_causal_w16.fax_archive'); "
            "run_tiny('c13_rans.check_page', True); "
            "print(run.forbidden_modules())") % (here, BENCH_DIR, REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("name", CELLS)
def test_control_refused(name):
    r = run_tiny(name, program=control.Control(find_cell(name).config))
    assert r["correct"] is False
    assert r["checks"]["sampled_pages_wrong"]["value"] > 0


def _fault_altered_answer(mp):
    from binary_image_compression_tpu_torch.models import compress
    pack, ser = compress.pack_pages, compress._serialize_scab_rans
    flip = lambda b: b[:-1] + bytes([b[-1] ^ 1])
    mp.setattr(compress, "pack_pages",
               lambda *a, **k: [flip(b) for b in pack(*a, **k)])
    mp.setattr(compress, "_serialize_scab_rans",
               lambda *a, **k: flip(ser(*a, **k)))


def _fault_half_batch(mp):
    from binary_image_compression_tpu_torch.models import compress
    enc = compress.encode_batch

    def half(pages, *a, **k):
        out = enc(pages[: max(1, len(pages) // 2)], *a, **k)
        return (out * 2)[:len(pages)]
    mp.setattr(compress, "encode_batch", half)


def _fault_journal_skipped(mp):
    from binary_image_compression_tpu_torch.models import archive
    mp.setattr(archive, "_journal_append", lambda *a, **k: None)


def _fault_host_route(mp):
    from binary_image_compression_tpu_torch.models import compress
    mp.setattr(compress, "encode",
               lambda img, params, **k: compress.host_encode(img, params))
    mp.setattr(compress, "encode_batch", lambda pages, params, **k: [
        compress.host_encode(p, params) for p in pages])


FAULTS = [("altered_answer", _fault_altered_answer, CELLS),
          ("half_batch", _fault_half_batch, ["c8_causal_w16.fax_archive"]),
          ("journal_skipped", _fault_journal_skipped,
           ["c8_causal_w16.fax_archive"]),
          ("host_route", _fault_host_route,
           ["c8_causal_w16.fax_archive", "c8_causal_w16.fax_page"])]


@pytest.mark.parametrize("fault,cell", [(f, c) for f, _, cells in FAULTS
                                        for c in cells])
def test_fault_refused(fault, cell, monkeypatch):
    dict((f, p) for f, p, _ in FAULTS)[fault](monkeypatch)
    assert run_tiny(cell)["correct"] is False


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(name):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          name, "--seed", str(2 ** 32 + 3), "--seconds", "3",
                          "--trace", "0"], capture_output=True, text=True,
                         timeout=1200, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.splitlines()[-1])["correct"] is True
