"""The four-rank archive cell on the CPU at a size a test holds: the loop
starts ranks 1-3 itself (gloo on 127.0.0.1), every rank codes its range
with the program's plain kernels, and rank 0 reads the result: correct,
the sharded layer's metrics in a traced run, the control and a fault on
one rank refused, and a program without the sharded entry refused at
import, before any rank starts."""

import importlib
import sys
import time

import pytest

from core import control, harness
from core.cell import find_cell, load, load_reader

NAME = "c8_causal_w16_x4.fax_archive_x4"
SHARDED = ("barrier_wait_pct.x4", "rank_skew_pct.x4", "offsets_ms.x4",
           "write_ms.x4")


def tiny():
    cell = find_cell(NAME)
    cell.traffic = {**cell.traffic, "check_pages": 3,
                    "pages": [{**k, "rows": 48, "cols": 80, "count": 8}
                              for k in cell.traffic["pages"]]}
    cell.config = {**cell.config, "archive_batch_size": 1}
    return cell


def run_tiny(trace=False):
    return harness.run(tiny(), 2 ** 33 + 17, 0.5, trace, device="cpu",
                       t_start=time.perf_counter())[0]


def test_cell_found_from_its_name():
    """The cell's loop, program, reference and readers, found by name; it
    asks for 4 chips and the program offers the sharded entries."""
    cell = find_cell(NAME)
    assert cell.chips == 4 == cell.config["ranks"]
    loop = load("loops", cell.traffic["loop"])
    assert callable(loop.run) and callable(loop.compare)
    program = load("programs", cell.config["program"])
    assert callable(program.join) and callable(program.sharded_entry)
    assert callable(program.archive_entry)
    assert callable(load("reference", cell.config["reference"]).stream)
    names = [m["name"] for m in cell.end_to_end + cell.per_layer]
    assert "setup_s" in names and "archive_mpx_s" in names
    for m in names:
        assert callable(load_reader(m).read)


@pytest.mark.parametrize("trace", [False, True])
def test_cell_correct_on_the_cpu(trace):
    r = run_tiny(trace)
    assert r["correct"] is True and r["failed"] == 0, r["checks"]
    assert r["attempted"] % 8 == 0 and r["attempted"] >= 8
    assert r["checks"]["archive_unlike_one_card"]["value"] == 0
    assert r["device"]["count"] == 4
    if trace:
        got = set(r["metrics"])
        listed = {m["name"] for m in find_cell(NAME).per_layer
                  if m["source"] != "device_trace"}
        assert set(SHARDED) <= listed and listed <= got
        assert 0 <= r["metrics"]["barrier_wait_pct.x4"]["value"] < 100
    else:
        assert set(r["metrics"]) == {"archive_mpx_s", "setup_s"}


def test_control_refused():
    """The control, which offers no sharded entry, runs on every rank as
    the sharded program over its cleared pages, and is refused."""
    cell = tiny()
    r = harness.run(cell, 2 ** 33 + 19, 0.5, False, device="cpu",
                    t_start=time.perf_counter(),
                    program=control.Control(cell.config))[0]
    assert r["correct"] is False
    assert r["checks"]["sampled_pages_wrong"]["value"] > 0
    assert r["checks"]["archive_unlike_one_card"]["value"] > 0


def test_altered_answer_on_rank_0_refused(monkeypatch):
    from binary_image_compression_tpu_torch.models import compress
    pack = compress.pack_pages
    flip = lambda b: b[:-1] + bytes([b[-1] ^ 1])
    monkeypatch.setattr(compress, "pack_pages",
                        lambda *a, **k: [flip(b) for b in pack(*a, **k)])
    assert run_tiny()["correct"] is False


def test_journal_skipped_on_rank_0_refused(monkeypatch):
    from binary_image_compression_tpu_torch.models import archive
    monkeypatch.setattr(archive, "_journal_append", lambda *a, **k: None)
    r = run_tiny()
    assert r["correct"] is False
    assert r["checks"]["journal_bytes_off"]["value"] > 0


def test_program_without_the_sharded_entry_fails_at_import(monkeypatch):
    from binary_image_compression_tpu_torch.parallel import multihost
    monkeypatch.delattr(multihost, "encode_archive_sharded")
    monkeypatch.delitem(sys.modules, "programs.causal_windowed_x4",
                        raising=False)
    with pytest.raises(ImportError):
        importlib.import_module("programs.causal_windowed_x4")
    monkeypatch.delitem(sys.modules, "programs.causal_windowed_x4",
                        raising=False)
