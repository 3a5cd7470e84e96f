"""The span recorder of ``utils/profiling`` and the spans and counters that
the served encode paths emit: off it keeps nothing, on it gives parents,
request ids and threads (the pack pool's too), its clock is the one of
``torch.profiler``'s events, each path emits its spans once a page or a
batch, and ``PipelineProfile`` reports as before.  CPU only, tiny pages,
no JAX."""

import collections
import json
import os
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from binary_image_compression_tpu_torch import cli
from binary_image_compression_tpu_torch.models import archive, codec, compress
from binary_image_compression_tpu_torch.ops import bitpack
from binary_image_compression_tpu_torch.utils import pnm, profiling

ROWS, COLS, W, R = 40, 70, 8, 16
P8 = codec.CodecParams(codec=8, W=W, R=R, strict=False)
P13 = codec.CodecParams(codec=13, W=0, T=0, R=0)


def _pages(n=2):
    rng = np.random.RandomState(7)
    return [rng.rand(ROWS, COLS) < 0.2 for _ in range(n)]


@pytest.fixture
def recorder():
    profiling.record(True)
    profiling.take()
    try:
        yield profiling
    finally:
        profiling.record(False)
        profiling.take()


def _words_bytes(rows, cols, w):
    """Bytes of the packed int32 words of one page padded to the w grid."""
    return -(-rows // w) * w * bitpack.nwords(-(-cols // w) * w) * 4


def test_off_records_nothing():
    profiling.record(False)
    profiling.take()
    assert profiling.span("x") is profiling.OFF
    assert profiling.span("y", parent=profiling.OFF) is profiling.OFF
    with profiling.span("x") as sp:
        profiling.count("n", 3)
    assert sp is profiling.OFF
    compress.encode(_pages(1)[0], P8, device="cpu")
    compress.encode_scab(_pages(1)[0], P13, entropy="device", device="cpu")
    assert profiling.take() == ([], [])


def test_nesting_parents_requests_and_threads(recorder):
    with recorder.span("a") as a:
        with recorder.span("b") as b:
            recorder.count("n", 5)

        def work(i):
            with recorder.span("t", parent=a) as t:
                with recorder.span("u") as u:
                    return t, u, threading.get_ident()

        done = []
        th = [threading.Thread(target=lambda i=i: done.append(work(i)))
              for i in range(2)]
        for x in th:
            x.start()
        for x in th:
            x.join(timeout=30)
        assert not any(x.is_alive() for x in th)
    with recorder.span("c") as c:
        pass
    spans, counts = recorder.take()
    assert b.parent is a and a.parent is None and c.parent is None
    assert a.request == b.request and c.request != a.request
    assert counts == [("n", 5, counts[0][2], b)]
    assert b.start <= counts[0][2] <= b.end
    assert len(done) == 2
    for t, u, ident in done:
        assert t.parent is a and u.parent is t
        assert t.request == u.request == a.request
        assert t.thread == u.thread == ident != a.thread
        assert a.start <= t.start <= u.start <= u.end <= t.end <= a.end
    assert [s.name for s in spans].count("t") == 2
    assert spans[-1] is c and spans[-2] is a      # kept as they end


def test_span_encloses_the_profilers_event(recorder):
    x = torch.ones(96, 96)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with recorder.span("mm") as sp:
            x.mm(x)
    ev = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "aten::mm"]
    assert len(ev) == 1
    assert sp.start <= ev[0].start_ns() <= ev[0].end_ns() <= sp.end


C8 = ["upload", "upload.host", "upload.h2d", "analysis", "fetch", "pack"]
C8_PAGE = ["pack.page", "crc", "pack.unpack", "pack.native"]
C13 = ["page", "upload", "upload.host", "upload.h2d", "rans_fields",
       "rans.map", "rans.counts", "rans.table", "rans.k7", "rans.pack_table",
       "fetch", "serialize", "crc"]


def _encode(path, pages, tmp_path):
    if path == "encode":
        return [compress.encode(p, P8, device="cpu") for p in pages]
    if path == "encode_batch":
        return compress.encode_batch(np.stack(pages), P8, device="cpu")
    if path == "encode_archive":
        return archive.encode_archive(pages, P8, batch_size=2, device="cpu",
                                      checkpoint=str(tmp_path / "journal"))
    return [compress.encode_scab(p, P13, entropy="device", device="cpu")
            for p in pages]


def _expected(path, n):
    """Span name -> how many a call over n pages emits."""
    if path == "encode_scab":
        return {k: n for k in C13}
    want = {k: n if path == "encode" else 1 for k in C8}
    want.update({k: n for k in C8_PAGE})
    if path == "encode":
        want["page"] = n
    if path == "encode_archive":
        want.update(archive_job=1, fingerprint=1, stack=1, journal=1,
                    container=1)
    return want


@pytest.mark.parametrize("path", ["encode", "encode_batch",
                                  "encode_archive", "encode_scab"])
def test_encode_paths_emit_their_spans(recorder, path, tmp_path):
    pages = _pages(2)
    _encode(path, pages, tmp_path)
    spans, counts = recorder.take()
    assert collections.Counter(s.name for s in spans) == _expected(path, 2)
    for s in spans:
        assert s.start <= s.end
        if s.parent is not None:
            assert s.parent.start <= s.start and s.end <= s.parent.end
            assert s.request == s.parent.request
    roots = [s for s in spans if s.parent is None]
    if path != "encode_batch":          # page or archive_job requests
        assert {s.name for s in roots} <= {"page", "archive_job"}
        assert len({s.request for s in spans}) == len(roots)
    for s in spans:
        if s.name == "pack.page":
            assert s.parent.name == "pack"
    by_name = collections.defaultdict(list)
    for name, n, _, sp in counts:
        by_name[name].append((n, sp.name))
    w = 1 if path == "encode_scab" else W
    assert sum(n for n, _ in by_name["h2d_bytes"]) == \
        2 * _words_bytes(ROWS, COLS, w)
    assert {sp for _, sp in by_name["h2d_bytes"]} == {"upload.h2d"}
    assert {sp for _, sp in by_name["d2h_bytes"]} == {"fetch"}
    assert len(by_name["d2h_bytes"]) == (2 if path in ("encode",
                                                        "encode_scab")
                                         else 1)
    # a CPU block takes the host route of pack_pages, every page
    assert sum(n for n, _ in by_name["pack_pages_host"]) == \
        (0 if path == "encode_scab" else 2)
    assert not by_name["pack_pages_device"]


def test_pipeline_profile_report_and_stages_unchanged(recorder):
    prof = profiling.PipelineProfile()
    prof.stages["native_pack"] = profiling.StageStats(0.5, 2_000_000, 2)
    prof.stages["grid_prep"] = profiling.StageStats(0.25, 0, 1)
    assert prof.report() == (
        "native_pack                 500.00 ms        4.0 MB/s  x2\n"
        "grid_prep                   250.00 ms        0.0 MB/s  x1")
    prof = profiling.PipelineProfile()
    for p in _pages(2):
        compress.encode(p, P8, device="cpu", profile=prof)
    assert list(prof.stages) == ["grid_prep", "device_analysis",
                                 "native_pack"]
    assert all(st.calls == 2 and st.seconds > 0
               for st in prof.stages.values())
    assert prof.stages["grid_prep"].bytes_moved == 2 * ROWS * COLS // 8
    spans, _ = recorder.take()
    assert not {s.name for s in spans} & set(prof.stages)
    # each stage encloses the spans it times
    up = [s for s in spans if s.name == "upload"]
    assert prof.stages["grid_prep"].seconds >= sum(s.seconds for s in up)


def test_cli_writes_spans(tmp_path):
    src = tmp_path / "in.pbm"
    pnm.write_pbm(_pages(1)[0], str(src))
    out = tmp_path / "spans.jsonl"
    cli.main(["compress", str(src), str(tmp_path / "o.bic"), "-W", str(W),
              "-R", str(R), "--device", "cpu", "--spans", str(out)])
    lines = [json.loads(x) for x in out.read_text().splitlines()]
    spans = [x for x in lines if "span" in x]
    assert collections.Counter(x["span"] for x in spans) == \
        _expected("encode", 1)
    page = next(x for x in spans if x["span"] == "page")
    assert page["parent"] is None
    assert all(x["request"] == page["request"] for x in spans)
    assert all(spans[x["parent"]]["span"] in ("page", "upload", "pack",
                                              "pack.page")
               for x in spans if x["parent"] is not None)
    assert {x["count"] for x in lines if "count" in x} == {
        "h2d_bytes", "d2h_bytes", "pack_pages_host"}
    assert not profiling.RECORDER.on and profiling.take() == ([], [])
    assert os.path.getsize(tmp_path / "o.bic") > 0
