"""The port's completeness: every public top-level name of each module of
the JAX package has a counterpart in the port's module of the same path,
or stands on the allowlist below with its reason.  Both packages are
parsed with ``ast``; nothing is imported, JAX least of all."""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(REPO, "binary_image_compression_tpu")
PORT_PKG = os.path.join(REPO, "binary_image_compression_tpu_torch")

_NOT_PORTED = "not ported, on purpose (ROADMAP.md)"

# (module path, name) -> (port module path, name): ported under another
# name or into another module; the test checks that the target exists
RENAMED = {
    ("ops/pallas_kernels.py", "fused_search_select"):
        ("ops/fused_search.py", "fused_search_select"),          # K1
    ("ops/pallas_kernels.py", "select_windows"):
        ("ops/select_windows.py", "select_windows"),              # K4
    ("ops/pallas_kernels.py", "packed_dist_matrix"):
        ("ops/packed_dist.py", "packed_dist_matrix"),             # K5
    ("ops/pallas_kernels.py", "packed_row_weight"):
        ("ops/packed_dist.py", "packed_row_weight"),              # K6
    ("ops/pallas_decide.py", "decide_modes"):
        ("ops/decide.py", "decide_modes"),                        # K2
    ("ops/pallas_strict.py", "strict_analyze"):
        ("ops/strict.py", "strict_analyze"),                      # K3
    ("ops/egdevice.py", "eg_encode_runs_device"):
        ("ops/egdevice.py", "eg_encode"),                         # K8
    ("ops/ransdevice.py", "rans_encode_scan"):
        ("ops/ransdevice.py", "rans_encode"),                     # K7
    ("ops/ransdevice.py", "pack_stream_words"):                   # K7's
        ("ops/bitstream.py", "pack_varlen"),                      # plain
    ("ops/entropy.py", "universal_codelength_jnp"):
        ("ops/entropy.py", "universal_codelength_t"),
    ("ops/entropy.py", "enum_codelength_jnp"):
        ("ops/entropy.py", "enum_codelength_t"),
}

# (module path, name) -> why the port has no counterpart of that name
ALLOWED = {
    **{key: f"ported as {mod[:-3].replace('/', '.')}.{name}"
       for key, (mod, name) in RENAMED.items()},
    # TPU layout helpers of the Pallas modules
    ("ops/pallas_kernels.py", "fused_supported"):
        "a Mosaic shape limit; K1 takes every W <= 32 (K4 the rest)",
    ("ops/pallas_kernels.py", "make_select_kernel"):
        "builds a Pallas kernel body; the port's kernels are .cu sources",
    ("ops/pallas_kernels.py", "packed_sel_layout"):
        "a TPU lane layout of the selection records",
    ("ops/pallas_kernels.py", "plan_groups"):
        "the 128-lane chunk plan of the TPU kernels",
    ("ops/pallas_strict.py", "supported"):
        "a Mosaic VMEM limit; K3 spills its ring to device memory instead",
    # JAX's Python coders for a missing native library: the port raises
    ("ops/entropy.py", "RangeEncoder"): _NOT_PORTED + ": Python fallback "
        "of the native range coder",
    ("ops/entropy.py", "RangeDecoder"): _NOT_PORTED + ": Python fallback "
        "of the native range decoder",
    ("ops/entropy.py", "cabac_model_update"): _NOT_PORTED + ": called only "
        "by the Python range-coder loops",
    ("ops/entropy.py", "scab_model_update"): _NOT_PORTED + ": called only "
        "by the Python range-coder loops",
    ("ops/entropy.py", "scab_ramp_shift"): _NOT_PORTED + ": called only by "
        "the Python range-coder loops",
    # A/B variants and the XLA selector
    ("ops/search.py", "window_distance_maps"): _NOT_PORTED + ": the "
        "unbanded maps of the 'xla' selector and encode_analyze_strict",
    ("ops/search.py", "scan_keys"): _NOT_PORTED + ": the 'xla' selector",
    ("ops/search.py", "select_best"): _NOT_PORTED + ": the 'xla' selector",
    ("models/compress.py", "encode_analyze_strict"): _NOT_PORTED + ": the "
        "XLA strict analysis, an A/B variant of K3",
    # the TPU cost models
    ("utils/roofline.py", "V5E_HBM_BYTES"): "the v5e model; the port's "
        "roofline is the H100's",
    ("utils/roofline.py", "V5E_VPU_LANE_OPS"): "the v5e model; the port's "
        "roofline is the H100's",
    ("utils/roofline.py", "SELECTION_LANE_OPS"): "the v5e VPU op count of "
        "the selection",
    ("utils/roofline.py", "utilization"): "v5e utilization",
    ("utils/profiling.py", "device_trace"): "a jax.profiler scope; the "
        "port uses torch.profiler as it is, and its span recorder "
        "(profiling.span) is on the profiler's clock",
    ("utils/roofline.py", "field_packing"): "the v5e lane packing of fields",
    ("utils/roofline.py", "fused_search_model"): "the v5e model of K1",
}
for _name in ("CASES", "DevCost", "V5E", "case_bsvd", "case_corpus_merge",
              "case_pageshard", "case_tileshard", "collective_traffic",
              "compiled_cost", "multihost_report", "suite",
              "weak_scaling_report"):
    ALLOWED[("parallel/scaling.py", _name)] = (
        _NOT_PORTED + ": an HLO cost model of the TPU meshes")


def _names(path: str, with_imports: bool) -> set:
    """Public top-level names of a module: defs, classes, assignments and
    (for the port, where a name may be re-exported) imports."""
    with open(path) as f:
        tree = ast.parse(f.read())
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out.update(n.id for t in node.targets for n in ast.walk(t)
                       if isinstance(n, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            out.add(node.target.id)
        elif with_imports and isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split(".")[0] for a in node.names)
    return {n for n in out if not n.startswith("_") or n == "__version__"}


def _modules():
    for root, _, files in os.walk(JAX_PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.relpath(os.path.join(root, f),
                                      JAX_PKG).replace(os.sep, "/")


def _missing(rel: str) -> set:
    port = os.path.join(PORT_PKG, rel)
    have = _names(port, True) if os.path.exists(port) else set()
    return {(rel, n) for n in _names(os.path.join(JAX_PKG, rel), False)
            - have}


MODULES = sorted(_modules())


@pytest.mark.parametrize("rel", MODULES)
def test_every_jax_name_has_a_counterpart_or_a_reason(rel):
    unlisted = sorted(key[1] for key in _missing(rel) if key not in ALLOWED)
    assert not unlisted, f"{rel}: no port counterpart and no reason for " \
                         f"{unlisted}"


def test_allowlist_is_current():
    """Every entry is still missing from the port (a name ported since is
    taken off), every reason is one line, and every renamed counterpart
    exists in the port."""
    missing = set().union(*(_missing(rel) for rel in MODULES))
    assert sorted(set(ALLOWED) - missing) == []
    assert all(why and "\n" not in why for why in ALLOWED.values())
    gone = [target for target in RENAMED.values() if target[1] not in
            _names(os.path.join(PORT_PKG, target[0]), True)]
    assert gone == []
