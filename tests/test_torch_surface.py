"""The port's public surface against the reference's, on the source text
alone (``ast``; nothing is imported, so the file runs in well under a
second).

For every module of ``src/repro`` its mirror in ``src/repro_torch`` (the
same relative path) must define each public name the reference defines:
module-level functions and classes, and methods, whose names do not start
with ``_``, and every alias a class body makes of a method (``free =
release``, ``_evict_newest = _evict_one``: a name kept for callers), with
at least the reference's parameter names (a class's are its
``__init__``'s). A name the port imports or aliases counts as defined.

The differences allowed are exactly ROADMAP.md's "Not to port" and
"Renamed" entries: each entry below names the phrase under which that list
gives its reason and what stands in for it, and a test holds that the
phrase is there and that the difference still exists.
"""
import ast
from functools import lru_cache
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
REF, PORT = REPO / "src" / "repro", REPO / "src" / "repro_torch"

# reference modules with no mirror -> ROADMAP phrase
NOT_PORTED_MODULES = {
    "dist/compat.py": "`dist/compat.py`",
    "testing/__init__.py": "`testing/__init__.py`",
    "testing/hypothesis_fallback.py": "`testing/hypothesis_fallback.py`",
    "search/population.py": "`search/population.py`",
    "analysis/purity.py": "`analysis/purity.py`",
}
# reference module -> (its mirror, {reference name: port name}, phrase)
RENAMED_MODULES = {
    "analysis/pallas_budget.py": (
        "analysis/launch_budget.py",
        {"PallasBudgetChecker": "LaunchBudgetChecker"},
        "`analysis/pallas_budget.py` → `launch_budget.py`"),
    "analysis/prng.py": (
        "analysis/rng.py", {"PrngDisciplineChecker": "RngDisciplineChecker"},
        "`analysis/prng.py` → `rng.py`"),
}
# (reference module, name) with no counterpart -> phrase
NOT_PORTED = {
    ("core/quant.py", "QTensor.tree_flatten"): "`QTensor.tree_flatten`",
    ("core/quant.py", "QTensor.tree_unflatten"): "`tree_unflatten`",
    ("dist/runtime.py", "global_put"): "`global_put`",
    ("dist/runtime.py", "replicated"): "`replicated`",
    ("dist/sharding.py", "to_shardings"): "`dist/sharding.py::to_shardings`",
    ("kernels/ops.py", "TQPlan"): "`TQPlan`",
    ("kernels/ops.py", "tq_plan"): "`tq_plan`",
    ("kernels/ops.py", "on_tpu"): "`on_tpu`",
    ("kernels/group_quant.py", "group_quant_pallas"): "`group_quant_pallas`",
    ("kernels/transform_quant.py", "transform_quant_pallas"):
        "`transform_quant_pallas`",
    ("kernels/quant_matmul.py", "quant_matmul_pallas"):
        "`quant_matmul_pallas`",
    ("kernels/flash_decode.py", "flash_decode_pallas"):
        "`flash_decode_pallas`",
    ("kernels/paged_decode.py", "paged_decode_pallas"):
        "`paged_decode_pallas`",
    ("kernels/paged_decode.py", "paged_decode_gqa_pallas"):
        "`paged_decode_gqa_pallas`",
    ("models/layers.py", "init_attn"): "`layers.init_attn`",
    ("models/layers.py", "init_mlp"): "`init_mlp`",
    ("obs/tracing.py", "enable_xprof"): "`obs.tracing.enable_xprof`",
    ("search/install.py", "eval_candidates_unit"): "`eval_candidates_unit`",
    ("search/install.py", "eval_candidates_stack"): "`eval_candidates_stack`",
    ("search/islands.py", "gather_island_states"): "`gather_island_states`",
    ("search/islands.py", "scatter_island_states"):
        "`scatter_island_states`",
    ("serving/decode.py", "sample_step_keys"):
        "`serving/decode.py::sample_step_keys`",
}
# a parameter the port does without, wherever the reference takes it
PARAMS_ANYWHERE = {"use_pallas": "`use_pallas`", "axis_name": "`axis_name`",
                   "key": "`key`", "shardings": "`shardings`"}
# (reference module, name, parameter) -> phrase
PARAMS = {
    ("kernels/ops.py", "flash_decode", "chunk"): "`flash_decode(chunk=)`",
    ("models/layers.py", "blocked_attention", "unroll"):
        "`blocked_attention(unroll=)`",
    ("obs/aggregate.py", "dist_snapshot", "force_gather"):
        "`dist_snapshot(force_gather=)`",
    ("dist/runtime.py", "initialize", "local_device_ids"):
        "`initialize(local_device_ids=)`",
    ("launch/dryrun.py", "run_cell", "keep_text"): "`run_cell(keep_text=)`",
    ("models/layers.py", "attn_out", "cfg"): "`attn_out`",
    ("models/layers.py", "init_moe", "dtype"): "`init_moe`",
    ("launch/roofline.py", "collective_bytes", "hlo_text"):
        "`collective_bytes(hlo_text)`",
    ("search/islands.py", "migrate_on_mesh", "t_stack"):
        "`migrate_on_mesh(t_stack, bt, bfq)`",
    ("search/islands.py", "migrate_on_mesh", "bt"):
        "`migrate_on_mesh(t_stack, bt, bfq)`",
    ("search/islands.py", "migrate_on_mesh", "bfq"):
        "`migrate_on_mesh(t_stack, bt, bfq)`",
    ("obs/tracing.py", "trace_span", "xprof"): "`trace_span(xprof=)`",
}


def _params(fn, drop_self):
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    return tuple(names[1:] if drop_self and names else names)


def surface(tree, defined_only=True):
    """{public name: its parameter names, or None where the source does not
    say}: module-level functions and classes (a class by its ``__init__``),
    methods, and the aliases a class body makes of a method. With
    ``defined_only=False`` module-level imports and aliases count too (a
    name the module offers)."""
    out, classes = {}, {}
    for node in tree.body:
        if isinstance(node, ast.ClassDef):
            classes[node.name] = {b.name: b for b in node.body
                                  if isinstance(b, ast.FunctionDef)}
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and not node.name.startswith("_"):
            out[node.name] = _params(node, False)
        elif isinstance(node, ast.ClassDef) and \
                not node.name.startswith("_"):
            fns = classes[node.name]
            init = fns.get("__init__")
            out[node.name] = _params(init, True) if init else None
            for name, fn in fns.items():
                if not name.startswith("_"):
                    out[f"{node.name}.{name}"] = _params(fn, True)
            for b in node.body:
                if not isinstance(b, ast.Assign):
                    continue
                v = b.value
                if isinstance(v, ast.Name) and v.id in fns:
                    fn = fns[v.id]
                elif isinstance(v, ast.Attribute) and \
                        isinstance(v.value, ast.Name):
                    fn = classes.get(v.value.id, {}).get(v.attr)
                else:
                    continue
                for t in b.targets:
                    if isinstance(t, ast.Name):
                        out[f"{node.name}.{t.id}"] = \
                            _params(fn, True) if fn else None
        elif not defined_only and isinstance(node, ast.ImportFrom):
            out.update({a.asname or a.name: None for a in node.names})
        elif not defined_only and isinstance(node, ast.Assign):
            out.update({t.id: None for t in node.targets
                        if isinstance(t, ast.Name)})
    return out


@lru_cache(maxsize=None)
def _tree(path):
    return ast.parse(path.read_text(), filename=str(path))


def differences(rel, port_tree=None):
    """The reference module ``rel``'s public names missing from its mirror,
    as (name, None), and its parameters missing there, as (name, param).
    ``port_tree`` replaces the mirror's parsed source."""
    mirror, renames, _ = RENAMED_MODULES.get(rel, (rel, {}, None))
    ref = surface(_tree(REF / rel))
    port = surface(port_tree or _tree(PORT / mirror), defined_only=False)
    out = []
    for name, params in ref.items():
        head, dot, rest = name.partition(".")
        got = renames.get(head, head) + dot + rest
        if got not in port:
            out.append((name, None))
        elif params is not None and port[got] is not None:
            out += [(name, p) for p in params if p not in port[got]]
    return out


def unexplained(rel, diffs):
    return [(n, p) for n, p in diffs
            if not (p is None and (rel, n) in NOT_PORTED)
            and not (p is not None and (p in PARAMS_ANYWHERE
                                        or (rel, n, p) in PARAMS))]


REF_MODULES = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))


@pytest.mark.parametrize("rel", REF_MODULES)
def test_port_offers_the_reference_surface(rel):
    if rel in NOT_PORTED_MODULES:
        assert not (PORT / rel).exists(), f"{rel} is ported: drop its entry"
        return
    assert (PORT / RENAMED_MODULES.get(rel, (rel,))[0]).exists(), \
        f"{rel} has no mirror in src/repro_torch"
    assert unexplained(rel, differences(rel)) == []


def _roadmap_lists():
    text = (REPO / "ROADMAP.md").read_text()
    start = text.index("Not to port.")
    return " ".join(text[start:text.index("The bracketed numbers",
                                          start)].split())


def test_every_allowed_difference_is_a_roadmap_entry():
    lists = _roadmap_lists()
    phrases = (list(NOT_PORTED_MODULES.values())
               + [r[2] for r in RENAMED_MODULES.values()]
               + list(NOT_PORTED.values()) + list(PARAMS_ANYWHERE.values())
               + list(PARAMS.values()))
    missing = [p for p in phrases if p not in lists]
    assert missing == [], "not in ROADMAP's Not to port / Renamed lists"


def test_every_allowed_difference_still_exists():
    found = {(rel, n, p) for rel in REF_MODULES
             if rel not in NOT_PORTED_MODULES
             for n, p in differences(rel)}
    stale = [k for k in NOT_PORTED if (*k, None) not in found]
    stale += [k for k in PARAMS if k not in found]
    stale += [p for p in PARAMS_ANYWHERE if not any(q == p for *_, q in found)]
    assert stale == [], "allowed differences that no longer exist"


def _without(rel, edit):
    tree = ast.parse((PORT / rel).read_text())
    edit(tree)
    return tree


def _drop_class_alias(cls, name):
    def edit(tree):
        node = next(n for n in tree.body
                    if isinstance(n, ast.ClassDef) and n.name == cls)
        node.body = [b for b in node.body if not (
            isinstance(b, ast.Assign) and any(
                getattr(t, "id", None) == name for t in b.targets))]
    return edit


def _drop_kwonly(fn_name, names):
    def edit(tree):
        fn = next(n for n in tree.body
                  if isinstance(n, ast.FunctionDef) and n.name == fn_name)
        keep = [(a, d) for a, d in zip(fn.args.kwonlyargs,
                                       fn.args.kw_defaults)
                if a.arg not in names]
        fn.args.kwonlyargs = [a for a, _ in keep]
        fn.args.kw_defaults = [d for _, d in keep]
    return edit


@pytest.mark.parametrize("rel,edit,want", [
    ("serving/paged_cache.py", _drop_class_alias("PageAllocator", "free"),
     [("PageAllocator.free", None)]),
    ("serving/batcher.py",
     _drop_class_alias("ContinuousBatcher", "_evict_newest"),
     [("ContinuousBatcher._evict_newest", None)]),
    ("serving/decode.py",
     _drop_kwonly("make_paged_decode_step", ("temperature", "top_k")),
     [("make_paged_decode_step", "temperature"),
      ("make_paged_decode_step", "top_k")]),
], ids=["free", "evict_newest", "sampled_step"])
def test_the_comparison_sees_a_missing_name_or_parameter(rel, edit, want):
    """The port as it stood before ``PageAllocator.free``,
    ``ContinuousBatcher._evict_newest`` and the batch-wide sampled step:
    each gap is a difference no entry explains."""
    assert unexplained(rel, differences(rel)) == []
    assert unexplained(rel, differences(rel, _without(rel, edit))) == want


def test_the_parameter_names_are_read_from_the_source():
    got = surface(ast.parse("class A:\n    def __init__(self, x, *, y=1):\n"
                            "        pass\n    def f(self, a):\n        pass\n"
                            "    g = f\n    _h = f\n"
                            "def k(p, q=2):\n    pass\n"))
    assert got == {"A": ("x", "y"), "A.f": ("a",), "A.g": ("a",),
                   "A._h": ("a",), "k": ("p", "q")}
