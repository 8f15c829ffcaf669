"""The port's public surface against the JAX package's.

An ``ast`` walk over every module of ``video_analytics_tpu`` outside
``ops/pallas/`` (whose kernels ``csrc/`` ports, PERF.md section 6): each
public top-level function or class has a counterpart of the same name in
the port's module of the same path, or stands in ``NOT_PORTED`` with its
reason.  Each name a ``__init__`` of the reference exports imports from
the port's package of the same path, unless it is in ``NOT_PORTED``; in
``flow`` and ``runtime`` three such names stay the port's submodules
(``SUBMODULES``), the function one attribute further.
"""

import ast
import importlib
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF, PORT = "video_analytics_tpu", "video_analytics_tpu_torch"

NO_JIT = "no jit in the port: the eager function is the entry point"
MESH = ("a process holds its own rows and a copy of the weights: no mesh "
        "and no global array (parallel/mesh.py's docstring maps each)")
QUEUE1 = "TPU-only or tunnel-only (ROADMAP Queue 1 item 6)"
NOT_PORTED = {
    ("flow/tvl1.py", "tvl1_jit"): NO_JIT,
    ("flow/farneback.py", "farneback_jit"): NO_JIT,
    ("ops/preprocess.py", "preprocess_clip_jit"): NO_JIT,
    ("flow/farneback.py", "update_matrices_cf"):
        "the TPU's channels-first twin of update_matrices",
    ("runtime/checkpoint.py", "have_orbax"):
        "the port has no optional backend: AsyncCheckpointer is its own",
    ("parallel/mesh.py", "make_mesh"): MESH,
    ("parallel/mesh.py", "data_sharding"): MESH,
    ("parallel/mesh.py", "replicated"): MESH,
    ("parallel/mesh.py", "shard_batch"): MESH,
    ("parallel/mesh.py", "assemble_global_batch"): MESH,
    ("runtime/train.py", "shard_train_inputs"):
        MESH + "; broadcast_from_first and average_gradients stand for it",
    ("ops/bucketing.py", "bucket_hw"): QUEUE1,
    ("ops/bucketing.py", "bucketed_flow"): QUEUE1,
    ("utils/platform.py", "on_tpu"): QUEUE1,
    ("utils/platform.py", "pallas_interpret"): QUEUE1,
    ("utils/platform.py", "default_compute_dtype"): QUEUE1,
}
# Names a reference __init__ binds to a function that shadows its own
# submodule; the port's code and tests import these as modules.
SUBMODULES = {("flow", "farneback"), ("flow", "tvl1"),
              ("runtime", "evaluate")}


def _modules():
    root = os.path.join(REPO, REF)
    for d, _, files in os.walk(root):
        rel = os.path.relpath(d, root)
        if rel.split(os.sep)[:2] == ["ops", "pallas"]:
            continue
        for f in sorted(files):
            if f.endswith(".py") and f != "__init__.py":
                yield os.path.normpath(os.path.join(rel, f))


def _public(path: str):
    with open(path) as f:
        tree = ast.parse(f.read())
    return {n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)) and not n.name.startswith("_")}


def _inits():
    root = os.path.join(REPO, REF)
    for d, _, files in os.walk(root):
        rel = os.path.relpath(d, root)
        if "__init__.py" in files and "pallas" not in rel:
            yield "" if rel == "." else rel


def _exports(pkg_rel: str):
    with open(os.path.join(REPO, REF, pkg_rel, "__init__.py")) as f:
        tree = ast.parse(f.read())
    return [(n.module, a.asname or a.name) for n in tree.body
            if isinstance(n, ast.ImportFrom) for a in n.names]


@pytest.mark.parametrize("module", sorted(_modules()))
def test_every_public_name_has_a_counterpart(module):
    ours = os.path.join(REPO, PORT, module)
    ref = _public(os.path.join(REPO, REF, module))
    have = _public(ours) if os.path.exists(ours) else set()
    missing = sorted(n for n in ref - have if (module, n) not in NOT_PORTED)
    assert not missing, f"{module}: no counterpart for {missing}"
    stale = sorted(n for (m, n) in NOT_PORTED if m == module and n in have)
    assert not stale, f"{module}: {stale} are ported; drop them from the table"


def test_not_ported_names_exist_in_the_reference():
    for (module, name), reason in NOT_PORTED.items():
        assert name in _public(os.path.join(REPO, REF, module)), name
        assert reason


@pytest.mark.parametrize("pkg_rel", sorted(_inits()))
def test_init_exports_import_from_the_port(pkg_rel):
    dotted = pkg_rel.replace(os.sep, ".")
    port = importlib.import_module(PORT + ("." + dotted if dotted else ""))
    for module, name in _exports(pkg_rel):
        path = module[len(REF) + 1:].replace(".", os.sep) + ".py"
        if (path, name) in NOT_PORTED:
            assert not hasattr(port, name), f"{name} is ported now"
            continue
        got = getattr(port, name, None)
        assert got is not None, f"{PORT}.{dotted}: no {name}"
        if (dotted, name) in SUBMODULES:
            assert got.__name__ == f"{PORT}.{dotted}.{name}"
            got = getattr(got, name)
        assert callable(got), f"{PORT}.{dotted}.{name} is {got!r}"
        src = importlib.import_module(module.replace(REF, PORT, 1))
        assert getattr(src, name) is got, f"{name} is not the module's"
