"""The port's public surface against the JAX package's.

An ``ast`` walk over every module of ``video_analytics_tpu`` outside
``ops/pallas/`` (whose kernels ``csrc/`` ports, PERF.md section 6): each
public top-level function or class has a counterpart of the same name in
the port's module of the same path, or stands in ``NOT_PORTED`` with its
reason.  Each name a ``__init__`` of the reference exports imports from
the port's package of the same path, unless it is in ``NOT_PORTED``; in
``flow`` and ``runtime`` three such names stay the port's submodules
(``SUBMODULES``), the function one attribute further.

The walk also compares parameters: every parameter of a reference
function, of a public method (``__call__`` against ``forward`` on a torch
module) and every field of a reference dataclass or flax module (against
the constructor) exists in the port's counterpart under its name, or
stands in ``PARAMS_NOT_PORTED`` with its reason; a method of the
reference that the port has not stands in ``METHODS_NOT_PORTED``.
"""

import ast
import importlib
import inspect
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF, PORT = "video_analytics_tpu", "video_analytics_tpu_torch"

NO_JIT = "no jit in the port: the eager function is the entry point"
MESH = ("a process holds its own rows and a copy of the weights: no mesh "
        "and no global array (parallel/mesh.py's docstring maps each)")
QUEUE1 = "TPU-only or tunnel-only (ROADMAP Queue 1 item 3)"
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


# Parameters of the reference that the port's counterparts do not take:
# by name wherever they stand, or by (module, qualified name, parameter).
WEIGHTS = ("a torch module owns its weights (and a SpyNet rides along as "
           "flow_net): the model argument carries them")
PALLAS = ("a choice among the TPU's Pallas kernels; the port runs its CUDA "
          "kernels on a CUDA tensor and their plain versions on a CPU "
          "tensor, the route picked by the level's size (PERF.md section 6)")
KEY = ("a jax.random key: the port draws from a torch.Generator, or takes "
       "the draws (sample_crop_flip, synthetic_pair_draws)")
OPTAX = ("torch.optim's SGD made from lr (runtime/train.py's docstring) "
         "stands for the optax transformation and its state")
PARAMS_NOT_PORTED = {
    "variables": WEIGHTS,
    "flow_variables": WEIGHTS,
    "base_variables": WEIGHTS,
    "tx": OPTAX,
    "mesh": MESH,
    "use_pallas": PALLAS,
    "exact_warp": PALLAS,
    "scale_fused": PALLAS,
    "envelope": PALLAS,
    "band": PALLAS,
    "bounded": ("the Farneback Pallas kernels' narrower sweep when the "
                "caller clips the flow; the CUDA kernels sweep the full "
                "displacement, exact either way"),
    "train": "a torch module's mode (train() / eval()) plays its role",
    "key": KEY,
    "input_hw": ("the size of the reference's dummy batch: a torch "
                 "module's weights are made without a forward pass"),
    ("ops/kernels.py", "pad_border", "axes"): "named dims, torch's word",
    ("runtime/pipeline.py", "compute_flow", "gray_pairs_prev"):
        "named gray_prev",
    ("runtime/pipeline.py", "compute_flow", "gray_pairs_next"):
        "named gray_next",
    ("ingest/prefetch.py", "DevicePrefetcher.__init__", "sharding"): MESH,
    ("parallel/mesh.py", "model_sharding", "ndim"):
        MESH + "; the port's model_sharding slices a tensor it is given",
    ("models/resnet.py", "BottleneckBlock.__init__", "expansion"):
        "a class constant (4), which the reference never sets otherwise",
    ("runtime/evaluate.py", "evaluate_batched", "transport_crop"):
        "the port always takes the transport crop; False was the "
        "reference's A/B switch",
    ("runtime/evaluate.py", "evaluate_batched_multiprocess",
     "transport_crop"): "as evaluate_batched",
    ("runtime/train.py", "make_train_step", "weight_decay_mask"):
        "no caller of the reference sets it",
    ("runtime/train.py", "TrainState.__init__", "params"): OPTAX,
    ("runtime/train.py", "TrainState.__init__", "batch_stats"): WEIGHTS,
    ("runtime/train.py", "TrainState.__init__", "opt_state"): OPTAX,
    ("runtime/train.py", "TrainState.__init__", "step"): OPTAX,
    ("runtime/train_two_stream.py", "make_two_stream_train_steps",
     "model"): "the states hold the model's streams",
    ("runtime/train_two_stream.py", "make_two_stream_train_steps",
     "stream"): "the states say which streams train",
    ("runtime/train_two_stream.py", "two_stream_variables", "states"):
        "the model holds the trained streams",
}
METHODS_NOT_PORTED = {
    ("models/spynet.py", "SpyNet.setup"): "flax's setup: the port's __init__",
    ("models/two_stream.py", "TwoStreamModel.init_variables"):
        "the module owns its weights: init(generator)",
}


def _parameters(node):
    a = node.args
    return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs
            if x.arg not in ("self", "cls")]


def _signatures(path: str):
    """(qualified name, parameters) of every public function, every
    public method, ``__init__`` and ``__call__`` of every public class, and
    each class's annotated fields (as ``Class.__init__``)."""
    with open(path) as f:
        tree = ast.parse(f.read())
    for n in tree.body:
        if getattr(n, "name", "_").startswith("_"):
            continue
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield n.name, _parameters(n)
        elif isinstance(n, ast.ClassDef):
            fields = [b.target.id for b in n.body
                      if isinstance(b, ast.AnnAssign)
                      and isinstance(b.target, ast.Name)]
            if fields:
                yield f"{n.name}.__init__", fields
            for b in n.body:
                if (isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef))
                        and (not b.name.startswith("_")
                             or b.name in ("__init__", "__call__"))):
                    yield f"{n.name}.{b.name}", _parameters(b)


def _unported(module):
    """The reference's methods in `module` that have no counterpart in the
    port (as (module, qualified name)), and its parameters that the
    counterpart does not take (as (module, qualified name, parameter)).
    A torch module's ``forward`` stands for ``__call__``; a property has
    no parameters; a counterpart taking ``**kwargs`` takes them all."""
    if not os.path.exists(os.path.join(REPO, PORT, module)):
        return
    port = importlib.import_module(
        PORT + "." + module[:-3].replace(os.sep, "."))
    for qualname, params in _signatures(os.path.join(REPO, REF, module)):
        name, _, method = qualname.partition(".")
        if (module, name) in NOT_PORTED:
            continue
        target = getattr(port, name)
        if method:
            if method == "__call__" and "__call__" not in vars(target):
                method = "forward"
            target = inspect.getattr_static(target, method, None)
        if target is None:
            yield module, qualname
            continue
        if isinstance(target, property):
            continue
        have = inspect.signature(getattr(target, "__func__", target)
                                 ).parameters
        if not any(p.kind == p.VAR_KEYWORD for p in have.values()):
            yield from ((module, qualname, p) for p in params
                        if p not in have)


@pytest.mark.parametrize("module", sorted(_modules()))
def test_every_parameter_has_a_counterpart(module):
    """Each parameter of the reference's functions, methods and fields is
    one of its counterpart's, or in PARAMS_NOT_PORTED; each method has a
    counterpart, or stands in METHODS_NOT_PORTED."""
    missing = [k for k in _unported(module)
               if k not in METHODS_NOT_PORTED and k not in PARAMS_NOT_PORTED
               and k[-1] not in PARAMS_NOT_PORTED]
    assert not missing, f"not in the port: {missing}"


def test_params_not_ported_is_current():
    """Every entry still names a parameter or a method the port lacks,
    and the reference's compute dtype is not among them: the port takes
    it."""
    assert "dtype" not in PARAMS_NOT_PORTED
    used = set()
    for module in _modules():
        for k in _unported(module):
            used.update((k, k[-1]))
    stale = [k for k in (*PARAMS_NOT_PORTED, *METHODS_NOT_PORTED)
             if k not in used]
    assert not stale, f"the port has these now: {stale}"
