"""The model axis (``parallel/mesh.py``) on the CPU: four gloo processes,
data 2 × model 2, held against the JAX package.

The case of ``tests/test_parallel.py``'s
``test_model_axis_tensor_parallel_matches``: a ResNet-18 of 6 classes with
JAX's ``PRNGKey(0)`` weights at 32×32, 8 rows; on each process, after
``shard_dense_over_model``, the ``fc`` holds half the output columns, and
the logits of its data index's 4 rows equal the JAX package's unsharded
forward within 1e-5.  The gradient of a loss on those rows equals the
unsharded port model's on them within 1e-5 on every parameter (the
``fc``'s: this process's columns).  With 5 classes the ``fc`` stays whole
and the answers are the same.  A sharded two-stream model refuses to give
its variable tree.  A bfloat16 model's split ``fc`` computes in bfloat16
from float32 blocks, and its logits equal the unsharded bfloat16 model's.
Processes are spawned once, from a code string, with their inputs written
before they start.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from video_analytics_tpu.models import resnet as jax_resnet
from video_analytics_tpu.runtime.checkpoint import save_variables as jax_save
from video_analytics_tpu_torch.models import convert, resnet
from video_analytics_tpu_torch.parallel import mesh
from video_analytics_tpu_torch.runtime.checkpoint import load_variables

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD, MP = 4, 2
ROWS = 8
TOL = 1e-5
CLASSES = (6, 5)        # splits over the model axis; stays whole
WORKER_TIMEOUT_S = 240

WORKER = r"""
import json, sys
import numpy as np
import torch
import torch.nn as nn

torch.set_num_threads(1)
from video_analytics_tpu_torch.models import convert, resnet
from video_analytics_tpu_torch.models.two_stream import TwoStreamModel
from video_analytics_tpu_torch.parallel import mesh
from video_analytics_tpu_torch.runtime.checkpoint import load_variables

rank = int(sys.argv[1])
spec = json.load(open(sys.argv[2]))
mesh.init_distributed(f"127.0.0.1:{spec['port']}", spec["world"], rank, "cpu")
group = mesh.model_parallel_groups(spec["mp"])
out = {"rank": rank, "group_size": torch.distributed.get_world_size(group),
       "group_rank": torch.distributed.get_rank(group),
       "block": mesh.model_sharding(torch.arange(8.0), group).tolist()}
data = rank // spec["mp"]
x = np.load(spec["inputs"])
rows = slice(data * spec["rows"], (data + 1) * spec["rows"])
xs = torch.from_numpy(x["x"][rows])
for classes in spec["classes"]:
    model = resnet.resnet18(num_classes=classes)
    model.load_state_dict(convert.flax_to_torch(load_variables(
        spec["weights"][str(classes)])))
    model = mesh.shard_dense_over_model(model, group).eval()
    logits = model(xs)
    (logits * torch.from_numpy(x[f"dy{classes}"][rows])).sum().backward()
    np.savez(f"{spec['out']}/r{rank}_c{classes}.npz", logits=logits.detach(),
             **{"grad/" + n: p.grad for n, p in model.named_parameters()})
    out[f"fc{classes}"] = [type(model.fc).__name__,
                           list(model.fc.weight.shape)]
bf = resnet.resnet18(num_classes=spec["classes"][0], dtype=torch.bfloat16)
bf.load_state_dict(convert.flax_to_torch(load_variables(
    spec["weights"][str(spec["classes"][0])])))
bf = mesh.shard_dense_over_model(bf, group).eval()
with torch.no_grad():
    np.save(f"{spec['out']}/r{rank}_bf16.npy", bf(xs).numpy())
out["fc_bf16"] = [type(bf.fc).__name__, str(bf.fc.dtype),
                  str(bf.fc.weight.dtype)]
two = mesh.shard_dense_over_model(
    TwoStreamModel.create(num_classes=4, flow_stack=1, width=8), group)
try:
    two.flax_variables()
except ValueError as e:
    out["refused"] = "split over the model axis" in str(e)
mesh.shutdown()
print(json.dumps(out), flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def axis(tmp_path_factory):
    """Spawn the four processes on inputs written first; meanwhile the
    JAX package's unsharded logits and the port's unsharded gradients."""
    work = str(tmp_path_factory.mktemp("model_axis"))
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (ROWS, 32, 32, 3)).astype(np.float32)
    inputs = {"x": x}
    weights = {}
    for c in CLASSES:
        inputs[f"dy{c}"] = rng.normal(0, 1, (ROWS, c)).astype(np.float32)
        jm = jax_resnet.resnet18(num_classes=c)
        v = jax.tree_util.tree_map(np.asarray, jax_resnet.init_resnet(
            jm, jax.random.PRNGKey(0), input_hw=(32, 32)))
        weights[c] = (jm, v, os.path.join(work, f"w{c}.msgpack"))
        jax_save(weights[c][2], v)
    np.savez(os.path.join(work, "inputs.npz"), **inputs)
    out = os.path.join(work, "out")
    os.makedirs(out)
    spec = os.path.join(work, "spec.json")
    with open(spec, "w") as f:
        json.dump({"port": _free_port(), "world": WORLD, "mp": MP,
                   "rows": ROWS // (WORLD // MP), "classes": list(CLASSES),
                   "inputs": os.path.join(work, "inputs.npz"), "out": out,
                   "weights": {str(c): w[2] for c, w in weights.items()}}, f)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), spec], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(WORLD)]
    try:
        ref = {}
        for c, (jm, v, path) in weights.items():
            logits = np.asarray(jm.apply(v, x, train=False))
            model = resnet.resnet18(num_classes=c)
            model.load_state_dict(convert.flax_to_torch(load_variables(path)))
            model.eval()
            grads = []
            for d in range(WORLD // MP):
                rows = slice(d * ROWS // 2, (d + 1) * ROWS // 2)
                model.zero_grad()
                (model(torch.from_numpy(x[rows]))
                 * torch.from_numpy(inputs[f"dy{c}"][rows])).sum().backward()
                grads.append({n: p.grad.clone()
                              for n, p in model.named_parameters()})
            ref[c] = (logits, grads)
        outs = [p.communicate(timeout=WORKER_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {r}: {err[-3000:]}"
    lines = [json.loads(o.strip().splitlines()[-1]) for o, _ in outs]
    return {"lines": lines, "ref": ref, "out": out}


def test_groups_and_blocks(axis):
    for r, line in enumerate(axis["lines"]):
        assert line["group_size"] == MP and line["group_rank"] == r % MP
        assert line["block"] == [float(i) for i in range(
            4 * (r % MP), 4 * (r % MP) + 4)]
    with pytest.raises(ValueError, match="not divisible"):
        mesh.model_parallel_groups(2)           # one process
    assert mesh.model_parallel_groups(1) is None
    assert torch.equal(mesh.model_sharding(torch.arange(3.0), None),
                       torch.arange(3.0))


@pytest.mark.parametrize("classes", CLASSES)
def test_fc_split_only_where_it_divides(axis, classes):
    want = (["ColumnParallelLinear", [classes // MP, 512]]
            if classes % MP == 0 else ["Linear", [classes, 512]])
    assert all(line[f"fc{classes}"] == want for line in axis["lines"])


@pytest.mark.parametrize("classes", CLASSES)
def test_logits_match_the_unsharded_reference(axis, classes):
    logits, _ = axis["ref"][classes]
    for r in range(WORLD):
        d = r // MP
        got = np.load(os.path.join(axis["out"], f"r{r}_c{classes}.npz"))
        np.testing.assert_allclose(got["logits"],
                                   logits[d * 4:(d + 1) * 4], atol=TOL,
                                   rtol=0)


@pytest.mark.parametrize("classes", CLASSES)
def test_gradients_match_the_unsharded_model(axis, classes):
    _, grads = axis["ref"][classes]
    split = classes % MP == 0
    for r in range(WORLD):
        want = grads[r // MP]
        got = np.load(os.path.join(axis["out"], f"r{r}_c{classes}.npz"))
        assert sorted(k[len("grad/"):] for k in got.files
                      if k.startswith("grad/")) == sorted(want)
        for name, g in want.items():
            g = g.numpy()
            if split and name.startswith("fc."):
                block = classes // MP
                g = g[(r % MP) * block:(r % MP + 1) * block]
            scale = max(1.0, float(np.abs(g).max()))
            np.testing.assert_allclose(got["grad/" + name], g,
                                       atol=TOL * scale, rtol=0,
                                       err_msg=f"rank {r} {name}")


def test_sharded_model_refuses_its_variable_tree(axis):
    assert all(line["refused"] for line in axis["lines"])


def test_bf16_fc_stays_bf16_over_the_model_axis(axis):
    """``shard_dense_over_model`` keeps a bfloat16 ``fc``'s dtype: the
    block computes in bfloat16 (its logits are bfloat16 values) and equals
    the unsharded bfloat16 model's within 1e-2 of the largest logit."""
    c = CLASSES[0]
    model = resnet.resnet18(num_classes=c, dtype=torch.bfloat16)
    model.load_state_dict(convert.flax_to_torch(load_variables(
        os.path.join(os.path.dirname(axis["out"]), f"w{c}.msgpack"))))
    x = np.load(os.path.join(os.path.dirname(axis["out"]), "inputs.npz"))["x"]
    for r, line in enumerate(axis["lines"]):
        assert line["fc_bf16"] == ["ColumnParallelLinear", "torch.bfloat16",
                                   "torch.float32"]
        d = r // MP
        got = torch.from_numpy(np.load(os.path.join(axis["out"],
                                                    f"r{r}_bf16.npy")))
        assert torch.equal(got, got.bfloat16().float())
        with torch.no_grad():
            want = model.eval()(torch.from_numpy(x[d * 4:(d + 1) * 4]))
        assert float((got - want).abs().max()) <= 1e-2 * float(
            want.abs().max())
