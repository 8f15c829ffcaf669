"""The port's processes and collectives (``parallel/mesh``) on the CPU,
held against the JAX package.

- ``process_local_records``, ``global_batch_size`` and ``pad_to_multiple``
  against ``video_analytics_tpu.parallel.mesh`` on the same inputs.
- Two processes joined in a gloo group (``WORKER``, spawned twice), with
  the data built once here before they start:
  - ``eval-ucf101 --batched --coordinator ... --num-processes 2`` on the
    reference's pod protocol (``tests/test_parallel.py``'s
    ``test_multiprocess_pod_eval``: a synthetic UCF101 of 2 classes × 3
    clips of 14 frames at 64×80, Farneback with no pyramid and one
    iteration, width 16, 2 clips a batch, weights from JAX's
    ``PRNGKey(0)``): every process's counts equal the JAX package's
    single-process ``evaluate_batched``; a truncated clip is named only by
    the process whose shard holds it; a process whose whole shard is
    undecodable makes both exit non-zero;
  - one SGD step per stream, each process on 4 rows, against the JAX
    package's step on all 8 (BatchNorm over the global batch), and the
    same step with per-process statistics, which the comparison must
    refuse;
  - ``train --coordinator ... --num-processes 2 --steps 2`` against one
    process stepping on the same global batches.
"""

import json
import os
import shutil
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from video_analytics_tpu.parallel import mesh as jax_mesh
from video_analytics_tpu_torch.parallel import mesh

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
WORKER_TIMEOUT_S = 240

# The eval protocol of the reference's pod test.
EVAL_MODEL = ["--num-classes", "2", "--width", "16", "--flow-stack", "5",
              "--resize-short", "64", "--crop", "56", "--window", "6",
              "--algo", "farneback", "--fb-levels", "0",
              "--fb-iterations", "1", "--device", "cpu"]
# The train step: that of tests/test_torch_train.py (3 classes, width 16,
# crop 32, flow_stack 5), at a global batch of 8.
STEP_CLASSES, STEP_STACK, STEP_WIDTH, STEP_BATCH, STEP_LR = 3, 5, 16, 8, 0.05
# The train command: the eval protocol's model, 4 windows a step.
TRAIN_ARGS = EVAL_MODEL[:-2] + [
    "--batch", "4", "--steps", "2", "--lr", "0.01", "--max-frames", "14",
    "--num-workers", "1", "--seed", "0", "--log-every", "1",
    "--stream", "both", "--device", "cpu"]

WORKER = r"""
import contextlib, io, json, sys
import numpy as np
import torch

torch.set_num_threads(1)
from video_analytics_tpu_torch.cli.main import main
from video_analytics_tpu_torch.models import resnet
from video_analytics_tpu_torch.models.two_stream import TwoStreamModel
from video_analytics_tpu_torch.parallel import mesh
from video_analytics_tpu_torch.runtime import train_two_stream as tts
from video_analytics_tpu_torch.runtime.checkpoint import load_variables

rank = int(sys.argv[1])
spec = json.load(open(sys.argv[2]))
world = spec["world"]


def group(port):
    return ["--coordinator", f"127.0.0.1:{port}", "--num-processes",
            str(world), "--process-id", str(rank)]


def cli(tag, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    print(tag, rc, out.getvalue().strip().splitlines()[-1], flush=True)


# 1. eval-ucf101 --batched over the group, the clean list and the list
#    with a truncated clip in process 0's shard.
for case in ("clean", "truncated"):
    cli("EVAL_" + case, spec["eval_" + case] + group(spec["ports"][case]))

# 2. One step per stream on this process's rows, with the BatchNorms over
#    the global batch, then with each process's own statistics.
x = np.load(spec["step_inputs"])
rows = slice(rank * len(x["y"]) // world, (rank + 1) * len(x["y"]) // world)
mesh.init_distributed(f"127.0.0.1:{spec['ports']['step']}", world, rank,
                      "cpu")
for control in (False, True):
    if control:
        resnet.process_count = lambda: 1
    model = TwoStreamModel.create(num_classes=spec["step_classes"],
                                  flow_stack=spec["step_stack"],
                                  width=spec["step_width"])
    model.load_flax_variables(load_variables(spec["step_weights"],
                                             model.flax_variables()))
    steps = tts.make_two_stream_train_steps(
        tts.create_two_stream_states(model, spec["step_lr"], "both"))
    metrics = {k: {m: float(v) for m, v in step(
        torch.from_numpy(x[k][rows]), torch.from_numpy(x["y"][rows])).items()}
        for k, step in steps.items()}
    tag = "per_process" if control else "global"
    np.savez(f"{spec['out']}/step_{tag}_{rank}.npz",
             **{"state/" + k: v.numpy()
                for k, v in model.state_dict().items()},
             **{f"flax{k}": v for k, v in spec_leaves(
                 tts.two_stream_variables(model))})
    print("STEP_" + tag, json.dumps(metrics), flush=True)
resnet.process_count = mesh.process_count
mesh.shutdown()

# 3. The train command over the group.
cli("TRAIN", spec["train"] + group(spec["ports"]["train"]))

# 4. A list whose odd entries, process 1's shard, are all truncated: both
#    processes raise.
sys.exit(main(spec["eval_undecodable"] + group(spec["ports"]["undecodable"])))
"""
# The flat leaves of a variable tree, keyed by their paths.
LEAVES = r"""
def spec_leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from spec_leaves(tree[k], f"{path}/{k}")
    else:
        yield path, np.asarray(tree)
"""


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, np.asarray(tree)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# -- the mesh helpers against the JAX functions -------------------------------

@pytest.mark.parametrize("world", [1, 2, 3, 4])
@pytest.mark.parametrize("n", [0, 1, 3, 5, 8, 11])
def test_process_local_records_matches_reference(world, n):
    records = [f"clip{i}" for i in range(n)]
    shards = [mesh.process_local_records(records, r, world)
              for r in range(world)]
    assert shards == [jax_mesh.process_local_records(records, r, world)
                      for r in range(world)]
    assert sorted(sum(shards, [])) == sorted(records)
    assert max(map(len, shards)) - min(map(len, shards)) <= 1


@pytest.mark.parametrize("world", [1, 2, 3, 4])
@pytest.mark.parametrize("requested", [1, 2, 7, 8, 32, 33])
def test_global_batch_size_matches_reference(world, requested):
    """One device per process: the JAX function on a mesh of `world`
    devices with `world` processes."""
    want = jax_mesh.global_batch_size(requested, jax_mesh.make_mesh(world),
                                      world)
    got = mesh.global_batch_size(requested, world)
    assert got == want and got >= requested and got % world == 0


@pytest.mark.parametrize("n,multiple", [(5, 1), (5, 2), (5, 4), (8, 4),
                                        (1, 3), (7, 3)])
def test_pad_to_multiple_matches_reference(n, multiple, rng):
    x = rng.integers(0, 255, (n, 3, 2)).astype(np.uint8)
    got, n_got = mesh.pad_to_multiple(x, multiple)
    want, n_want = jax_mesh.pad_to_multiple(x, multiple)
    assert n_got == n_want == n and np.array_equal(got, want)
    assert got.dtype == x.dtype and len(got) % multiple == 0


def test_without_a_group_every_collective_is_the_identity():
    assert mesh.process_index() == 0 and mesh.process_count() == 1
    assert mesh.process_local_records([1, 2, 3]) == [1, 2, 3]
    assert mesh.global_batch_size(7) == 7
    t = torch.arange(4.0, requires_grad=True)
    assert mesh.all_reduce_sum(t) is t and mesh.global_mean(t) is t
    lin = torch.nn.Linear(3, 2)
    lin(torch.ones(1, 3)).sum().backward()
    grads = [p.grad.clone() for p in lin.parameters()]
    mesh.average_gradients(lin.parameters())
    mesh.broadcast_from_first(lin.state_dict().values())
    assert all(torch.equal(g, p.grad) for g, p in zip(grads,
                                                      lin.parameters()))
    with pytest.raises(ValueError, match="outside"):
        mesh.init_distributed("127.0.0.1:1", 2, 2, "cpu")
    with pytest.raises(ValueError, match="--num-processes"):
        mesh.init_distributed("127.0.0.1:1", None, 0, "cpu")


# -- two processes -----------------------------------------------------------

def _jax_cfg():
    from video_analytics_tpu.config import (
        FarnebackConfig, PipelineConfig, PreprocessConfig)
    return PipelineConfig(
        flow_algo="farneback",
        farneback=FarnebackConfig(levels=0, iterations=1), window=6,
        preprocess=PreprocessConfig(resize_short=64, crop=56, flow_stack=5))


def _annotations(src: str, dst: str, test_lines) -> str:
    """A copy of the annotations directory `src` whose test list holds
    `test_lines`."""
    shutil.copytree(src, dst)
    with open(os.path.join(dst, "testlist01.txt"), "w") as f:
        f.write("".join(line + "\n" for line in test_lines))
    return dst


def _step_inputs(rng):
    return {"rgb": rng.normal(0, 1, (STEP_BATCH, 32, 32, 3)).astype(
                np.float32),
            "flow": rng.uniform(-1, 1, (STEP_BATCH, 32, 32, 2 * STEP_STACK)
                                ).astype(np.float32),
            "y": rng.integers(0, STEP_CLASSES, STEP_BATCH).astype(np.int64)}


def _reference_step(variables, x):
    """The JAX package's step on all STEP_BATCH rows: per stream (metrics,
    the flat state after it)."""
    from video_analytics_tpu.models.two_stream import TwoStreamModel as JaxTS
    from video_analytics_tpu.runtime import train_two_stream as jtts
    jm = JaxTS.create(num_classes=STEP_CLASSES, flow_stack=STEP_STACK,
                      width=STEP_WIDTH)
    tx = optax.sgd(STEP_LR, momentum=0.9)
    states = jtts.create_two_stream_states(jm, variables, tx, "both")
    steps = jtts.make_two_stream_train_steps(jm, tx, "both")
    out = {}
    for name, step in steps.items():
        state, metrics = step(states[name], jnp.asarray(x[name]),
                              jnp.asarray(x["y"].astype(np.int32)))
        out[name] = ({k: float(v) for k, v in metrics.items()},
                     dict(_leaves(jax.tree_util.tree_map(np.asarray, {
                         "params": state.params,
                         "batch_stats": state.batch_stats}))))
    return out


def _one_process_train(ds):
    """The train command's two processes' global batches, stepped in one
    process: each process's sampler (one decode worker: its batches depend
    on the seed alone) on its shard, the batches laid end to end, the
    crops drawn for the global batch from the seed.  Final losses."""
    from video_analytics_tpu_torch.config import (
        FarnebackConfig, PipelineConfig, PreprocessConfig)
    from video_analytics_tpu_torch.ingest.train_loader import (
        TrainWindowSampler)
    from video_analytics_tpu_torch.models.two_stream import TwoStreamModel
    from video_analytics_tpu_torch.runtime import train_two_stream as tts

    cfg = PipelineConfig(
        flow_algo="farneback", num_classes=2, window=6,
        farneback=FarnebackConfig(levels=0, iterations=1),
        preprocess=PreprocessConfig(resize_short=64, crop=56, flow_stack=5,
                                    random_crop=True, random_flip=True))
    per_rank = []
    for r in range(WORLD):
        sampler = TrainWindowSampler(
            mesh.process_local_records(ds.train_records(), r, WORLD),
            window=tts.train_window_len(cfg), batch=4 // WORLD, seed=0,
            max_frames=14, num_workers=1)
        try:
            it = sampler.batches()
            per_rank.append([next(it) for _ in range(2)])
        finally:
            sampler.stop()
    feed = [tuple(torch.from_numpy(np.concatenate([b[i][k] for b in per_rank]))
                  for k in range(2)) for i in range(2)]
    model = TwoStreamModel.create(num_classes=2, flow_stack=5, width=16)
    model.init(torch.Generator().manual_seed(0))
    steps = tts.make_two_stream_train_steps(
        tts.create_two_stream_states(model, 0.01, "both"))
    for metrics in tts.train_iter(feed, steps, cfg, "both",
                                  torch.Generator().manual_seed(0)):
        pass
    return {k: float(m["loss"]) for k, m in metrics.items()}


@pytest.fixture(scope="module")
def pod(tmp_path_factory):
    """Spawn the two WORKER processes on data built here first, compute
    the JAX package's answers while they run, and return both."""
    from video_analytics_tpu.io.synthetic import build_synthetic_ucf101
    from video_analytics_tpu.models.two_stream import TwoStreamModel as JaxTS
    from video_analytics_tpu.runtime.checkpoint import (
        save_variables as jax_save)
    from video_analytics_tpu.runtime.evaluate import evaluate_batched

    work = str(tmp_path_factory.mktemp("pod"))
    ds = build_synthetic_ucf101(os.path.join(work, "ucf"), num_classes=2,
                                clips_per_class=3, num_frames=14, h=64, w=80,
                                train_fraction=0.34)
    records = ds.test_records()
    assert len(records) == 4
    rel = [os.path.relpath(r.path, ds.videos_root) for r in records]
    bad = []
    for i in range(2):      # truncated containers
        bad.append(os.path.join(os.path.dirname(rel[i]),
                                f"v_trunc_g9{i}_c01.avi"))
        with open(records[i].path, "rb") as f, \
                open(os.path.join(ds.videos_root, bad[-1]), "wb") as g:
            g.write(f.read(256))
    anns = {"clean": ds.annotations_root,
            # 5 records: the truncated one is the 5th, process 0's.
            "truncated": _annotations(ds.annotations_root,
                                      os.path.join(work, "ann_truncated"),
                                      rel + bad[:1]),
            # Process 1's shard (the odd entries) is all truncated.
            "undecodable": _annotations(
                ds.annotations_root, os.path.join(work, "ann_undecodable"),
                [rel[0], bad[0], rel[1], bad[1]])}
    jm = JaxTS.create(num_classes=2, flow_stack=5, width=16)
    eval_vars = jax.tree_util.tree_map(
        np.asarray, jm.init_variables(jax.random.PRNGKey(0)))
    ckpt = os.path.join(work, "two_stream.msgpack")
    jax_save(ckpt, eval_vars)
    step_vars = jax.tree_util.tree_map(np.asarray, JaxTS.create(
        num_classes=STEP_CLASSES, flow_stack=STEP_STACK,
        width=STEP_WIDTH).init_variables(jax.random.PRNGKey(0),
                                         input_hw=(32, 32)))
    step_ckpt = os.path.join(work, "step.msgpack")
    jax_save(step_ckpt, step_vars)
    x = _step_inputs(np.random.default_rng(4))
    np.savez(os.path.join(work, "step_inputs.npz"), **x)
    out = os.path.join(work, "out")
    os.makedirs(out)

    def eval_argv(case):
        return ["eval-ucf101", "--videos", ds.videos_root, "--annotations",
                anns[case], "--checkpoint", ckpt, "--batched",
                "--batch-clips", "2", *EVAL_MODEL]

    spec = {"world": WORLD, "out": out,
            "ports": {k: _free_port() for k in (
                "clean", "truncated", "step", "train", "undecodable")},
            **{f"eval_{c}": eval_argv(c) for c in anns},
            "step_inputs": os.path.join(work, "step_inputs.npz"),
            "step_weights": step_ckpt, "step_classes": STEP_CLASSES,
            "step_stack": STEP_STACK, "step_width": STEP_WIDTH,
            "step_lr": STEP_LR,
            "train": ["train", "--videos", ds.videos_root, "--annotations",
                      ds.annotations_root, "--out",
                      os.path.join(out, "trained.msgpack"), *TRAIN_ARGS]}
    spec_path = os.path.join(work, "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen(
        [sys.executable, "-c", LEAVES + WORKER, str(r), spec_path], cwd=REPO,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(WORLD)]
    try:
        ref = {}
        cfg = _jax_cfg()
        for case in ("clean", "truncated"):
            from video_analytics_tpu.io.dataset import UCF101
            recs = UCF101(videos_root=ds.videos_root,
                          annotations_root=anns[case]).test_records()
            ref[case] = evaluate_batched(recs, eval_vars, jm, cfg,
                                         batch_clips=2, num_workers=1,
                                         host_resize=True)
        ref_step = _reference_step(step_vars, x)
        one_process = _one_process_train(ds)
        outs = [p.communicate(timeout=WORKER_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    lines = []
    for rank, (stdout, _) in enumerate(outs):
        tagged = {}
        for line in stdout.splitlines():
            tag, _, rest = line.partition(" ")
            tagged[tag] = rest
        lines.append(tagged)
    return {"procs": procs, "outs": outs, "lines": lines, "ref": ref,
            "ref_step": ref_step, "step_vars": step_vars, "out": out,
            "bad": [os.path.join(ds.videos_root, b) for b in bad],
            "one_process": one_process,
            "checkpoint": os.path.join(out, "trained.msgpack")}


def _tagged(pod, tag):
    """Each process's (exit code, JSON) of a tagged command line."""
    got = []
    for rank, lines in enumerate(pod["lines"]):
        assert tag in lines, (tag, pod["outs"][rank])
        rc, _, text = lines[tag].partition(" ")
        got.append((int(rc), json.loads(text)))
    return got


def test_pod_eval_matches_reference_on_every_process(pod):
    ref = pod["ref"]["clean"]
    assert ref.total == 4 and ref.failed == 0
    for rc, res in _tagged(pod, "EVAL_clean"):
        assert rc == 0
        assert (res["total"], res["correct"], res["failed"]) == (
            ref.total, ref.correct, ref.failed), res


def test_pod_eval_failure_is_local_to_its_process(pod):
    ref = pod["ref"]["truncated"]
    assert ref.total == 4 and ref.failed == 1
    got = _tagged(pod, "EVAL_truncated")
    for rank, (rc, res) in enumerate(got):
        assert rc == 0
        assert (res["total"], res["correct"]) == (ref.total, ref.correct)
        want = [pod["bad"][0]] if rank == 0 else []
        assert [f["path"] for f in res["failures"]] == want, res
        assert res["failed"] == len(want)
    assert sum(res["failed"] for _, res in got) == ref.failed


def test_pod_eval_undecodable_shard_fails_every_process(pod):
    for rank, p in enumerate(pod["procs"]):
        stderr = pod["outs"][rank][1]
        assert p.returncode not in (0, None), stderr
        assert "RuntimeError" in stderr and "decoded no clip" in stderr, (
            rank, stderr[-2000:])


def _step_matches(metrics, flat, before, ref):
    """The comparison of tests/test_torch_train.py: per stream the loss to
    1e-5 relative, the accuracy exactly, each update to 1e-3 of its
    largest element, each BatchNorm statistic to 1e-4 relative.  Returns
    (ok, the first difference)."""
    key = {"rgb": "/spatial", "flow": "/temporal"}
    for name, (want, theirs) in ref.items():
        got = metrics[name]
        if abs(got["loss"] - want["loss"]) > 1e-5 * abs(want["loss"]):
            return False, (name, "loss", got["loss"], want["loss"])
        if got["accuracy"] != want["accuracy"]:
            return False, (name, "accuracy", got, want)
        for path, w in theirs.items():
            ours = flat["flax" + key[name] + path]
            if path.startswith("/batch_stats"):
                if not np.allclose(ours, w, rtol=1e-4, atol=1e-6):
                    return False, (name, path)
            else:
                update = np.abs(w - before[key[name] + path]).max()
                if not (update > 0 and np.abs(ours - w).max()
                        <= 1e-3 * update):
                    return False, (name, path, update)
    return True, None


def test_pod_train_step_matches_reference_global_batch(pod):
    """Two processes × 4 rows against the JAX package's step on the 8 rows,
    within tests/test_torch_train.py's tolerances; the processes' weights,
    statistics and counters bit-equal; and the same step with each
    process's own BatchNorm statistics fails the comparison."""
    before = dict(_leaves(pod["step_vars"]))
    results = {}
    for tag in ("global", "per_process"):
        flats = [dict(np.load(os.path.join(pod["out"],
                                           f"step_{tag}_{r}.npz")))
                 for r in range(WORLD)]
        metrics = [json.loads(lines["STEP_" + tag])
                   for lines in pod["lines"]]
        assert metrics[0] == metrics[1] and flats[0].keys() == flats[1].keys()
        if tag == "global":
            for k in flats[0]:
                assert np.array_equal(flats[0][k], flats[1][k]), k
        results[tag] = _step_matches(metrics[0], flats[0], before,
                                     pod["ref_step"])
    assert results["global"] == (True, None), results["global"]
    assert results["per_process"][0] is False


def test_pod_train_command_matches_one_process(pod):
    """Both processes print the same final losses; they equal one process's
    steps on the same global batches within 2e-4 relative (the tolerance
    of the reference's pod test); process 0's checkpoint reads in both
    packages."""
    from video_analytics_tpu.models.two_stream import TwoStreamModel as JaxTS
    from video_analytics_tpu.runtime.checkpoint import (
        load_variables as jax_load)
    from video_analytics_tpu_torch.models.two_stream import TwoStreamModel
    from video_analytics_tpu_torch.runtime.checkpoint import load_variables

    got = _tagged(pod, "TRAIN")
    losses = []
    for rc, res in got:
        assert rc == 0 and res["steps"] == 2, res
        losses.append({k: res[f"final_loss_{k}"] for k in ("rgb", "flow")})
    assert losses[0] == losses[1]
    for k, want in pod["one_process"].items():
        assert losses[0][k] == pytest.approx(want, rel=2e-4), (
            k, losses, pod["one_process"])
    path = pod["checkpoint"]
    assert [f for f in os.listdir(pod["out"]) if f.endswith(".msgpack")] == [
        "trained.msgpack"]
    model = TwoStreamModel.create(num_classes=2, flow_stack=5, width=16)
    ours = load_variables(path, model.flax_variables())
    jm = JaxTS.create(num_classes=2, flow_stack=5, width=16)
    theirs = jax_load(path, jm.init_variables(jax.random.PRNGKey(1)))
    a, b = dict(_leaves(ours)), dict(_leaves(
        jax.tree_util.tree_map(np.asarray, theirs)))
    assert a.keys() == b.keys()
    assert all(np.array_equal(a[k], b[k]) for k in a)
    # The checkpoint holds the trained weights, not the initial ones.
    init = dict(_leaves(model.init(torch.Generator().manual_seed(0))
                        .flax_variables()))
    assert any(not np.array_equal(a[k], init[k]) for k in a)


def test_eval_coordinator_needs_batched(capsys):
    from video_analytics_tpu_torch.cli.main import main
    rc = main(["eval-ucf101", "--videos", "v", "--annotations", "a",
               "--coordinator", "127.0.0.1:1", "--num-processes", "2",
               "--process-id", "0", "--device", "cpu"])
    assert rc == 2 and "--batched" in capsys.readouterr().err
