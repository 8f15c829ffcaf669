#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It imports no JAX, and fails (non-zero exit, no result line) where
``torch.cuda.is_available()`` is false or the package is not beside it.
OpenCV is needed by the phases that drive the command line (7, 9-12, 19)
by the flow-quality families (20), by the breakdown's clips (21) and by
the roofline's frames (22), as by the commands themselves.
Phases, each reported on a JSON line:

1. build: compile every CUDA kernel of the port from
   ``video_analytics_tpu_torch/csrc/`` with nvcc for sm_90a (one nvcc per
   source, all started together);
2. kernels: call each kernel's wrapper at the serve path's shapes (15
   frame pairs at the five pyramid sizes of a 224² crop) and hold it
   against its plain PyTorch version on the same inputs, with the
   tolerance stated; time both with CUDA events; tvl1_warp_kernel: K-H
   ``tvl1_scale`` (``pd_solve_scale``: every warp of a scale with its
   prep, and the scale-end median, in one launch, an image per
   thread-block cluster of 8 blocks, or of 16 where the strips need it:
   240×320 and 280×300) at those sizes and five others, its shared
   memory a block (``va_pd_scale_smem``) against ``strip_geometry`` at
   1, 2, 4, 8 and 16 blocks, with ``cudaOccupancyMaxActiveClusters`` at
   each and the size it takes at 15 and 120 pairs; one warp against the
   plain prep, solve and median at ε = 0 (bit for bit, at medians 5, 3
   and none), with ε engaged and with every image stopping in round 1;
   the whole scale against the chain K-A → K-B per warp → K-C and
   against its plain version (bit for bit at ε = 0, within 10·ε a warp
   with ε engaged), the launch and the chain timed in turns, and forced
   to each cluster size that fits (bit for bit against the plain version
   at ε = 0, the size rule's rounds with ε engaged; ``va_pd_scale``
   refusing sizes that do not fit); check that an image
   stops on its own ε test (an easy pair's flow is the same alone and
   batched with a hard pair);
3. serve: build ``ClipServer`` at full width (two ResNet-18s of width 64,
   101 classes, 16-frame windows, ``TVL1Config()``) from seed 0, warm it
   up, answer a ping and three classify requests on seeded frames, with
   every kernel's launch counter reset just before the requests and held
   to the expected numbers after them (5 ``tvl1_scale`` per request, one
   per pyramid scale, and none of K-A, K-C or the per-iteration
   kernels; 40 launches of the fused norm pass, 16 with a residual,
   ``BN_PER_CLASSIFY``); hold the fused probabilities against the same
   window run through the plain versions;
4. profile: where one request's time goes.  Stage times on the host
   clock with a sync after each stage, then one request under
   ``torch.profiler``: device time per kernel name (every kernel of the
   port, with its duration per launch), the sum and the union of all
   device intervals, and that union's share of the profiled request and
   of an unprofiled one;
5. farneback_kernels: K-D ``fb_prologue``, K-E ``fb_warp_neq``, K-F
   ``sep_corr`` (both axes, with and without the solve epilogue, box and
   Gaussian taps), ``fb_window_solve`` (both window passes and the solve
   in one launch, also against the two launches of K-F) and
   ``fb_iteration`` (the same launch with K-E as its loader, also against
   K-E then ``fb_window_solve``) against their plain versions at the
   three pyramid sizes of the serve path (56², 112², 224²; 16 frames, 15
   pairs) and of a native 240×320 clip (60×80, 120×160, 240×320), timed
   with CUDA events and, at the finest levels, by their device durations;
   at the native sizes also at the pair form's batches, as ``compute-flow
   --batch 8`` calls them (8 and 7 pairs, the prologue over 16 and 14
   frames); one whole level (3 iterations) at each of these shapes and
   one whole ``farneback_sequence`` against ``plain=True``; the sequence
   timed with an iteration as three launches, two and one;
6. farneback_serve: phase 3 with ``flow_algo="farneback"``: three
   requests, launch counts per request held to the expected numbers (3
   K-D, 9 ``fb_iteration``, none of K-E, K-F or ``fb_window_solve``), the
   fused probabilities against the plain versions', the mean recovered
   flow against the scene's (1.3, −0.7), and phase 4's profile of one
   request;
7. compute_flow: ``tpuva-torch compute-flow --algo farneback --format
   flo --no-bucket`` (the native resolution, as every ``compute-flow`` of
   phases 7-9 and 13; phase 19 runs the default) on a 16-frame 240×320
   frames directory written to a temporary
   directory, with the launch counts of the Farneback kernels set to 0
   just before the command and held to the expected numbers just after;
   15 ``.flo`` files, one read back; farneback_1080p: the same command on
   3 frames of 1080×1920 with ``--fb-levels 4`` (its 1/16 level pre-blurs
   with 39 taps: K-D in two launches, the blur pass ``fb_prologue_blur``
   first), with ``--fb-winsize 33`` and with ``--fb-winsize 201`` (K-E and
   ``sep_corr`` along y and along x with the solve at every iteration),
   counts held to the expected numbers and every ``.flo`` equal to the
   plain path's flow; K-D at 39 and 79 taps and the three window routes
   (33, 75, 201 and 1,401 taps: ``fb_iteration``; K-E +
   ``fb_window_solve``; K-E + ``sep_corr`` twice) against their plain
   versions; ``sep_corr`` at 201 taps at the 1/8 level and at 1080×1920
   (2 pairs), both passes equal to their plain versions, timed beside the
   plain versions and one ``nn.Conv2d`` (replicate padding, TF32 off);
8. tvl1_chunk_kernels: K-G ``pd_chunk`` (several primal-dual iterations
   per launch on shared-memory tiles) against its plain version at the
   five TV-L1 level sizes of a 1080×1920 frame (2 pairs), with and without
   the round-opening median, at a full and a remainder chunk, with all
   bands active and with some frozen: the state bit for bit, the band
   error sums to 1e-5 relative; one whole warp through
   ``pd_solve_chunked`` against the per-iteration ``pd_solve`` (bit for
   bit at ε = 0, within 10·ε with the gates engaged), both timed; a
   round's last ``pd_chunk`` launch, which ends with the bands'
   convergence test, against ``pd_chunk_plain`` and ``band_flags_plain``
   run on the partials it wrote (three images: bands and images on both
   sides of the thresholds, frozen bands and a frozen image, with and
   without ``prev_act``; and 65,535 images of 8×8), timed with and without
   the test; tvl1_midsize:
   ``compute-flow --algo tvl1`` on 3 frames of 280×300 and of 240×320,
   whose finest levels are under the size rule and fit only a 16-block
   cluster: 5 launches of ``tvl1_scale`` each and none of K-A, K-B or K-C
   (counted), the flow at ε = 0 equal to the plain path's, a flow call
   timed; then a 20×4000 pair, whose finest level fits no cluster,
   through K-A, K-B (a round's last step with the ε test) and K-C, no
   other launch (counted), equal to the plain path at ε = 0;
9. tvl1_1080p: ``tpuva-torch compute-flow --algo tvl1`` with
   ``TVL1Config()`` on a frames directory of 11 frames of 1080×1920 (10
   pairs, ``--batch 8``), the launch counts of the TV-L1 kernels set to 0
   just before and held to the expected numbers just after (K-G on every
   level, the last of a round but a warp's last ending with the bands'
   test, the per-iteration kernels not at all); the first pair's flow
   against the plain path's and the scene's motion; one flow call of 2
   pairs held to 1,250 K-G launches (225 with the test), 25 K-A and 5
   K-C and nothing else, by the counts and by the port kernels its
   profile shows, timed and profiled; K-C at the five levels of that call
   (2 pairs, ties and zeros of both signs) equal to its plain version,
   timed beside it with its bound;
10. stage_chain: a checkpoint written from seed 0 and read back, then
   ``extract-features`` on the flow directory of phase 9 and on its
   frames, and ``classify-clip --checkpoint ... --windows 3`` on a 1080p
   clip, at full width; features and probabilities against the same steps
   taken on tensors with the kernels' plain versions;
11. eval_ucf101: a synthetic UCF101 (``io/synthetic.py``: 4 classes x 4
   clips of 48 frames at 240x320, 8 of them test clips, and a truncated
   ``.avi`` added to the test list) and a full-width checkpoint from seed
   0, then ``tpuva-torch eval-ucf101`` four ways, the launch counts set to
   0 just before each and held to the expected numbers just after (with
   the fused norm pass's ``BN_PER_CLASSIFY`` a classify call):
   ``--batched --batch-clips 8`` (one batch, 120 frame pairs in one
   ``tvl1`` call: 5 ``tvl1_scale``, nothing else; twice, the second
   without the first calls at its shapes), with ``--windows 3``
   (360 pairs, 5 launches), clip by clip with ``--predictions`` and
   ``--manifest`` (5 a clip; the predictions and counts equal the first
   run's) and again on that manifest (nothing evaluated, no launch), and
   ``--batched --algo farneback`` (3 K-D, 9 ``fb_iteration``); the corrupt
   clip counted as failed and named each time; a batch of the first run
   and of the Farneback run through the batch function with the kernels
   and with their plain versions (1e-6); clips/s of each run (host clock,
   decode included) and the device time of the ``tvl1_scale`` launches of
   the 120- and 360-pair calls (torch.profiler);
12. train: ``train`` at full width (two ResNet-18s of width 64, crop 224,
   ``flow_stack`` 10, batch 32, ``TVL1Config()``): ``build_examples`` on
   32 in-memory 11-frame windows of 240x320 through the kernels and their
   plain versions with the same crops (equal; 5 ``tvl1_scale`` launches,
   or 3 K-D and 9 ``fb_iteration`` with Farneback, and nothing else); one
   two-stream step on the card and on the CPU from the same weights and
   examples (loss and accuracy within the printed tolerance; the last
   BatchNorms' running variance against the biased-variance rule); the
   command's loop (sampler, ``DevicePrefetcher``, ``train_iter``) with a
   ``StageTimer`` (host wait, ``build_examples`` and its flow call, each
   stream's step; ms per step from CUDA events; every prefetched batch
   equal to its host batch; a step's device-busy share; peak memory); then
   ``tpuva-torch train --stream both --steps 6``, decoding every window,
   then with ``--cache-dir`` twice (filling it, then from it: no decode)
   and ``--stream flow --algo farneback --steps 3``, the launch counts set
   to 0 just before each and held to the expected numbers just after,
   steps/s over steps 2-6 from CUDA events; the checkpoint read by
   ``eval-ucf101 --batched`` and ``classify-clip``;
13. spynet: the learned flow on the bundled weights at full width
   (``PipelineConfig(flow_algo="spynet")``, 16-frame windows at 224²),
   which reaches no hand-written kernel (every launch count set to 0 just
   before each of its paths and held to 0 just after): 2 pairs on the card
   against the CPU; ms per pair at 224² (15 pairs) and 1080×1920 (2 pairs)
   beside the float32 operations bound; three ``ClipServer`` requests,
   one profiled, the window alone against inside a batch;
   ``compute-flow --algo spynet`` on a 1080p clip; ``eval-ucf101 --algo
   spynet`` batched against clip by clip; ``build_examples`` with SpyNet
   (320 pairs) and ``train --algo spynet`` for 3 steps; SpyNet's own
   training at 64², batch 8: one step's loss on the card against the CPU's,
   20 steps timed.  ``python3 chip_smoke.py --only spynet`` runs the build
   and this phase alone;
14. distributed: ``parallel/mesh`` (``distributed_phase``): eval-ucf101
   --batched, TV-L1 and Farneback, in a one-process NCCL group; two gloo
   processes on the card, eval and train steps; then model_axis
   (``model_axis_phase``): the full-width model's ``fc`` split over a
   model group of the two processes at 100 classes, whole at 101, the
   probabilities against one process's, the all-gathers timed;
15. warmup: the ``warmup`` command in a fresh copy of the package (its
   flow entries at the sizes' 64-pixel buckets);
16. sustained: BASELINE.json config #5, a 128-frame 1080x1920 stream
   through ``sliding_windows``, ``DevicePrefetcher`` and ``classify_batch``
   with Farneback and TV-L1, the CNN in float32 and in bfloat16, the
   flow kernels' and the fused norm pass's launches held to their
   numbers a batch (``sustained_phase``);
17. async_checkpoint: ``AsyncCheckpointer`` between full-width train
   steps against the blocking ``save_variables``, restore on the card,
   the ``.prev`` fallback, a failed write raised at ``wait()``;
18. bf16: the reference's reduced-precision CNN (``dtype=torch.bfloat16``:
   bfloat16 activations, float32 parameters) at full width on TV-L1 and
   Farneback serve requests: launches as in float32 (the fused norm
   pass's too), the answer against
   the plain versions, the CNNs against the CPU's bfloat16, the float32
   model's answer beside it, each stream's ms in both dtypes, cuDNN's
   kernels, the fc's bfloat16 reductions, one train step against the
   CPU's (``bf16_phase``);
19. compute_flow_bucketed: ``compute-flow`` with its default flags, which
   pad each pair at its edges to the next multiple of 64 and crop the flow
   back (``ops/bucketing``): Farneback and TV-L1 at 240×320 (bucket
   256×320), TV-L1 at 280×300 (320×320, its finest level on K-G) and
   1080×1920 (1088×1920), 2 pairs each, the launch counts set to 0 just
   before each command and held just after to the numbers the flow
   modules' routes give at the bucket (``expected_flow_launches``), the
   ``.flo`` files against the plain path's bucketed-then-cropped flow, the
   command and a flow call timed beside ``--no-bucket``
   (``compute_flow_bucketed_phase``);
20. flow_quality: ``tools/torch_flow_quality.py``'s shoot-out at 224², 16
   pairs a call, the default configs and the bundled SpyNet, 2 validation
   batches: EPE per family with the launches held (5 ``tvl1_scale``, or 3
   K-D and 9 ``fb_iteration``, a call; none for SpyNet), the same EPEs
   through the plain versions within 1e-6, pairs/s, the tool's table
   (``flow_quality_phase``);
21. eval_breakdown: ``tools/torch_eval_breakdown.py``'s split of batched
   evaluation at its full protocol (32 synthetic UCF101 clips of 48 frames
   at 240×320, ``PipelineConfig(flow_algo="farneback", window=16)``, the
   bfloat16 two-stream model from seed 0, batches of 8, 2 decode workers):
   decode, host preparation, the pinned copy, device time deep and single,
   end-to-end clips/s; every key of the reference's line finite, every
   pass 32 clips and no failure, the ledger adding up, and each timed
   pass's launches held to 4 batch calls of ``expected_flow_launches`` at
   224² (12 K-D, 36 ``fb_iteration``, nothing else)
   (``eval_breakdown_phase``);
22. roofline: ``tools/torch_roofline.py``'s nine programs at the
   reference's sizes (1080p included) with the bfloat16 model from seed 0:
   every key finite, every share of a peak at most 100 %, each warm call's
   launches held to ``expected_flow_launches`` (a Farneback call at 224²:
   3 K-D, 9 ``fb_iteration``; TV-L1 at 224²: 5 ``tvl1_scale``; at
   1080×1920: 1,250 K-G, 225 with the bands' test, 25 K-A, 5 K-C), the
   TV-L1 224² program's operations equal to ``scale_work`` summed over its
   5 launches for the rounds they reported, the count from the plain
   versions' rounds on the same 64 pairs and on the first 1080p pair
   within 1 % of the kernels'; the rows and the tool's table
   (``roofline_phase``).  The bounds of this script's kernel checks come
   from the tool (``bound``, ``scale_bound``, ``chunk_bound``,
   ``farneback_kernel_work``, ``cnn_work``);
23. bn_act: the fused norm pass (eval BatchNorm, the residual add, ReLU;
   ``ops/cuda/bn_act``) at R(2+1)D-34's largest activation, stage 1's
   midplanes at the benchmark's batch (16 × 144 × 32 × 56², bfloat16,
   channels-last-3d), with and without a residual: bit for bit against
   ``bn_act_plain``, timed beside its byte bound (counted here: the
   activation read and written once, the residual read once, the
   parameters), its plain version and ``nn.BatchNorm3d`` + add +
   ``torch.relu``; then eval forwards of an R(2+1)D-34 stream (16 clips
   of 32 × 112², bfloat16) and of a ResNet-18 stream (16 images of 224²,
   bfloat16 and float32), each norm site held to the module path on its
   own input (1 bfloat16 ulp, 3 with a residual; 16 float32 ulps), the
   counters ``bn_act.launches`` / ``launches_residual`` to 69 / 16 and
   20 / 8, and the logits to the same forward on the module path
   (``bn_act_phase``).
24. timesformer: a full-width bfloat16 forward of both TimeSformer-Base
   streams (``models/timesformer``; 8 frames at 224², seed-0 weights,
   101 classes) on one clip, against the float32 plain reference
   ``tests/torch_timesformer.py`` on the card (TF32 off), within
   ``TOL_TSF_LOGITS`` of the largest logit; ``TimeSformer.attn_calls``
   read (12 + 12 a stream) and ``short_attn.launches`` (12 a stream, the
   time half); the short-sequence kernel (``ops/cuda/short_attn``) at a
   batch's time-half shape (16 clips: 3136 sequences of 8 tokens at 768)
   within one bfloat16 ulp of the float64 attention and no farther than
   SDPA, timed (paced and device ms) beside its byte bound, its plain
   version, SDPA alone (``library_ms``) and the path it replaced; and the
   kernels each half launches at a batch's shapes: the time half the
   kernel and nothing that looks like SDPA's, the space half SDPA
   (``timesformer_phase``).
``--only <phase>`` runs the build and that phase alone.

Then it prints the kernel table (``{"kernels": [...]}``: for each kernel
its launches on its main path and which path that is (``launches_from``:
the serve requests; for K-A, K-C, K-G and K-G's launches with the bands'
test the ``compute-flow`` command of phase 9; for K-D's blur pass the
``--fb-levels 4`` command of farneback_1080p, for K-E and ``sep_corr``
its ``--fb-winsize 201`` command; under ``launches_eval_ucf101`` those
of phase 11's commands, under ``launches_train`` those of phase 12's,
under ``launches_distributed``, ``launches_warmup``,
``launches_sustained``, ``launches_async_checkpoint``, ``launches_bf16``,
``launches_compute_flow_bucketed``, ``launches_flow_quality``,
``launches_eval_breakdown`` and ``launches_roofline`` those of phases
14-22; the fused norm pass's two rows (``bn_act``, ``bn_act_residual``)
give its launches in the serve requests, in phases 11, 16 and 18, and
in each stream forward of phase 23;
K-B (and its launches with the ε test) and ``fb_window_solve``,
whose arithmetic the commands run inside ``tvl1_scale`` and
``fb_iteration`` or only at shapes no command here gives, are on no
command's path: 0 launches, and
under ``check_launches`` those of the phase that holds them against
their plain versions; ``sep_corr``'s two instantiations, the one-plane
correlation and the five-plane one with the solve epilogue, have a row
each, timed at 201 taps at 1080×1920, the library's convolution along
the same axis beside each), its time paced by the host's launches
(``ms``: CUDA events around 20 calls of the wrapper), its own duration on the device (``device_ms``:
the kernel's summed device time over its launches under
``torch.profiler``; where no profile recorded the kernel, CUDA events
around the same calls, and the ``profiler`` line before the kernel table
says so), its plain version's time, the time
of one PyTorch call that computes the same function where there is one,
and its bound, the least time the card could take: bytes read once and
written once over 3.35 TB/s, or float32 operations over 67 TFLOP/s,
whichever is larger), the card's
``name, power.limit`` as nvidia-smi reports them, and, last, the result
line ``{"ok": true, "device": {...}}``.  Any failed check raises.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def load_tool(name: str):
    """``tools/<name>.py`` of this checkout, as a module."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(HERE, "tools", name + ".py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


# The work counts and the card's peaks: one home, the roofline tool.
ROOFLINE = load_tool("torch_roofline")
bound = ROOFLINE.bound
scale_bound = ROOFLINE.scale_bound
chunk_bound = ROOFLINE.chunk_bound

SIZES = (224, 179, 143, 115, 92)       # TVL1Config() pyramid of a 224² crop
PAIRS = 15                             # frame pairs of a 16-frame window
SCALE_BLOCKS = (1, 2, 4, 8, 16)        # cluster sizes of tvl1_scale
SERVE_REQUESTS = 3

TOL_WARP = 1e-4        # K-A, on planes of [0, 255] images
TOL_ROUND = 1e-5       # K-B, u and v after one outer round
TOL_EPS = 1e-5         # the ε test's mean, relative to its value
# Fused probabilities, kernels vs plain versions.  The flow kernels match
# their plain versions bit for bit and the CNN calls are the same, so any
# difference is a fault: with random weights the 101 probabilities sit
# near 1/101, and a looser bound would let a wrong flow through.
TOL_PROBS = 1e-6
# The Farneback kernels follow their plain versions' operation order and
# the library is built without FMA contraction: they are held to equality.
TOL_FB = 0.0
TOL_MEAN_FLOW = 0.15   # px, mean interior flow against the scene's motion
GRID_YZ = 65535        # blocks a CUDA grid holds along y and along z
VEL = (1.3, -0.7)      # the scene's motion, px per frame
# Texture of the Farneback phases' scenes.  On the TV-L1 phases' scene
# (0.12 rad/px) the second derivatives are so small that the solve's 1e-3
# regulariser halves the flow, here as in cv2.calcOpticalFlowFarneback:
# (0.63, -0.34) for a motion of (1.3, -0.7).  At 0.4 rad/px it is recovered.
FB_FMAX = 0.4
NATIVE = (240, 320)    # UCF101's native frame size, for compute-flow
CF_BATCH = 8           # compute-flow's --batch: frame pairs per flow call
FB_FRAMES = 16

CARD = {}              # nvidia-smi's "name, power.limit", set by main()
# torch.profiler sessions that recorded too little, and the device_ms
# taken with CUDA events instead (see device_profile_until).
PROFILER = {"retaken_sessions": 0, "device_ms_from_cuda_events": [],
            "kernel_names_unrecorded": []}


def median_ops(k: int) -> float:
    """min/max operations an output of K-C takes: its generated tile
    schedule's count over the tile's outputs."""
    from video_analytics_tpu_torch.ops.median import (
        MEDIAN_TILE, separable_median_schedule)
    return (len(separable_median_schedule(k)[2])
            / (MEDIAN_TILE[0] * MEDIAN_TILE[1]))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def scene(np, t: float, h: int, w: int, seed: int, vel=(1.3, -0.7),
          fmax: float = 0.12):
    """(h, w) smooth texture in [0, 255] translated by t·vel pixels: a
    sum of sinusoids of up to `fmax` rad/px, so sub-pixel motion is
    exact."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    x = x - t * vel[0]
    y = y - t * vel[1]
    img = np.zeros((h, w))
    for _ in range(6):
        fx, fy = rng.uniform(-fmax, fmax, 2)
        img += rng.uniform(0.5, 1.0) * np.sin(fx * x + fy * y
                                              + rng.uniform(0, 6.3))
    img -= img.min()
    return (255.0 * img / img.max()).astype(np.float32)


def cuda_ms(torch, fn, iters: int = 20) -> float:
    """Mean milliseconds of fn() on the device, from CUDA events."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profile_request(torch, np, server, frames, request_ms):
    """Where one request's time goes.  Returns the stage times (host
    clock, sync after each) and, from one request under torch.profiler,
    the device time per kernel name, the summed and the merged (union)
    device intervals, and the union's share of the profiled request's
    wall and of the median unprofiled request."""
    from video_analytics_tpu_torch.ingest.windows import apply_transport_crop
    from video_analytics_tpu_torch.ops import preprocess as pp
    from video_analytics_tpu_torch.runtime import pipeline

    algo = server.cfg.flow_algo
    model, stages = server.model, {}
    mark = [time.perf_counter()]

    def lap(name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        stages[name] = 1e3 * (now - mark[0])
        mark[0] = now

    with torch.no_grad():
        wins, cfg = apply_transport_crop(server._windows_from_frames(frames),
                                         server.cfg)
        x = server._to_device(wins)
        lap("host_windows_and_copy")
        x = pipeline._crop(x, cfg)
        lap("resize_and_crop")
        rgb = pp.normalize(x, cfg.preprocess.mean, cfg.preprocess.std)
        s_logits = model.spatial(rgb.reshape(-1, *rgb.shape[2:])).mean(0)
        lap("rgb_cnn")
        stacks = pipeline._flow_stacks(x, cfg, False, server.flow_net,
                                       model.temporal.dtype)[0]
        lap(f"{algo}_and_stacking")
        t_logits = model.temporal(stacks).mean(0)
        model.fuse(s_logits, t_logits).cpu()
        lap("flow_cnn_and_fuse")

    median_ms = float(np.median(request_ms))
    prof = device_profile(torch, lambda: server._classify(
        server._windows_from_frames(frames)))
    busy_ms = prof["device_busy_ms"]
    return {"stage_ms": stages, "stage_sum_ms": sum(stages.values()), **prof,
            "unprofiled_median_ms": median_ms,
            "busy_share_of_unprofiled": busy_ms / median_ms}


def device_profile(torch, fn):
    """One call of fn() under torch.profiler: its wall time (host clock,
    with a sync), the device time per kernel name, the summed and the
    merged (union) device intervals, and the union's share of the wall."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    spans, per_name = [], {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        a, b = ev.time_range.start, ev.time_range.end      # µs
        spans.append((a, b))
        ms, n = per_name.get(ev.name, (0.0, 0))
        per_name[ev.name] = (ms + (b - a) / 1e3, n + 1)
    busy_ms, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy_ms += (b - max(a, end)) / 1e3
            end = b
    ranked = sorted(per_name.items(), key=lambda kv: -kv[1][0])
    ours = [{"name": short_kernel_name(name), "ms": ms, "count": n,
             "ms_each": ms / n}
            for name, (ms, n) in ranked if port_kernel(name)]
    return {"profiled_wall_ms": wall_ms, "device_events": len(spans),
            "device_sum_ms": sum(ms for ms, _ in per_name.values()),
            "device_busy_ms": busy_ms,
            "busy_share_of_profiled": busy_ms / wall_ms,
            "top_device_ms": [{"name": name[:80], "ms": ms, "count": n}
                              for name, (ms, n) in ranked[:10]],
            "port_kernels_device_ms": ours}


# The __global__ functions of video_analytics_tpu_torch/csrc/*.cu, as they
# appear in a profile's kernel names.
PORT_KERNELS = ("warp_prep_kernel", "pd_step_kernel",
                "median_kernel", "pd_warp_kernel", "pd_chunk_kernel",
                "fb_prologue_kernel",
                "fb_blur_sample_kernel",
                "fb_warp_neq_kernel", "sep_corr_kernel",
                "fb_window_solve_kernel", "bn_act_kernel",
                "short_mha_kernel")


def port_kernel(name: str) -> bool:
    return any(k in name for k in PORT_KERNELS)


def short_kernel_name(name: str) -> str:
    """A profile's kernel name without its namespace and argument list:
    ``pd_warp_kernel<13, true>``."""
    name = name.split("(anonymous namespace)::", 1)[-1]
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0:
            return name[:i]
    return name[:80]


def device_profile_until(torch, fn, ok, tries: int = 5):
    """device_profile(fn), taken again until ok(profile) holds, at most
    `tries` times, a little later each time.  The profiler now and then
    drops records, at times all of a short session's and at times those
    of several sessions running.  Only for an fn that may run again.
    Returns (the last profile, whether ok held)."""
    for i in range(tries):
        prof = device_profile(torch, fn)
        if ok(prof):
            return prof, True
        PROFILER["retaken_sessions"] += 1
        time.sleep(0.2 * (i + 1))
    return prof, False


def device_ms(torch, fn, kernel: str, reps: int = 5) -> float:
    """The device duration of one launch of the kernel whose name holds
    `kernel`: `reps` calls of fn() under torch.profiler, the kernel's
    summed device time over its launches.  Unlike ``cuda_ms`` it leaves
    out the host's pace between launches.  If no profile records the
    kernel, CUDA events around `reps` calls of fn() stand in, and the
    kernel is listed under ``PROFILER["device_ms_from_cuda_events"]``."""
    fn()

    def hits(prof):
        return [k for k in prof["port_kernels_device_ms"]
                if kernel in k["name"]]

    prof, ok = device_profile_until(
        torch, lambda: [fn() for _ in range(reps)], lambda p: hits(p))
    if not ok:
        ms = cuda_ms(torch, fn, reps)
        PROFILER["device_ms_from_cuda_events"].append(
            {"kernel": kernel, "ms": ms})
        print(f"torch.profiler recorded no {kernel}: CUDA events instead",
              file=sys.stderr, flush=True)
        return ms
    found = hits(prof)
    check(len(found) == 1 and found[0]["count"] >= 1,
          f"profile of {kernel}: {prof['port_kernels_device_ms']}")
    return found[0]["ms_each"]


class TestLaunches:
    """A share of a wrapper's launches that it counts apart, counted like
    a wrapper's ``launches``: reads and sets the wrapper's `attr`.  By
    default those of a solver's wrapper (``pd_step``, ``pd_chunk``) that
    ended with the round's convergence test (``launches_test``)."""

    def __init__(self, wrapper, attr: str = "launches_test"):
        self.wrapper, self.attr = wrapper, attr

    @property
    def launches(self) -> int:
        return getattr(self.wrapper, self.attr)

    @launches.setter
    def launches(self, n: int) -> None:
        setattr(self.wrapper, self.attr, n)


def zero_counts(kernels) -> None:
    """Set the launch count of every wrapper in {name: wrapper} to 0."""
    for fn in kernels.values():
        fn.launches = 0


def read_counts(kernels):
    return {name: fn.launches for name, fn in kernels.items()}


def zero_fb_counts(fk) -> None:
    """Set the launch counts of the Farneback wrappers to 0."""
    fk.fb_prologue.launches = fk.fb_prologue.launches_blur = 0
    fk.fb_warp_neq.launches = 0
    fk.sep_corr.launches = fk.sep_corr.launches_solve = 0
    fk.fb_window_solve.launches = fk.fb_iteration.launches = 0


def read_fb_counts(fk):
    """Launches per Farneback kernel.  ``sep_corr`` launches one of two
    instantiations, counted apart: the one-plane correlation, and the
    five-plane one with the solve epilogue."""
    return {"fb_prologue": fk.fb_prologue.launches,
            "fb_prologue_blur": fk.fb_prologue.launches_blur,
            "fb_warp_neq": fk.fb_warp_neq.launches,
            "sep_corr": fk.sep_corr.launches - fk.sep_corr.launches_solve,
            "sep_corr_x_solve": fk.sep_corr.launches_solve,
            "fb_window_solve": fk.fb_window_solve.launches,
            "fb_iteration": fk.fb_iteration.launches}


def fb_expected(levels: int, iterations: int, calls: int = 1,
                split: int = 0, route: str = "iteration"):
    """Launches of the Farneback kernels over `calls` flow calls: the
    prologue once per level, its blur pass once per level of the
    two-launch form (`split` of them), and per level and iteration the
    kernels of the window's route (``window_route``): ``fb_iteration``;
    K-E and ``fb_window_solve``; or K-E and ``sep_corr`` twice."""
    its = calls * levels * iterations
    return {"fb_prologue": calls * levels, "fb_prologue_blur": calls * split,
            "fb_iteration": its if route == "iteration" else 0,
            "fb_warp_neq": 0 if route == "iteration" else its,
            "fb_window_solve": its if route == "window_solve" else 0,
            "sep_corr": its if route == "sep_corr" else 0,
            "sep_corr_x_solve": its if route == "sep_corr" else 0}


def flow_counters():
    """(zero, read) over the launch counts of every TV-L1 and Farneback
    kernel wrapper: ``zero()`` sets them to 0, ``read()`` returns them by
    kernel name."""
    from video_analytics_tpu_torch.ops.cuda import farneback as fk
    from video_analytics_tpu_torch.ops.cuda import tvl1_solve as ts
    from video_analytics_tpu_torch.ops.cuda.warp import warp_prep

    tv = {"tvl1_scale": ts.pd_solve_scale, "warp_prep": warp_prep,
          "median5": ts.median5, "tvl1_pd_step": ts.pd_step,
          "tvl1_pd_step_eps": TestLaunches(ts.pd_step),
          "tvl1_pd_chunk": ts.pd_chunk,
          "tvl1_pd_chunk_flags": TestLaunches(ts.pd_chunk)}

    def zero():
        zero_counts(tv)
        zero_fb_counts(fk)

    def read():
        return {**read_counts(tv), **read_fb_counts(fk)}

    return zero, read


# The fused norm pass's launches in one classify call of the two-stream
# ResNet-18 (both streams' eval forward; BN_LAUNCHES["resnet18"] each):
# every launch, and those that add a block's residual.
BN_PER_CLASSIFY = {"bn_act": 40, "bn_act_residual": 16}


def norm_kernels():
    """{row name: counter} of the fused norm pass (``ops/cuda/bn_act``):
    ``bn_act`` every launch, ``bn_act_residual`` those with a residual."""
    from video_analytics_tpu_torch.ops.cuda.bn_act import bn_act

    return {"bn_act": bn_act,
            "bn_act_residual": TestLaunches(bn_act, "launches_residual")}


def norm_expected(calls: int):
    """The fused norm pass's launches over `calls` two-stream ResNet-18
    classify calls."""
    return {k: calls * n for k, n in BN_PER_CLASSIFY.items()}


def main_path_counters():
    """``flow_counters`` with the fused norm pass's two counters beside
    the flow kernels': (zero, read) over all of them."""
    zero_flow, read_flow = flow_counters()
    norm = norm_kernels()

    def zero():
        zero_flow()
        zero_counts(norm)

    def read():
        return {**read_flow(), **read_counts(norm)}

    return zero, read


def serve_requests(server, frames, zero, read, per_request=None):
    """Answer SERVE_REQUESTS classify requests with every launch count
    set to 0 (`zero()`) just before and read (`read()`) just after; every
    count must be > 0 or, with `per_request`, SERVE_REQUESTS times the
    number given there.  Returns (request_ms, probabilities of each
    request, launches per kernel)."""
    zero()
    request_ms, outs = [], []
    for _ in range(SERVE_REQUESTS):
        t0 = time.perf_counter()
        outs.append(server._classify(server._windows_from_frames(frames)))
        request_ms.append(1e3 * (time.perf_counter() - t0))
    launches = read()
    for name, n in launches.items():
        if per_request is None:
            check(n > 0, f"kernel {name} was not launched on the serve path")
        else:
            check(n == SERVE_REQUESTS * per_request[name],
                  f"kernel {name}: {n} launches over {SERVE_REQUESTS} "
                  f"requests, expected {per_request[name]} per request")
    return request_ms, outs, launches


def check_probs(torch, np, server, frames, probs):
    """The answer is a distribution over the classes and equals the one
    the plain versions of the kernels give.  Returns the max abs
    difference."""
    from video_analytics_tpu_torch.ingest.windows import apply_transport_crop
    from video_analytics_tpu_torch.runtime.pipeline import classify_window

    n_classes = server.cfg.num_classes
    check(probs.shape == (n_classes,), f"probs shape {probs.shape}")
    check(bool(np.isfinite(probs).all()) and bool((probs >= 0).all()),
          "probs not finite and non-negative")
    check(abs(float(probs.sum()) - 1.0) < 1e-4, f"probs sum {probs.sum()}")
    wins, wcfg = apply_transport_crop(server._windows_from_frames(frames),
                                      server.cfg)
    x = torch.from_numpy(wins[0]).to(server.device)
    plain = classify_window(x, server.model, wcfg, plain=True).cpu().numpy()
    e = float(np.abs(plain - probs).max())
    check(e <= TOL_PROBS, f"fused probs vs plain versions: {e} > {TOL_PROBS}")
    return e


def farneback_kernels_phase(torch, np, dev):
    """Phase 5.  Returns (errs, times, bounds, device durations) keyed by
    kernel name; times and bounds are those at the finest serve level
    (224², 15 pairs).

    At every level the kernels get the sequence form's shapes (16 frames,
    15 pairs), which the serve path gives them.  At the native levels
    they also get the pair form's, as ``compute-flow --batch 8`` gives
    them for a 16-frame clip: chunks of 8 and 7 pairs, whose prologue
    runs over both sides of every pair (16 and 14 frames)."""
    import torch.nn as nn

    from video_analytics_tpu_torch.config import FarnebackConfig
    from video_analytics_tpu_torch.flow.farneback import (
        _level_sizes, _resize_flow, farneback_sequence)
    from video_analytics_tpu_torch.ops.cuda import farneback as fk
    from video_analytics_tpu_torch.ops.kernels import farneback_window_taps

    def three_launches(R0, R1, flow, taps):
        """One iteration as K-E and the two launches of K-F."""
        return fk.sep_corr(fk.sep_corr(fk.fb_warp_neq(R0, R1, flow), taps, 0),
                           taps, 1, solve=True)

    def two_launches(R0, R1, flow, taps):
        """One iteration as K-E and fb_window_solve: M reaches device
        memory once."""
        return fk.fb_window_solve(fk.fb_warp_neq(R0, R1, flow), taps)

    cfg = FarnebackConfig()
    n_poly = 2 * cfg.poly_n + 1
    tap_sets = {"box": farneback_window_taps(cfg.winsize, False),
                "gaussian": farneback_window_taps(cfg.winsize, True)}
    errs = {"fb_prologue": 0.0, "fb_warp_neq": 0.0, "sep_corr": 0.0,
            "sep_corr_x_solve": 0.0, "fb_window_solve": 0.0,
            "fb_iteration": 0.0}
    shapes = {}
    report, main_times, main_bounds, main_dev = {}, {}, {}, {}
    level_err = seq_epe = 0.0

    def diff(got, want, what):
        e = (got - want).abs().max().item()
        check(got.shape == want.shape and e <= TOL_FB,
              f"{what}: max abs {e} > {TOL_FB}")
        return e

    def check_level(src, split, lh, lw, scale):
        """Every kernel and one whole level against the plain versions,
        at one level and one batch: `src` is the frames the prologue
        sees, `split` cuts its output into the pairs' R0 and R1.  Returns
        the tensors, for timing."""
        nonlocal level_err
        B = split(src)[0].shape[0]
        what = f"{lh}x{lw}, {src.shape[0]} frames, {B} pairs"
        shapes.setdefault(f"{lh}x{lw}", []).append([src.shape[0], B])
        args = (src, scale, (lh, lw), cfg.poly_n, cfg.poly_sigma)
        R = fk.fb_prologue(*args)
        R_ref = fk.fb_prologue_plain(*args)
        errs["fb_prologue"] = max(errs["fb_prologue"],
                                  diff(R, R_ref, f"fb_prologue at {what}"))
        R0, R1 = (r.contiguous() for r in split(R_ref))
        yy, xx = np.mgrid[0:lh, 0:lw] / max(lh, lw)
        flow = torch.from_numpy(np.stack([np.stack(
            [2.5 * np.sin(6 * yy + b), -2.0 * np.cos(5 * xx - b)])
            for b in range(B)]).astype(np.float32)).to(dev)
        flow[0] = torch.round(flow[0])             # floor() at exact integers
        flow[1, 0, :, :3] = -50.0                  # the clamp, far outside
        M = fk.fb_warp_neq(R0, R1, flow)
        M_ref = fk.fb_warp_neq_plain(R0, R1, flow)
        errs["fb_warp_neq"] = max(errs["fb_warp_neq"],
                                  diff(M, M_ref, f"fb_warp_neq at {what}"))
        for tname, taps in tap_sets.items():
            for axis in (0, 1):
                for solve in (False, True):
                    e = diff(fk.sep_corr(M_ref, taps, axis, solve),
                             fk.sep_corr_plain(M_ref, taps, axis, solve),
                             f"sep_corr {tname} axis {axis} solve {solve} "
                             f"at {what}")
                    name = "sep_corr_x_solve" if solve else "sep_corr"
                    errs[name] = max(errs[name], e)
            # Both passes and the solve in one launch: what the two launches
            # of K-F give, and the plain version; then with K-E as its loader.
            at = f"{tname} at {what}"
            two = fk.sep_corr(fk.sep_corr(M_ref, taps, 0), taps, 1, solve=True)
            got = fk.fb_window_solve(M_ref, taps)
            errs["fb_window_solve"] = max(
                errs["fb_window_solve"],
                diff(got, two, f"fb_window_solve vs two launches, {at}"),
                diff(got, fk.fb_window_solve_plain(M_ref, taps),
                     f"fb_window_solve {at}"))
            one = fk.fb_iteration(R0, R1, flow, taps)
            errs["fb_iteration"] = max(
                errs["fb_iteration"],
                diff(one, got, f"fb_iteration vs K-E + fb_window_solve, {at}"),
                diff(one, fk.fb_iteration_plain(R0, R1, flow, taps),
                     f"fb_iteration {at}"))

        # One whole level: 3 iterations, in single launches (the path) and
        # in two, against the plain versions.
        taps = tap_sets["box"]
        f_k = f_i = f_p = torch.zeros_like(flow)
        for _ in range(cfg.iterations):
            f_k = two_launches(R0, R1, f_k, taps)
            f_i = fk.fb_iteration(R0, R1, f_i, taps)
            f_p = fk.fb_iteration_plain(R0, R1, f_p, taps)
        level_err = max(level_err, diff(f_k, f_p, f"level at {what}"),
                        diff(f_i, f_p, f"level in single launches at {what}"))
        return args, R0, R1, flow, M_ref

    for H, W in ((224, 224), NATIVE):
        frames = torch.from_numpy(np.stack(
            [scene(np, t, H, W, seed=3, fmax=FB_FMAX)
             for t in range(FB_FRAMES)])).to(dev)
        B = FB_FRAMES - 1
        taps = tap_sets["box"]
        sizes = _level_sizes(H, W, cfg)
        for lh, lw, scale in sizes:
            key = f"{lh}x{lw}"
            if (H, W) == NATIVE:
                # The pair form, as compute-flow calls it: both sides of
                # each chunk's pairs go through the prologue together.
                for s in range(0, B, CF_BATCH):
                    e = min(s + CF_BATCH, B)
                    check_level(
                        torch.cat([frames[s:e], frames[s + 1:e + 1]]),
                        lambda R, n=e - s: (R[:n], R[n:]), lh, lw, scale)
            # The sequence form, as the serve path calls it; timed below.
            args, R0, R1, flow, M_ref = check_level(
                frames, lambda R: (R[:-1], R[1:]), lh, lw, scale)

            # One PyTorch call that computes K-F without its epilogue: a
            # convolution with the taps and a replicate border.  It is
            # timed here and used nowhere in the package.
            r = len(taps) // 2
            conv = nn.Conv2d(1, 1, (len(taps), 1), padding=(r, 0),
                             padding_mode="replicate", bias=False).to(dev)
            with torch.no_grad():
                conv.weight.copy_(torch.tensor(taps).view(1, 1, -1, 1))
                planes = M_ref.reshape(B * 5, 1, lh, lw)
                lib_out = conv(planes).reshape(B, 5, lh, lw)
                scale_m = M_ref.abs().max().item()
                e = (lib_out - fk.sep_corr_plain(M_ref, taps, 0)
                     ).abs().max().item()
                check(e <= 1e-5 * scale_m,
                      f"the library convolution is not sep_corr at {key}: {e}")
                library_ms = cuda_ms(torch, lambda: conv(planes))
            times = {
                "fb_prologue": (
                    cuda_ms(torch, lambda: fk.fb_prologue(*args)),
                    cuda_ms(torch, lambda: fk.fb_prologue_plain(*args)), None),
                "fb_warp_neq": (
                    cuda_ms(torch, lambda: fk.fb_warp_neq(R0, R1, flow)),
                    cuda_ms(torch, lambda: fk.fb_warp_neq_plain(R0, R1, flow)),
                    None),
                "sep_corr": (
                    cuda_ms(torch, lambda: fk.sep_corr(M_ref, taps, 0)),
                    cuda_ms(torch, lambda: fk.sep_corr_plain(M_ref, taps, 0)),
                    library_ms),
                "sep_corr_x_solve": (
                    cuda_ms(torch, lambda: fk.sep_corr(M_ref, taps, 1, True)),
                    cuda_ms(torch, lambda: fk.sep_corr_plain(M_ref, taps, 1,
                                                             True)), None),
                "fb_window_solve": (
                    cuda_ms(torch, lambda: fk.fb_window_solve(M_ref, taps)),
                    cuda_ms(torch, lambda: fk.fb_window_solve_plain(M_ref,
                                                                    taps)),
                    None),
                "fb_iteration": (
                    cuda_ms(torch, lambda: fk.fb_iteration(R0, R1, flow,
                                                           taps)),
                    cuda_ms(torch, lambda: fk.fb_iteration_plain(
                        R0, R1, flow, taps)), None)}
            # The kernels' own durations, at the finest level of each pyramid.
            dev_ms = {}
            if (lh, lw) == (H, W):
                dev_ms = {
                    "fb_prologue": device_ms(
                        torch, lambda: fk.fb_prologue(*args),
                        "fb_prologue_kernel"),
                    "fb_warp_neq": device_ms(
                        torch, lambda: fk.fb_warp_neq(R0, R1, flow),
                        "fb_warp_neq_kernel"),
                    "sep_corr": device_ms(
                        torch, lambda: fk.sep_corr(M_ref, taps, 0),
                        "sep_corr_kernel"),
                    "sep_corr_x_solve": device_ms(
                        torch, lambda: fk.sep_corr(M_ref, taps, 1, True),
                        "sep_corr_kernel"),
                    "fb_window_solve": device_ms(
                        torch, lambda: fk.fb_window_solve(M_ref, taps),
                        "fb_window_solve_kernel"),
                    "fb_iteration": device_ms(
                        torch, lambda: fk.fb_iteration(R0, R1, flow, taps),
                        "fb_window_solve_kernel")}
            # Bytes and operations of each kernel at this level
            # (ROOFLINE.farneback_kernel_work).
            bounds = {name: bound(*work) for name, work in
                      ROOFLINE.farneback_kernel_work(
                          FB_FRAMES, B, H, W, lh, lw, scale,
                          len(fk._smooth_taps(scale)), n_poly,
                          len(taps)).items()}
            report[key] = {
                name: {"ms": t[0], "plain_ms": t[1], "library_ms": t[2],
                       "bound_ms": bounds[name][0],
                       "bound_by": bounds[name][1],
                       **({"device_ms": dev_ms[name]} if dev_ms else {})}
                for name, t in times.items()}
            if (lh, lw) == (224, 224):
                main_times, main_bounds, main_dev = times, bounds, dev_ms

        seq = farneback_sequence(frames, cfg)
        seq_plain = farneback_sequence(frames, cfg, plain=True)
        epe = (seq - seq_plain).norm(dim=-1).max().item()
        check(epe <= TOL_FB, f"farneback_sequence at {H}x{W}: max EPE {epe}")
        seq_epe = max(seq_epe, epe)
        mean = seq[:, 16:-16, 16:-16].reshape(-1, 2).mean(0).tolist()
        check(abs(mean[0] - VEL[0]) < TOL_MEAN_FLOW
              and abs(mean[1] - VEL[1]) < TOL_MEAN_FLOW,
              f"farneback mean flow {mean} at {H}x{W}, expected {VEL}")
        # The same sequence with an iteration as three launches (K-E and K-F
        # twice), two (K-E and fb_window_solve) and one (fb_iteration: the
        # path): equal flows, timed in turns, forwards then back.
        variants = {"three_launches": three_launches,
                    "two_launches": two_launches,
                    "one_launch": fk.fb_iteration}

        def seq_with(iterate):
            """The pyramid loop of farneback_sequence with `iterate` as
            one iteration."""
            flow = torch.zeros((B, 2, *sizes[0][:2]), device=dev)
            for i, (lh, lw, scale) in enumerate(sizes):
                if i:
                    flow = _resize_flow(flow, (lh, lw), 1.0 / cfg.pyr_scale)
                R = fk.fb_prologue(frames, scale, (lh, lw), cfg.poly_n,
                                   cfg.poly_sigma)
                for _ in range(cfg.iterations):
                    flow = iterate(R[:-1], R[1:], flow, taps)
            return flow

        for name, iterate in variants.items():
            check(torch.equal(seq_with(iterate).permute(0, 2, 3, 1), seq),
                  f"farneback_sequence at {H}x{W} with {name} differs")
        seq_ms = {name: [] for name in variants}
        for name in list(variants) + list(reversed(variants)):
            seq_ms[name].append(cuda_ms(
                torch, lambda: seq_with(variants[name]), 5))
        report[f"sequence_{H}x{W}"] = {
            "mean_flow": mean,
            "ms": cuda_ms(torch, lambda: farneback_sequence(frames, cfg), 3),
            "ms_by_launches_per_iteration": seq_ms,
            "plain_ms": cuda_ms(
                torch, lambda: farneback_sequence(frames, cfg, plain=True), 3)}
    emit({"phase": "farneback_kernels", "frames": FB_FRAMES,
          "frames_and_pairs_checked": shapes, "max_abs_err": errs, "level_max_abs_err": level_err,
          "sequence_max_epe": seq_epe, "tolerance": TOL_FB,
          "by_level": report})
    return errs, main_times, main_bounds, main_dev


def farneback_serve_phase(torch, np, dev, model):
    """Phase 6.  Returns the launches of K-D, K-E, K-F over the requests."""
    from video_analytics_tpu_torch.config import PipelineConfig
    from video_analytics_tpu_torch.flow.farneback import _level_sizes
    from video_analytics_tpu_torch.ops import preprocess as pp
    from video_analytics_tpu_torch.ops.cuda import farneback as fk
    from video_analytics_tpu_torch.runtime import pipeline
    from video_analytics_tpu_torch.runtime.serve import ClipServer

    frames = np.stack([np.stack([scene(np, t, 256, 256, seed=c, fmax=FB_FMAX)
                                 for c in range(3)], axis=-1)
                       for t in range(16)]).round().astype(np.uint8)
    pcfg = PipelineConfig(flow_algo="farneback")
    server = ClipServer(model, pcfg, dev)
    warm_s = server.warmup()
    fcfg = pcfg.farneback
    request_ms, outs, launches = serve_requests(
        server, frames, lambda: zero_fb_counts(fk),
        lambda: read_fb_counts(fk),
        fb_expected(len(_level_sizes(224, 224, fcfg)), fcfg.iterations))
    e = check_probs(torch, np, server, frames, outs[0])

    with torch.no_grad():
        wins = server._to_device(server._windows_from_frames(frames))
        gray = pp.rgb_to_gray(pipeline._crop(wins, pcfg))
        flow = pipeline.compute_flow_sequence(gray[0], pcfg)
    check(tuple(flow.shape) == (15, 224, 224, 2), f"flow {tuple(flow.shape)}")
    mean = flow[:, 16:-16, 16:-16].reshape(-1, 2).mean(0).tolist()
    check(abs(mean[0] - VEL[0]) < TOL_MEAN_FLOW
          and abs(mean[1] - VEL[1]) < TOL_MEAN_FLOW,
          f"served window's mean flow {mean}, expected {VEL}")
    emit({"phase": "farneback_serve", "warmup_s": warm_s,
          "request_ms": request_ms,
          "launches_per_request": {k: v // SERVE_REQUESTS
                                   for k, v in launches.items()},
          "top1": int(outs[0].argmax()), "probs_max_abs_vs_plain": e,
          "repeat_max_abs": max(float(np.abs(o - outs[0]).max())
                                for o in outs),
          "mean_flow": mean})
    emit({"phase": "farneback_profile",
          **profile_request(torch, np, server, frames, request_ms)})
    return launches


def compute_flow_phase(np):
    """Phase 7: the compute-flow command on a frames directory, with the
    Farneback launch counts set to 0 just before it and read just after.
    Returns the launches per kernel."""
    import tempfile

    from video_analytics_tpu_torch.cli.main import main as cli_main
    from video_analytics_tpu_torch.ops.cuda import farneback as fk
    from video_analytics_tpu_torch.io.flowio import read_flo
    from video_analytics_tpu_torch.io.video import write_frames

    H, W = NATIVE
    frames = np.stack([np.stack([scene(np, t, H, W, seed=c, fmax=FB_FMAX)
                                 for c in range(3)], axis=-1)
                       for t in range(FB_FRAMES)]).round().astype(np.uint8)
    with tempfile.TemporaryDirectory() as tmp:
        src, out = os.path.join(tmp, "frames"), os.path.join(tmp, "flow")
        write_frames(frames, src)
        zero_fb_counts(fk)
        t0 = time.perf_counter()
        rc = cli_main(["compute-flow", src, out, "--algo", "farneback",
                       "--format", "flo", "--batch", str(CF_BATCH),
                       "--no-bucket", "--device", "cuda"])
        seconds = time.perf_counter() - t0
        launches = read_fb_counts(fk)
        check(rc == 0, f"compute-flow exited {rc}")
        files = sorted(f for f in os.listdir(out) if f.endswith(".flo"))
        check(len(files) == FB_FRAMES - 1,
              f"compute-flow wrote {len(files)} .flo files")
        flow = read_flo(os.path.join(out, files[7]))
    check(flow.shape == (H, W, 2) and bool(np.isfinite(flow).all()),
          f"flow read back: {flow.shape}")
    mean = flow[16:-16, 16:-16].reshape(-1, 2).mean(0).tolist()
    check(abs(mean[0] - VEL[0]) < TOL_MEAN_FLOW
          and abs(mean[1] - VEL[1]) < TOL_MEAN_FLOW,
          f"compute-flow mean flow {mean}, expected {VEL}")
    # Each flow call of --batch pairs launches the prologue once per level,
    # and fb_iteration once per level and iteration.
    calls = -(-(FB_FRAMES - 1) // CF_BATCH)
    per_call = expected_flow_launches("farneback", H, W)
    expected = {k: calls * per_call[k] for k in launches}
    check(launches == expected,
          f"compute-flow launched {launches}, expected {expected}")
    emit({"phase": "compute_flow", "files": len(files), "seconds": seconds,
          "read_back": files[7], "mean_flow": mean, "batch": CF_BATCH,
          "launches": launches})
    return launches


FB_HD_FRAMES = 3       # 2 pairs: one flow call of the command


def farneback_1080p_phase(torch, np, dev):
    """The Farneback command at 1080x1920 with parameters the reference
    takes and the first kernels did not: ``--fb-levels 4`` (the coarsest
    level, 68x120 at 1/16, pre-blurs with 39 taps, and K-D takes its
    two-launch form there) and ``--fb-winsize 33``, each with the launch
    counts set to 0 just before and held to the expected numbers just
    after, and every ``.flo`` file equal to the plain path's flow.  Then
    K-D against its plain version at 1/16 and 1/32 (39 and 79 taps), timed,
    and one iteration of each window route (33, 75 and 201 taps) against
    the plain version at the 1/8 level.  Returns (launches per kernel of
    the two commands, {"fb_prologue_blur": (max_abs_err, (ms, plain_ms,
    None), bound, device_ms)} at 1/16)."""
    import tempfile

    from video_analytics_tpu_torch.cli.main import _load_frames
    from video_analytics_tpu_torch.config import FarnebackConfig
    from video_analytics_tpu_torch.flow.farneback import _level_sizes, farneback
    from video_analytics_tpu_torch.io.flowio import read_flo
    from video_analytics_tpu_torch.io.video import write_frames
    from video_analytics_tpu_torch.ops.cuda import farneback as fk
    from video_analytics_tpu_torch.ops.preprocess import rgb_to_gray

    from video_analytics_tpu_torch.ops.cuda import _build

    H, W = FULL_HD
    lib = _build.library()
    # The size rules' shared-memory counts are the library's own.
    for n in (15, 33, 73, 75, 193, 195, 201):
        for planes, neq in ((5, 1), (1, 0)):
            want = fk.window_smem(n, planes)
            check(lib.va_fb_window_smem(n, neq)
                  == (want if want <= 232448 else -1),
                  f"window_smem({n}, {planes}) is not the library's")
    for planes in (1, 5):
        check(lib.va_sep_corr_smem(planes)
              == fk.sep_corr_smem(1401, 1, planes),
              f"sep_corr_smem for {planes} planes is not the library's")
    planes = [scene(np, t, H, W, seed=9, fmax=FB_FMAX)
              for t in range(FB_HD_FRAMES)]
    frames = np.stack([np.stack([g * img for g in (1.0, 0.85, 0.7)], axis=-1)
                       for img in planes]).round().astype(np.uint8)
    report, total = {}, None
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "frames")
        write_frames(frames, src)
        gray = rgb_to_gray(torch.from_numpy(_load_frames(src, None)).to(dev))
        for flag, value in (("--fb-levels", 4), ("--fb-winsize", 33),
                            ("--fb-winsize", 201)):
            cfg = FarnebackConfig(**{flag[5:]: value})
            levels = _level_sizes(H, W, cfg)
            forms = [fk.prologue_form(H, W, lh, lw, sc, cfg.poly_n)
                     for lh, lw, sc in levels]
            for (lh, lw, sc), (form, span) in zip(levels, forms):
                args = (len(fk._smooth_taps(sc)), 2 * cfg.poly_n + 1,
                        sc < 1 and lh != H, sc < 1 and lw != W)
                if form == "fused":
                    check(lib.va_fb_prologue_smem(*map(int, args), span)
                          == fk.prologue_smem(*args, span),
                          f"prologue_smem at {lh}x{lw} is not the library's")
            forms = [form for form, _ in forms]
            taps = [len(fk._smooth_taps(sc)) for _, _, sc in levels]
            out = os.path.join(tmp, f"flow{flag}")
            zero_fb_counts(fk)
            t0 = time.perf_counter()
            rc, res = run_cli(["compute-flow", src, out, "--algo",
                               "farneback", "--format", "flo", "--batch",
                               str(CF_BATCH), flag, str(value), "--no-bucket",
                               "--device", "cuda"])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = read_fb_counts(fk)
            check(rc == 0 and res["flows"] == FB_HD_FRAMES - 1,
                  f"compute-flow --algo farneback {flag} {value}: {rc} {res}")
            route = fk.window_route(cfg.winsize)
            expected = fb_expected(len(levels), cfg.iterations,
                                   split=forms.count("split"), route=route)
            check(launches == expected,
                  f"compute-flow {flag} {value} launched {launches}, "
                  f"expected {expected}")
            total = launches if total is None else {
                k: total[k] + n for k, n in launches.items()}
            with torch.no_grad():
                plain = farneback(gray[:-1], gray[1:], cfg,
                                  plain=True).cpu().numpy()
            files = sorted(f for f in os.listdir(out) if f.endswith(".flo"))
            flows = [read_flo(os.path.join(out, f)) for f in files]
            check(len(flows) == FB_HD_FRAMES - 1
                  and all(np.array_equal(f, p) for f, p in zip(flows, plain)),
                  f"compute-flow {flag} {value}: the flow is not the plain "
                  f"path's")
            mean = flows[0][64:-64, 64:-64].reshape(-1, 2).mean(0).tolist()
            check(abs(mean[0] - VEL[0]) < TOL_MEAN_FLOW
                  and abs(mean[1] - VEL[1]) < TOL_MEAN_FLOW,
                  f"compute-flow {flag} {value}: mean flow {mean}")
            report[f"{flag} {value}"] = {
                "levels": [[lh, lw] for lh, lw, _ in levels],
                "blur_taps": taps, "prologue_forms": forms,
                "window_route": route, "seconds": seconds,
                "launches": launches, "mean_flow": mean,
                "equal_to_plain_path": True}
    check(max(report["--fb-levels 4"]["blur_taps"]) > 31,
          "no level of --fb-levels 4 pre-blurs with more than 31 taps")

    # K-D where a tile's reach passes a block: 39 and 79 taps.
    cfg = FarnebackConfig()
    table, kd = None, {}
    for scale in (1 / 16, 1 / 32):
        lh, lw = int(round(H * scale)), int(round(W * scale))
        args = (gray, scale, (lh, lw), cfg.poly_n, cfg.poly_sigma)
        n0 = fk.fb_prologue.launches_blur
        got = fk.fb_prologue(*args)
        check(fk.fb_prologue.launches_blur == n0 + 1,
              f"fb_prologue at 1/{round(1 / scale)}: one launch")
        want = fk.fb_prologue_plain(*args)
        e = (got - want).abs().max().item()
        check(torch.equal(got, want),
              f"fb_prologue at 1/{round(1 / scale)}: max abs {e}")
        nb = len(fk._smooth_taps(scale))
        N = gray.shape[0]
        # Bytes: the frames read, the intermediate (the blurred frame at
        # 2 rows and 2 columns per level pixel) written.  Operations: the
        # vertical blur at the sample rows over every column, then the
        # horizontal one at the sample points, a multiply and an add a tap.
        px, samples = N * 2 * lh * W, N * 4 * lh * lw
        b = bound(4 * N * H * W + 4 * samples, 2 * nb * (px + samples))
        times = (cuda_ms(torch, lambda: fk.fb_prologue(*args), 5),
                 cuda_ms(torch, lambda: fk.fb_prologue_plain(*args), 2))
        dev_ms = device_ms(torch, lambda: fk.fb_prologue(*args),
                           "fb_blur_sample_kernel", 3)
        kd[f"{lh}x{lw}"] = {"blur_taps": nb, "ms_both_launches": times[0],
                            "plain_ms": times[1],
                            "blur_pass_device_ms": dev_ms,
                            "blur_pass_bound_ms": b[0], "bound_by": b[1]}
        if table is None:
            table = (e, (times[0], times[1], None), b, dev_ms)

    # The three window routes at the 1/8 level, 2 pairs.
    lh, lw = int(round(H / 8)), int(round(W / 8))
    R = fk.fb_prologue_plain(gray, 1 / 8, (lh, lw), cfg.poly_n,
                             cfg.poly_sigma)
    R0, R1 = R[:-1].contiguous(), R[1:].contiguous()
    g = torch.Generator(dev).manual_seed(11)
    flow = 2.0 * torch.randn((R0.shape[0], 2, lh, lw), device=dev,
                             generator=g)
    routes = {}
    for n in (33, 75, 201, 1401):
        taps = [1.0 / n] * n
        zero_fb_counts(fk)
        got = fk.fb_iterate(R0, R1, flow, taps)
        counts = {k: v for k, v in read_fb_counts(fk).items() if v}
        route = fk.window_route(n)
        check(counts == {k: v for k, v in fb_expected(1, 1, route=route,
                                                      ).items()
                         if v and k != "fb_prologue"},
              f"window of {n} taps ({route}) launched {counts}")
        check(torch.equal(got, fk.fb_iteration_plain(R0, R1, flow, taps)),
              f"one iteration with {n} taps ({route}) is not the plain one")
        routes[n] = {"route": route, "launches": counts,
                     "ms": cuda_ms(torch, lambda: fk.fb_iterate(
                         R0, R1, flow, taps), 5)}

    # K-F where the window route takes it, 201 taps: at the 1/8 level and at
    # 1080x1920, 2 pairs, along y and along x with the solve.
    sep, kf, eighth = {}, {}, (lh, lw)
    for lh, lw in (eighth, (H, W)):
        R = fk.fb_prologue_plain(gray, lh / H, (lh, lw), cfg.poly_n,
                                 cfg.poly_sigma)
        fl = 2.0 * torch.randn((R.shape[0] - 1, 2, lh, lw), device=dev,
                               generator=g)
        M = fk.fb_warp_neq_plain(R[:-1].contiguous(), R[1:].contiguous(), fl)
        del R, fl
        sep[f"{lh}x{lw}"], rows = sep_corr_at(torch, M, 201)
        if (lh, lw) == (H, W):
            kf = rows
        del M
    emit({"phase": "farneback_1080p", "frames": FB_HD_FRAMES,
          "commands": report, "fb_prologue_two_launch_form": kd,
          "window_routes_at": list(eighth), "window_routes": routes,
          "sep_corr_201_taps": sep, "tolerance": TOL_FB, **CARD})
    return total, {"fb_prologue_blur": table, **kf}


def sep_corr_at(torch, M, n: int):
    """K-F with n box taps on the normal-equation planes M (B, 5, h, w):
    along y, and along x with the solve, each equal to its plain version,
    timed (paced and device), with the plain version's time, the library's
    (one ``nn.Conv2d`` with replicate padding, TF32 off, along the same
    axis, checked against the plain correlation) and the bound (2
    operations a tap, output and plane, against the bytes).  Returns (the
    numbers by pass, {kernel row: (max_abs_err, (ms, plain_ms,
    library_ms), bound, device_ms)})."""
    import torch.nn as nn

    from video_analytics_tpu_torch.ops.cuda import farneback as fk
    from video_analytics_tpu_torch.ops.kernels import farneback_window_taps

    B, _, h, w = M.shape
    taps = farneback_window_taps(n, False)
    px = B * h * w
    bounds = {"sep_corr": bound(2 * 4 * 5 * px, 2 * n * 5 * px),
              "sep_corr_x_solve": bound(7 * 4 * px, (2 * n * 5 + 12) * px)}
    numbers, rows = {}, {}
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for name, axis, solve in (("sep_corr", 0, False),
                                  ("sep_corr_x_solve", 1, True)):
            got = fk.sep_corr(M, taps, axis, solve)
            want = fk.sep_corr_plain(M, taps, axis, solve)
            check(torch.equal(got, want),
                  f"{name} with {n} taps at {h}x{w} is not the plain "
                  f"version's")
            shape = (n, 1) if axis == 0 else (1, n)
            pad = (n // 2, 0) if axis == 0 else (0, n // 2)
            conv = nn.Conv2d(1, 1, shape, padding=pad, padding_mode="replicate",
                             bias=False).to(M.device)
            planes = M.reshape(B * 5, 1, h, w)
            with torch.no_grad():
                conv.weight.copy_(torch.tensor(taps).view(1, 1, *shape))
                e = (conv(planes).reshape(M.shape)
                     - fk.sep_corr_plain(M, taps, axis)).abs().max().item()
                check(e <= 1e-5 * M.abs().max().item(),
                      f"the library convolution is not sep_corr at {h}x{w}: "
                      f"{e}")
                library_ms = cuda_ms(torch, lambda: conv(planes), 3)
            times = (cuda_ms(torch, lambda: fk.sep_corr(M, taps, axis, solve),
                             10),
                     cuda_ms(torch, lambda: fk.sep_corr_plain(M, taps, axis,
                                                              solve), 2),
                     library_ms)
            dev_ms = device_ms(torch, lambda: fk.sep_corr(M, taps, axis, solve),
                               "sep_corr_kernel", 3)
            rows[name] = (0.0, times, bounds[name], dev_ms)
            numbers[name] = {"ms": times[0], "device_ms": dev_ms,
                             "plain_ms": times[1], "library_ms": library_ms,
                             "bound_ms": bounds[name][0],
                             "bound_by": bounds[name][1]}
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    return numbers, rows


def tvl1_level_inputs(torch, np, dev, h, w, pairs):
    """(i0, i13, uv) of one TV-L1 level: `pairs` frame pairs of the moving
    scene, the second frame with its centred gradient, and a smooth start
    flow a few pixels off."""
    from video_analytics_tpu_torch.ops.kernels import centered_gradient

    i0 = torch.from_numpy(np.stack([scene(np, b, h, w, seed=b)
                                    for b in range(pairs)])).to(dev)
    i1 = torch.from_numpy(np.stack([scene(np, b + 1, h, w, seed=b)
                                    for b in range(pairs)])).to(dev)
    i1x, i1y = centered_gradient(i1)
    i13 = torch.stack([i1, i1x, i1y], dim=1).contiguous()
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    uv = torch.from_numpy(np.stack([np.stack(
        [2.5 * np.sin(6 * yy + b), -2.0 * np.cos(5 * xx - b)])
        for b in range(pairs)]).astype(np.float32)).to(dev)
    return i0, i13, uv


# Levels K-H is checked at beside the serve sizes: 150 rows make strips of
# 19 with a last one of 17; 17 rows make strips of 3, 3, 3, 3, 3, 2 and two
# empty ones; at 256² (the size before the crop) the constants do not fit
# in shared memory beside the state; 240×320 (UCF101's native size) and
# 280×300 fit no cluster of 8 and take 16 blocks (strips of 15 and 18).
RAGGED = ((150, 201), (17, 40), (256, 256), (240, 320), (280, 300))


def tvl1_warp_kernel_phase(torch, np, dev):
    """K-H ``tvl1_scale`` (``pd_solve_scale``: all the warps of a scale in
    one launch) against its plain version and the per-iteration chain it
    replaces (K-A → K-B → K-C), its shared memory against the size rule's,
    and one scale of the serve path through the launch, the chain and the
    plain version.  Returns {"tvl1_scale": (max_abs_err, (ms, plain_ms,
    None), bound, device_ms)} of one scale of 15 pairs at 224² with
    ``TVL1Config()``."""
    from video_analytics_tpu_torch.config import TVL1Config
    from video_analytics_tpu_torch.ops.cuda import _build
    from video_analytics_tpu_torch.ops.cuda import tvl1_solve as ts
    from video_analytics_tpu_torch.ops.cuda.warp import warp_prep

    cfg = TVL1Config()
    lib = _build.library()
    report, scale_err, table = {}, 0.0, {}

    def chain_scale(i13, i0, uv, c):
        """One scale as the per-iteration chain ``tvl1_scale`` replaces:
        K-A and K-B per warp, then K-C."""
        for _ in range(c.warps):
            uv = ts.pd_solve(warp_prep(i13, i0, uv), uv, c)
        if c.median_filtering > 1:
            uv = ts.median5(uv, c.median_filtering)
        return uv
    for h, w in [(s, s) for s in SIZES] + list(RAGGED):
        i0, i13, uv = tvl1_level_inputs(torch, np, dev, h, w, PAIRS)
        geom = ts.warp_geometry(h, w)
        check(geom is not None, f"{h}x{w} does not fit a cluster")
        rows, consts, smem, blocks = geom
        # The library's shared memory a block at every cluster size (-1
        # where the strips do not fit) is strip_geometry's.
        smem_by_size = {c: lib.va_pd_scale_smem(h, w, c)
                        for c in SCALE_BLOCKS}
        geoms = {c: ts.strip_geometry(h, w, c) for c in SCALE_BLOCKS}
        check(smem_by_size == {c: -1 if g is None else g[2]
                               for c, g in geoms.items()},
              f"strip_geometry({h}, {w}) by size: {geoms}, the library "
              f"says {smem_by_size} B")
        # cudaOccupancyMaxActiveClusters at every size where the strips fit
        # (a negative CUDA error where they do not), and what
        # pd_solve_scale asks once a process; the size it takes for a
        # request's pairs and for the eval batch's.
        fit = [c for c in SCALE_BLOCKS if geoms[c] is not None]
        by_size = {cl: lib.va_pd_warp_max_clusters(h, w, PAIRS, cl)
                   for cl in SCALE_BLOCKS}
        check(all((by_size[c] >= 1) == (c in fit) for c in SCALE_BLOCKS)
              and all(ts.resident_clusters(dev.index or 0, h, w, c)
                      == by_size[c] for c in fit),
              f"max active clusters of {h}x{w}: {by_size}, fit {fit}")
        clusters = by_size[blocks]
        check(clusters >= 1, f"no cluster of {blocks} blocks of {h}x{w} can "
                             f"be resident: {clusters}")
        slots = lambda c: ts.resident_clusters(dev.index or 0, h, w, c)
        chosen = {n: ts.scale_blocks(h, w, n, slots) for n in (PAIRS, 120)}
        check(chosen[PAIRS] == blocks,
              f"tvl1_scale of {PAIRS} pairs at {h}x{w} takes {chosen} "
              f"blocks, the size rule {blocks}")
        entry = {"strip_rows": rows, "constants_in_shared_memory": consts,
                 "smem_bytes": smem, "smem_bytes_by_size": smem_by_size,
                 "cluster_blocks": blocks, "max_active_clusters": clusters,
                 "max_active_clusters_by_size": by_size,
                 "scale_blocks_by_pairs": chosen}
        finest = (h, w) == (SIZES[0], SIZES[0])

        # One warp: at epsilon = 0 no test can flip, and the launch is the
        # plain prep, solve and median (pd_solve_scale_plain) to the bit.
        orounds = torch.zeros((PAIRS, 1), dtype=torch.int32, device=dev)
        for k in (5, 3, 0):
            c = dataclasses.replace(cfg, epsilon=0.0, outer_iterations=2,
                                    warps=1, median_filtering=k)
            n = ts.pd_solve_scale.launches
            got = ts.pd_solve_scale(i13, i0, uv, c, orounds)
            check(ts.pd_solve_scale.launches == n + 1, "launch not counted")
            want = ts.pd_solve_scale_plain(i13, i0, uv, c)
            check(torch.equal(got, want),
                  f"tvl1_scale of one warp at {h}x{w}, epsilon 0, median "
                  f"{k}: max abs {(got - want).abs().max().item()} from the "
                  f"plain versions")
            check(bool((orounds == 2).all()), f"rounds {orounds.tolist()}")
        # With the test engaged: on this scene to the bit at the finest
        # serve size; elsewhere, and against the chain, a round may flip at
        # the threshold on the order of the sum: the reference's bound for
        # that.
        one = dataclasses.replace(cfg, warps=1)
        got = ts.pd_solve_scale(i13, i0, uv, one, orounds)
        want = ts.pd_solve_scale_plain(i13, i0, uv, one)
        e = (got - want).abs().max().item()
        entry["one_warp_equal_with_epsilon"] = torch.equal(got, want)
        check(entry["one_warp_equal_with_epsilon"] if finest
              else e <= 10 * cfg.epsilon,
              f"tvl1_scale of one warp at {h}x{w}, TVL1Config(): max abs "
              f"{e} from the plain version")
        scale_err = max(scale_err, e)
        e = (got - chain_scale(i13, i0, uv, one)).abs().max().item()
        check(e <= 10 * cfg.epsilon,
              f"tvl1_scale of one warp at {h}x{w}, TVL1Config(): max abs "
              f"{e} from the chain")
        entry["one_warp_rounds"] = orounds[:, 0].tolist()
        check(min(entry["one_warp_rounds"]) >= 1
              and max(entry["one_warp_rounds"]) <= cfg.outer_iterations,
              f"rounds {entry['one_warp_rounds']}")
        # A warp on which every image passes the test in round 1.
        loose = dataclasses.replace(one, epsilon=100.0)
        got = ts.pd_solve_scale(i13, i0, uv, loose, orounds)
        check(torch.equal(got, ts.pd_solve_scale_plain(i13, i0, uv, loose))
              and bool((orounds == 1).all()),
              f"tvl1_scale of one warp at {h}x{w}, every image converged in "
              f"round 1: rounds {orounds.tolist()}")

        # The whole scale, every warp and the scale-end median in one
        # launch.  epsilon = 0: every bit agrees with the chain and the
        # plain version.
        sc = {}
        srounds = torch.zeros((PAIRS, 2), dtype=torch.int32, device=dev)
        for k in (5, 3, 0):
            c = dataclasses.replace(cfg, epsilon=0.0, outer_iterations=2,
                                    warps=2, median_filtering=k)
            n = ts.pd_solve_scale.launches
            got = ts.pd_solve_scale(i13, i0, uv, c, srounds)
            check(ts.pd_solve_scale.launches == n + 1, "launch not counted")
            check(torch.equal(got, chain_scale(i13, i0, uv, c)),
                  f"tvl1_scale at {h}x{w}, epsilon 0, median {k}: not the "
                  f"chain's flow")
            want = ts.pd_solve_scale_plain(i13, i0, uv, c)
            e = (got - want).abs().max().item()
            check(torch.equal(got, want),
                  f"tvl1_scale at {h}x{w}, epsilon 0, median {k}: max abs "
                  f"{e} from the plain version")
            check(bool((srounds == 2).all()), f"rounds {srounds.tolist()}")
        # With the test engaged a round may flip at the threshold in any of
        # the warps, against the plain version and against the chain.
        srounds = torch.zeros((PAIRS, cfg.warps), dtype=torch.int32,
                              device=dev)
        ruled = ts.pd_solve_scale(i13, i0, uv, cfg, srounds)
        want = ts.pd_solve_scale_plain(i13, i0, uv, cfg)
        e = (ruled - want).abs().max().item()
        sc["equal_to_plain_with_epsilon"] = torch.equal(ruled, want)
        check(sc["equal_to_plain_with_epsilon"] if finest
              else e <= 10 * cfg.epsilon * cfg.warps,
              f"tvl1_scale at {h}x{w}, TVL1Config(): max abs {e} from the "
              f"plain version")
        scale_err = max(scale_err, e)
        sc["max_abs_vs_chain"] = (ruled - chain_scale(
            i13, i0, uv, cfg)).abs().max().item()
        check(sc["max_abs_vs_chain"] <= 10 * cfg.epsilon * cfg.warps,
              f"tvl1_scale at {h}x{w}, TVL1Config(): max abs "
              f"{sc['max_abs_vs_chain']} from the chain")
        sc["rounds"] = srounds.tolist()
        # Forced to each size that fits: at epsilon = 0 the plain version
        # to the bit; with the test engaged, on this scene, the rounds of
        # the size rule's size (the size only partitions the test's sum).
        exact = dataclasses.replace(cfg, epsilon=0.0, outer_iterations=2,
                                    warps=2)
        want = ts.pd_solve_scale_plain(i13, i0, uv, exact)
        forced_rounds = torch.zeros_like(srounds)
        sc["forced"] = {}
        for c in fit:
            n = dict(ts.pd_solve_scale.launches_by_blocks)
            got = ts.pd_solve_scale(i13, i0, uv, exact, blocks=c)
            check(ts.pd_solve_scale.launches_by_blocks.get(c, 0)
                  == n.get(c, 0) + 1, f"launch in {c} blocks not counted")
            check(torch.equal(got, want),
                  f"tvl1_scale at {h}x{w} in clusters of {c}, epsilon 0: "
                  f"max abs {(got - want).abs().max().item()} from the "
                  f"plain version")
            got = ts.pd_solve_scale(i13, i0, uv, cfg, forced_rounds, c)
            check(torch.equal(forced_rounds, srounds),
                  f"tvl1_scale at {h}x{w} in clusters of {c}: rounds "
                  f"{forced_rounds.tolist()}, in {blocks} "
                  f"{srounds.tolist()}")
            sc["forced"][c] = {
                "equal_to_size_rule_s_flow": torch.equal(got, ruled),
                "max_abs_vs_size_rule_s": (got - ruled).abs().max().item()}
        sb_ms, sb_by = scale_bound(sc["rounds"], h, w, cfg.inner_iterations,
                                   cfg.median_filtering)
        # In turns: the launch, the chain, the chain, the launch.
        t = [cuda_ms(torch, f, 3) for f in (
            lambda: ts.pd_solve_scale(i13, i0, uv, cfg),
            lambda: chain_scale(i13, i0, uv, cfg),
            lambda: chain_scale(i13, i0, uv, cfg),
            lambda: ts.pd_solve_scale(i13, i0, uv, cfg))]
        sc.update(ms=min(t[0], t[3]), ms_both=[t[0], t[3]],
                  chain_ms=min(t[1], t[2]), chain_ms_both=[t[1], t[2]],
                  chain_launches=cfg.warps * (1 + cfg.outer_iterations * (
                      cfg.inner_iterations + 1)) + 1,
                  bound_ms=sb_ms, bound_by=sb_by,
                  ms_one_warp=cuda_ms(
                      torch, lambda: ts.pd_solve_scale(i13, i0, uv, one), 5),
                  ms_one_warp_chain=cuda_ms(
                      torch, lambda: chain_scale(i13, i0, uv, one), 5))
        if finest:
            sc["plain_ms"] = cuda_ms(
                torch, lambda: ts.pd_solve_scale_plain(i13, i0, uv, cfg), 1)
            sc["device_ms"] = device_ms(
                torch, lambda: ts.pd_solve_scale(i13, i0, uv, cfg),
                "pd_warp_kernel", 3)
            table["tvl1_scale"] = (None, (sc["ms"], sc["plain_ms"], None),
                                   (sb_ms, sb_by), sc["device_ms"])
        entry["tvl1_scale"] = sc
        report[f"{h}x{w}"] = entry

    # One image and three windows' worth (more clusters than the card holds
    # at once), at the batch classify-clip --windows 3 gives the launch;
    # and a level that fits no cluster.
    for B in (1, 45):
        i0, i13, uv = tvl1_level_inputs(torch, np, dev, SIZES[0], SIZES[0], B)
        short = dataclasses.replace(cfg, epsilon=0.0, outer_iterations=1,
                                    warps=2)
        got = ts.pd_solve_scale(i13, i0, uv, short)
        check(torch.equal(got, chain_scale(i13, i0, uv, short)),
              f"tvl1_scale at batch {B}: not the chain's flow")
        check(torch.equal(got, ts.pd_solve_scale_plain(i13, i0, uv, short)),
              f"tvl1_scale at batch {B}: not the plain version's flow")
    check(ts.warp_geometry(*CHAIN) is None
          and all(lib.va_pd_scale_smem(*CHAIN, c) < 0 for c in SCALE_BLOCKS),
          f"{CHAIN} fits a cluster?")
    # The library refuses a cluster whose strips do not fit: 224² in 4, 2
    # or 1 blocks, and sizes the kernel does not take; 92² in one block
    # without the scratch its constants need.
    i0, i13, uv = tvl1_level_inputs(torch, np, dev, SIZES[0], SIZES[0], 1)
    out, scratch = torch.empty_like(uv), torch.empty_like(i13)
    stream = torch.cuda.current_stream(dev).cuda_stream
    refused = {}
    for (h, w), c, scr in [((224, 224), 4, scratch), ((224, 224), 2, scratch),
                           ((224, 224), 1, scratch), ((224, 224), 3, scratch),
                           ((224, 224), 32, scratch), ((92, 92), 1, None)]:
        err = lib.va_pd_scale(
            i13.data_ptr(), i0.data_ptr(), uv.data_ptr(), out.data_ptr(),
            None if scr is None else scr.data_ptr(), None, 1, h, w, c, 1, 1,
            1, 5, 0.045, 0.3, 0.833, 0.0, stream)
        refused[f"{h}x{w}/{c}"] = err
        check(err == 1, f"va_pd_scale at {h}x{w} in {c} blocks: {err}, "
                        f"not cudaErrorInvalidValue")
    emit({"phase": "tvl1_warp_kernel", "pairs": PAIRS, "tolerance": 0.0,
          "tolerance_where_a_round_may_flip_per_warp": 10 * cfg.epsilon,
          "tvl1_scale_max_abs_err": scale_err,
          "va_pd_scale_refused": refused,
          "tvl1_scale_launches_by_blocks": dict(
              ts.pd_solve_scale.launches_by_blocks),
          "by_level": report})
    return {"tvl1_scale": (scale_err, *table["tvl1_scale"][1:])}


# Finest levels under the size rule that fit no cluster of 8 blocks (PR 5's
# per-iteration chain) and fit one of 16: every level takes tvl1_scale.
MIDS = ((280, 300), (240, 320))
MID_FRAMES = 3
CHAIN = (20, 4000)     # a level too wide for 16 strips: K-A, K-B, K-C


def tvl1_midsize_phase(torch, np, dev):
    """``compute-flow --algo tvl1`` on frames of 280x300 and of 240x320:
    every level, the finest in 16-block clusters, is one launch of
    ``tvl1_scale`` (counted, and K-A, K-B and K-C held to 0); the
    flow at ε = 0 against the plain path's; one flow call of 2 pairs
    timed.  Then a pair of 20x4000, whose finest level fits no cluster,
    through ``tvl1``: K-A, K-B (a round's last step with the ε test) and
    K-C on it, no other launch (counted), and the flow at ε = 0 against
    the plain path's.  Returns (launches per kernel of the commands,
    launches of the 20x4000 pair)."""
    import tempfile

    from video_analytics_tpu_torch.cli.main import _load_frames
    from video_analytics_tpu_torch.config import TVL1Config
    from video_analytics_tpu_torch.flow.tvl1 import (
        _level_sizes, level_solver, tvl1)
    from video_analytics_tpu_torch.io.flowio import read_flo
    from video_analytics_tpu_torch.io.video import write_frames
    from video_analytics_tpu_torch.ops.cuda import tvl1_solve as ts
    from video_analytics_tpu_torch.ops.cuda.warp import warp_prep
    from video_analytics_tpu_torch.ops.preprocess import rgb_to_gray

    cfg = TVL1Config()
    kernels = {"tvl1_pd_step": ts.pd_step,
               "tvl1_pd_step_eps": TestLaunches(ts.pd_step),
               "median5": ts.median5, "warp_prep": warp_prep,
               "tvl1_scale": ts.pd_solve_scale, "tvl1_pd_chunk": ts.pd_chunk}
    exact = dataclasses.replace(cfg, epsilon=0.0, warps=2, outer_iterations=2)
    report, total = {}, dict.fromkeys(kernels, 0)
    for size in MIDS:
        sizes = _level_sizes(*size, cfg)
        takes = [level_solver(h, w, cfg.median_filtering) for h, w in sizes]
        check(takes == ["warp"] * len(sizes)
              and ts.warp_geometry(*size)[3] == 16,
              f"levels of {size} take {takes}")
        planes = [scene(np, t, *size, seed=7) for t in range(MID_FRAMES)]
        frames = np.stack([np.stack([g * img for g in (1.0, 0.85, 0.7)],
                                    axis=-1)
                           for img in planes]).round().astype(np.uint8)
        with tempfile.TemporaryDirectory() as tmp:
            src, out = os.path.join(tmp, "frames"), os.path.join(tmp, "flow")
            write_frames(frames, src)
            zero_counts(kernels)
            t0 = time.perf_counter()
            rc, res = run_cli(["compute-flow", src, out, "--algo", "tvl1",
                               "--format", "flo", "--batch", str(CF_BATCH),
                               "--no-bucket", "--device", "cuda"])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = read_counts(kernels)
            check(rc == 0 and res["flows"] == MID_FRAMES - 1,
                  f"compute-flow --algo tvl1 at {size} exited {rc}: {res}")
            # The same command again: what a second clip of the size pays.
            t0 = time.perf_counter()
            rc, _ = run_cli(["compute-flow", src, out + "_again", "--algo",
                             "tvl1", "--format", "flo", "--batch",
                             str(CF_BATCH), "--no-bucket", "--device",
                             "cuda"])
            torch.cuda.synchronize()
            again = time.perf_counter() - t0
            check(rc == 0, f"compute-flow at {size}, again: {rc}")
            flow = read_flo(os.path.join(out, sorted(os.listdir(out))[0]))
            gray = rgb_to_gray(torch.from_numpy(_load_frames(src, 3)).to(dev))
        expected = {**dict.fromkeys(kernels, 0), "tvl1_scale": len(sizes)}
        check(launches == expected,
              f"compute-flow at {size} launched {launches}, expected "
              f"{expected}")
        for name, n in launches.items():
            total[name] += n
        check(flow.shape == (*size, 2) and bool(np.isfinite(flow).all()),
              f"flow read back: {flow.shape}")
        mean = flow[32:-32, 32:-32].reshape(-1, 2).mean(0).tolist()
        check(abs(mean[0] - VEL[0]) < TOL_MEAN_FLOW
              and abs(mean[1] - VEL[1]) < TOL_MEAN_FLOW,
              f"mean flow {mean} at {size}, expected {VEL}")
        # With no test to flip, at a smaller depth, the pyramid through
        # tvl1_scale is the plain path's to the bit.
        with torch.no_grad():
            e = float((tvl1(gray[:2], gray[1:3], exact)
                       - tvl1(gray[:2], gray[1:3], exact, plain=True)
                       ).abs().max())
            check(e == 0.0, f"flow at {size}, epsilon 0, vs the plain path: "
                            f"{e}")
            call_ms = cuda_ms(torch, lambda: tvl1(gray[:2], gray[1:3], cfg),
                              3)
        # The finest level alone, 2 pairs: the launch against the route it
        # replaces (per warp K-A and the per-iteration chain, then K-C), in
        # turns.
        i0, i13, uv = tvl1_level_inputs(torch, np, dev, *size, 2)

        def old_route():
            u = uv
            for _ in range(cfg.warps):
                u = ts.pd_solve(warp_prep(i13, i0, u), u, cfg)
            return ts.median5(u, cfg.median_filtering)

        t = [cuda_ms(torch, f, 3) for f in (
            lambda: ts.pd_solve_scale(i13, i0, uv, cfg), old_route,
            old_route, lambda: ts.pd_solve_scale(i13, i0, uv, cfg))]
        report[f"{size[0]}x{size[1]}"] = {
            "levels_take": takes, "command_seconds": seconds,
            "command_seconds_again": again,
            "launches": launches, "mean_flow": mean,
            "max_abs_vs_plain_path_at_epsilon_0": e,
            "flow_call_pairs": 2, "flow_call_ms": call_ms,
            "finest_level_ms": [t[0], t[3]],
            "finest_level_ms_per_iteration_route": [t[1], t[2]]}

    # A level no cluster holds keeps the per-iteration chain.
    h, w = CHAIN
    chain_cfg = dataclasses.replace(exact, warps=1)
    sizes = _level_sizes(h, w, chain_cfg)
    takes = [level_solver(a, b, cfg.median_filtering) for a, b in sizes]
    check(takes == ["chain", "warp"], f"levels of {CHAIN} take {takes}")
    with torch.no_grad():
        prev = torch.from_numpy(scene(np, 0, h, w, seed=8)[None]).to(dev)
        nxt = torch.from_numpy(scene(np, 1, h, w, seed=8)[None]).to(dev)
        zero_counts(kernels)
        got = tvl1(prev, nxt, chain_cfg)
        chain = read_counts(kernels)
        e_chain = float((got - tvl1(prev, nxt, chain_cfg, plain=True)
                         ).abs().max())
    # Each round's last pd_step carries the round's ε test, but the warp's
    # last round, whose test nothing would read.
    rounds = chain_cfg.warps * chain_cfg.outer_iterations
    expected = {**dict.fromkeys(kernels, 0), "warp_prep": chain_cfg.warps,
                "tvl1_pd_step": rounds * chain_cfg.inner_iterations,
                "tvl1_pd_step_eps": rounds - chain_cfg.warps,
                "median5": rounds + 1, "tvl1_scale": 1}
    check(chain == expected,
          f"tvl1 at {CHAIN} launched {chain}, expected {expected}")
    check(e_chain == 0.0, f"flow at {CHAIN}, epsilon 0, vs the plain path: "
                          f"{e_chain}")
    emit({"phase": "tvl1_midsize", "by_size": report,
          "chain_level": {"size": list(CHAIN), "levels_take": takes,
                          "launches": chain,
                          "max_abs_vs_plain_path_at_epsilon_0": e_chain}})
    return total, chain


FULL_HD = (1080, 1920)     # a native-resolution frame: every TV-L1 level
                           # of it is above the whole-plane size rule
HD_PAIRS = 2               # pairs per flow call in the K-G checks
TOL_CHUNK_ERR = 1e-5       # K-G band sums, relative (their order differs)


def split_epsilon(torch, err, px, keep) -> float:
    """ε whose ε² lies mid-way (geometrically) in the widest gap between
    the per-pixel errors err / px (where `keep` and positive): sums on
    both sides of the threshold, none within rounding of it."""
    r = torch.unique((err / px)[keep & (err > 0)]).double()
    check(r.numel() >= 2, f"no two errors to split: {r.tolist()}")
    gap = (r[1:] / r[:-1]).argmax()
    return float((r[gap] * r[gap + 1]).sqrt().sqrt())


def band_test_check(torch, ts, prep, state, cfg, h, w, band, tile, halo,
                    iters, at_grid_limit: bool):
    """A round's last ``pd_chunk`` launch with the bands' test, on three
    images built from the level's (prep, state): image 0 with odd bands
    moving 1e-2 as much as even ones, two bands in three running and one
    frozen band still at the first round's inf; image 1 at rest (its error
    is 0: it converges); image 2 frozen whole, its old errors under ε².  ε²
    lies mid-way between image 0's band errors, so sums fall on both sides
    of the bands' thresholds and the images' tests go both ways.  The
    state must equal ``pd_chunk_plain``'s bit for bit; ``err_band`` and
    ``act_next`` equal ``band_flags_plain`` run on the partials the same
    launch wrote (flags exactly, sums to TOL_CHUNK_ERR relative), adaptive
    or not, with and without ``prev_act``.  With `at_grid_limit` the same
    at B = 65,535 images of 8x8, a block each (``tiny_band_test_case``).
    Returns the largest absolute difference of err_band."""
    dev = prep.device
    n_bands = -(-h // band)
    rows = torch.arange(h, device=dev) // band % 2 == 1
    prep3 = torch.stack([prep[0], prep[0], prep[1]])
    state3 = torch.stack([state[0], state[0], state[1]])
    state3[0][:, rows] *= 1e-2
    prep3[0, 3][rows] *= 1e-2
    state3[1], prep3[1, 3] = 0.0, 0.0
    act = torch.ones((3, n_bands), dtype=torch.int32, device=dev)
    act[0, 2::3] = 0
    act[2] = 0
    want, sums = ts.pd_chunk_plain(prep3, state3, act, cfg, iters, band,
                                   False)
    px = torch.tensor([min(band, h - band * j) * w for j in range(n_bands)],
                      dtype=torch.float32, device=dev)
    eps = split_epsilon(torch, sums[0], px, act[0] == 1)
    g = torch.Generator(dev).manual_seed(h)
    old = kept_errors(torch, (3, n_bands), g) * eps ** 2 * px
    old[0, 2] = float("inf")
    old[1] = 0.0
    old[2] *= 0.25
    cases = [dict(prep=prep3, state=state3, act=act, old=old, want=want,
                  band=band, tile=tile, halo=halo, iters=iters, px=px,
                  cfg=dataclasses.replace(cfg, epsilon=eps))]
    if at_grid_limit:
        cases.append(tiny_band_test_case(torch, ts, cfg, dev))
    worst = 0.0
    for c in cases:
        act_, old_ = c["act"], c["old"]
        B, n_b = act_.shape
        h_, w_ = c["state"].shape[2:]
        partial = torch.empty(
            (B, n_b, ts.chunk_partials(h_, w_, c["band"], c["tile"])),
            device=dev)
        count = torch.zeros(B, dtype=torch.int32, device=dev)
        eps_ = c["cfg"].epsilon
        for adaptive in (True, False):
            for prev in (None, act_):
                # With prev_act a band frozen in both launches is left
                # alone: its rows are in the output buffer already.
                out = (c["want"].clone() if prev is not None
                       else torch.full_like(c["state"], float("nan")))
                errs = [old_.clone(), old_.clone()]
                nxt = [torch.full_like(act_, -1), torch.full_like(act_, -1)]
                partial.fill_(float("nan"))
                ts.pd_chunk(c["prep"], c["state"], act_, c["cfg"],
                            c["iters"], c["band"], c["tile"], c["halo"],
                            False, out, partial, prev, count, errs[0], nxt[0],
                            adaptive)
                what = (f"pd_chunk with the bands' test at {B}x{h_}x{w_}, "
                        f"adaptive {adaptive}, prev_act {prev is not None}")
                check(torch.equal(out, c["want"]), f"{what}: state differs")
                check(not bool(count.any()), f"{what}: count left nonzero")
                ts.band_flags_plain(partial, act_, errs[1], nxt[1],
                                    c["band"], h_, w_, eps_, adaptive)
                fin = errs[1].isfinite()
                rel = ((errs[0] - errs[1])[fin].abs()
                       / errs[1][fin].abs().clamp(min=1e-30)).max().item()
                check(torch.equal(nxt[0], nxt[1])
                      and torch.equal(errs[0].isfinite(), fin)
                      and rel <= TOL_CHUNK_ERR,
                      f"{what}: flags {nxt[0].tolist()[:3]} vs "
                      f"{nxt[1].tolist()[:3]}, sums differ by {rel}")
                worst = max(worst, (errs[0] - errs[1])[fin].abs().max().item())
                ratio = (errs[1] / c["px"])[fin] / eps_ ** 2
                check(bool(((ratio - 1).abs() > 1e-3).all()),
                      f"{what}: a band's sum within 1e-3 of its threshold")
                if B == 3:
                    check(bool(nxt[0][0].any()) and not bool(nxt[0][1:].any()),
                          f"{what}: flags {nxt[0].tolist()}")
    return worst


def kept_errors(torch, shape, g):
    """Old errors of frozen bands, per ε² a pixel: on both sides of the
    threshold, none within 10 % of it."""
    r = torch.rand(shape, device=g.device, generator=g)
    return torch.where(r < 0.5, 1.8 * r, 0.2 + 1.8 * r)


def tiny_band_test_case(torch, ts, cfg, dev):
    """The bands' test at the grid's limit: 65,535 images of 8x8 (a block
    and a band each), half of them moving 1e-3 as much as the others,
    every fifth frozen with its old error: a case of
    ``band_test_check``."""
    B, h, w, iters = GRID_YZ, 8, 8, 2
    g = torch.Generator(dev).manual_seed(5)
    scale = 10.0 ** -(3 * torch.randint(0, 2, (B, 1, 1, 1), device=dev,
                                        generator=g)).float()
    prep = torch.rand((B, 4, h, w), device=dev, generator=g)
    prep[:, 3:] = (prep[:, 3:] - 0.5) * scale
    state = (torch.rand((B, 6, h, w), device=dev, generator=g) - 0.5) * scale
    act = torch.ones((B, 1), dtype=torch.int32, device=dev)
    act[::5] = 0
    want, sums = ts.pd_chunk_plain(prep, state, act, cfg, iters, h, False)
    px = torch.full((1,), float(h * w), device=dev)
    eps = split_epsilon(torch, sums[:, 0], px, act[:, 0] == 1)
    old = kept_errors(torch, (B, 1), g) * eps ** 2 * h * w
    return dict(prep=prep, state=state, act=act, old=old, want=want, band=h,
                tile=h, halo=iters, iters=iters, px=px,
                cfg=dataclasses.replace(cfg, epsilon=eps))


def eps_test_check(torch, ts, prep, uv, cfg, at_grid_limit: bool) -> float:
    """A round's last ``pd_step`` with the ε test, on a level's (prep, uv)
    with live dual variables: image b's flow, duals and residual scaled by
    10^-(b mod 4), so the images' errors spread over decades and ε² lies
    mid-way between two of them; image 1 at rest (its error is 0: it
    converges), image 2 frozen.  The new flow and duals of the active
    images must equal ``pd_step_plain``'s bit for bit, and ``err`` and the
    flags equal ``eps_reduce_plain`` run on the partials the same launch
    wrote (flags exactly, err within TOL_EPS of its value: the images'
    errors span decades, and the two sums' orders differ).  With
    `at_grid_limit` the same at B = 65,535 images of 8x8, a block each,
    half of them moving 1e-3 as much as the others.  Returns the largest
    absolute difference of err."""
    dev = uv.device
    B, _, h, w = uv.shape
    g = torch.Generator(dev).manual_seed(h)
    scale = 10.0 ** -(torch.arange(B, device=dev) % 4).float()
    prep = prep.clone()
    prep[:, 3] *= scale[:, None, None]
    uv = uv * scale[:, None, None, None]
    p = 0.3 * torch.randn((B, 4, h, w), device=dev, generator=g)
    p *= scale[:, None, None, None]
    cases = [(prep, uv, p)]
    if at_grid_limit:
        n = GRID_YZ
        s = 10.0 ** -(3 * torch.randint(0, 2, (n, 1, 1, 1), device=dev,
                                        generator=g)).float()
        tp = torch.rand((n, 4, 8, 8), device=dev, generator=g)
        tp[:, 3:] = (tp[:, 3:] - 0.5) * s
        cases.append((tp, (torch.rand((n, 2, 8, 8), device=dev, generator=g)
                           - 0.5) * s,
                      (torch.rand((n, 4, 8, 8), device=dev, generator=g)
                       - 0.5) * s))
    worst = 0.0
    for prep_, uv_, p_ in cases:
        B, _, h, w = uv_.shape
        uv_[1], p_[1], prep_[1, 3] = 0.0, 0.0, 0.0
        want_uv, want_p, want_err = ts.pd_step_plain(prep_, uv_, p_, cfg, True)
        active = torch.ones(B, dtype=torch.int32, device=dev)
        active[2::5] = 0
        eps = split_epsilon(torch, want_err, torch.ones_like(want_err),
                            active == 1)
        gated = dataclasses.replace(cfg, epsilon=eps)
        before = active.clone()
        uv_out, p_out = torch.empty_like(uv_), torch.empty_like(p_)
        partial = torch.full((B, ts.pd_blocks(h, w)), float("nan"),
                             device=dev)
        count = torch.zeros(B, dtype=torch.int32, device=dev)
        err = torch.full((B,), float("inf"), device=dev)
        ts.pd_step(prep_, uv_, p_, active, gated, uv_out, p_out, partial,
                   count, err)
        on = before.bool()
        what = f"pd_step with the ε test at {B}x{h}x{w}"
        check(torch.equal(uv_out[on], want_uv[on])
              and torch.equal(p_out[on], want_p[on])
              and torch.equal(uv_out[~on], uv_[~on]),
              f"{what}: the state differs from pd_step_plain's")
        check(not bool(count.any()), f"{what}: count left nonzero")
        flags, errs = before.clone(), torch.full((B,), float("inf"),
                                                 device=dev)
        ts.eps_reduce_plain(partial, flags, errs, h * w, eps)
        fin = errs.isfinite()
        e = ((err - errs)[fin].abs()
             / errs[fin].abs().clamp(min=1e-30)).max().item()
        check(torch.equal(active, flags) and torch.equal(err.isfinite(), fin)
              and e <= TOL_EPS,
              f"{what}: err differs by {e} relative, flags "
              f"{active.tolist()[:8]} vs {flags.tolist()[:8]}")
        check(bool(active.any()) and bool((on & (active == 0)).any())
              and not bool(active[1]),
              f"{what}: flags {active.tolist()[:8]} do not go both ways")
        worst = max(worst, (err - errs)[fin].abs().max().item())
    return worst


def tvl1_chunk_kernels_phase(torch, np, dev, sweep: bool):
    """K-G ``pd_chunk`` against its plain version at the five level sizes
    of a 1080x1920 frame, a round's last launch with the bands' test
    against ``pd_chunk_plain`` and ``band_flags_plain``
    (``band_test_check``), and ``pd_solve_chunked`` against the
    per-iteration ``pd_solve``.  Returns {name: (max_abs_err, (ms,
    plain_ms, None), bound, device_ms)} for K-G (a full chunk) and its
    round's last launch with the test at 1080x1920."""
    from video_analytics_tpu_torch.config import TVL1Config
    from video_analytics_tpu_torch.flow.tvl1 import (
        _level_sizes, whole_plane_level)
    from video_analytics_tpu_torch.ops.cuda import tvl1_solve as ts
    from video_analytics_tpu_torch.ops.cuda.warp import warp_prep_plain
    from video_analytics_tpu_torch.ops.kernels import centered_gradient

    cfg = TVL1Config()
    K, k = cfg.inner_iterations, cfg.median_filtering
    report, max_err, max_sum_err = {}, 0.0, 0.0
    table = {}
    for h, w in _level_sizes(*FULL_HD, cfg):
        check(not whole_plane_level(h, w, k), f"{h}x{w} is a whole-plane level")
        band, chunk = ts.chunk_params(h, w, cfg)
        tile, halo = ts.chunk_tile(chunk, cfg)
        n_bands = -(-h // band)
        i0 = torch.from_numpy(np.stack([scene(np, b, h, w, seed=b)
                                        for b in range(HD_PAIRS)])).to(dev)
        i1 = torch.from_numpy(np.stack([scene(np, b + 1, h, w, seed=b)
                                        for b in range(HD_PAIRS)])).to(dev)
        i1x, i1y = centered_gradient(i1)
        i13 = torch.stack([i1, i1x, i1y], dim=1).contiguous()
        yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
        uv = torch.from_numpy(np.stack([np.stack(
            [2.5 * np.sin(6 * yy + b), -2.0 * np.cos(5 * xx - b)])
            for b in range(HD_PAIRS)]).astype(np.float32)).to(dev)
        prep = warp_prep_plain(i13, i0, uv)
        on = torch.ones((HD_PAIRS, n_bands), dtype=torch.int32, device=dev)
        # A state with live dual variables: two iterations from p = 0.
        state, _ = ts.pd_chunk_plain(
            prep, torch.cat([uv, torch.zeros((HD_PAIRS, 4, h, w), device=dev)],
                            dim=1), on, cfg, 2, band, False)
        act = on.clone()
        act[0, 1::2] = 0                      # some bands frozen
        act[1, :1] = 0
        out = torch.empty_like(state)
        partial = torch.empty(
            (HD_PAIRS, n_bands, ts.chunk_partials(h, w, band, tile)),
            device=dev)
        rest = K % chunk or chunk
        for iters in sorted({chunk, rest}):
            for do_median in (True, False):
                for flags in (on, act):
                    out.fill_(float("nan"))
                    partial.fill_(float("nan"))
                    ts.pd_chunk(prep, state, flags, cfg, iters, band, tile,
                                halo, do_median, out, partial)
                    err = partial.sum(dim=2)
                    want, want_err = ts.pd_chunk_plain(
                        prep, state, flags, cfg, iters, band, do_median)
                    e = (out - want).abs().max().item()
                    what = (f"pd_chunk at {h}x{w}, {iters} iterations, "
                            f"median {do_median}")
                    check(torch.equal(out, want), f"{what}: max abs {e}")
                    rel = ((err - want_err).abs()
                           / want_err.abs().clamp(min=1e-30)).max().item()
                    check(rel <= TOL_CHUNK_ERR,
                          f"{what}: band sums differ by {rel} relative")
                    max_err, max_sum_err = max(max_err, e), max(max_sum_err,
                                                                rel)
        # A band frozen in two launches running is left alone the second
        # time: `out` holds the first launch's copy of it.
        ts.pd_chunk(prep, state, act, cfg, chunk, band, tile, halo, False,
                    out, partial)
        want, _ = ts.pd_chunk_plain(prep, state, act, cfg, chunk, band, False)
        ts.pd_chunk(prep, state, act, cfg, chunk, band, tile, halo, False,
                    out, partial, act)
        check(torch.equal(out, want),
              f"pd_chunk at {h}x{w} with prev_act: the frozen rows moved")
        off = torch.zeros_like(on)
        times = {
            "ms": cuda_ms(torch, lambda: ts.pd_chunk(
                prep, state, on, cfg, chunk, band, tile, halo, False, out)),
            "ms_with_median": cuda_ms(torch, lambda: ts.pd_chunk(
                prep, state, on, cfg, chunk, band, tile, halo, True, out)),
            "ms_with_error_sums": cuda_ms(torch, lambda: ts.pd_chunk(
                prep, state, on, cfg, chunk, band, tile, halo, False, out,
                partial)),
            "ms_all_frozen": cuda_ms(torch, lambda: ts.pd_chunk(
                prep, state, off, cfg, chunk, band, tile, halo, False, out)),
            "ms_all_frozen_before_too": cuda_ms(torch, lambda: ts.pd_chunk(
                prep, state, off, cfg, chunk, band, tile, halo, False, out,
                None, off)),
            "plain_ms": cuda_ms(torch, lambda: ts.pd_chunk_plain(
                prep, state, on, cfg, chunk, band, False), 3)}
        b_ms, b_by = chunk_bound(HD_PAIRS, h, w, chunk, 0)
        bm_ms, _ = chunk_bound(HD_PAIRS, h, w, chunk, k)
        report[f"{h}x{w}"] = {"band": band, "chunk": chunk, "tile": tile,
                              "halo": halo, **times, "bound_ms": b_ms,
                              "bound_by": b_by,
                              "bound_ms_with_median": bm_ms}
        # The round's last launch with the bands' test, against the plain
        # versions on the same inputs (band_test_check), then timed with
        # every band active, as the main path runs it, beside the same
        # launch without the test.
        rest = K % chunk or chunk
        flag_err = band_test_check(torch, ts, prep, state, cfg, h, w, band,
                                   tile, halo, rest, (h, w) == FULL_HD)
        count = torch.zeros(HD_PAIRS, dtype=torch.int32, device=dev)
        err_band = torch.full((HD_PAIRS, n_bands), float("inf"), device=dev)
        nxt = torch.empty_like(on)

        def fused():
            ts.pd_chunk(prep, state, on, cfg, rest, band, tile, halo, False,
                        out, partial, None, count, err_band, nxt)

        def plain_round_end():
            _, sums = ts.pd_chunk_plain(prep, state, on, cfg, rest, band,
                                        False)
            ts.band_flags_plain(sums[..., None], on, err_band.clone(),
                                nxt.clone(), band, h, w, cfg.epsilon, True)

        px = HD_PAIRS * h * w
        n_part = partial.numel()
        # The launch's planes, its partials written and read back, and the
        # bands' flags read and written with their errors.
        fused_bound = bound(16 * 4 * px + 8 * n_part + 12 * on.numel(),
                            70 * rest * px + n_part)
        times.update({
            "round_end_ms": cuda_ms(torch, fused),
            "round_end_plain_ms": cuda_ms(torch, plain_round_end, 3),
            "round_end_bound_ms": fused_bound[0],
            "round_end_bound_by": fused_bound[1],
            "round_end_iterations": rest})
        report[f"{h}x{w}"].update(
            {k: v for k, v in times.items() if k.startswith("round_end")})
        if (h, w) == FULL_HD:
            table["tvl1_pd_chunk"] = (
                max_err, (times["ms"], times["plain_ms"], None), (b_ms, b_by),
                device_ms(torch, lambda: ts.pd_chunk(
                    prep, state, on, cfg, chunk, band, tile, halo, False,
                    out), "pd_chunk_kernel"))
            with_test = device_ms(torch, fused, "pd_chunk_kernel")
            report[f"{h}x{w}"].update({
                "round_end_device_ms": with_test,
                "round_end_device_ms_without_test": device_ms(
                    torch, lambda: ts.pd_chunk(
                        prep, state, on, cfg, rest, band, tile, halo, False,
                        out, partial), "pd_chunk_kernel")})
            table["tvl1_pd_chunk_flags"] = (
                flag_err, (times["round_end_ms"],
                           times["round_end_plain_ms"], None),
                fused_bound, with_test)
            # One whole warp, both solvers.  At epsilon = 0 no flag clears
            # and the tiling cannot show: bit for bit.
            exact = dataclasses.replace(cfg, epsilon=0.0, outer_iterations=2)
            got = ts.pd_solve_chunked(prep, uv, exact, band, chunk, False)
            chain = ts.pd_solve(prep, uv, exact)
            check(torch.equal(got, chain),
                  "pd_solve_chunked(adaptive=False) != pd_solve at epsilon 0: "
                  f"{(got - chain).abs().max().item()}")
            check(torch.equal(got, ts.pd_solve_chunked(prep, uv, exact, band,
                                                       chunk, True)),
                  "adaptive differs from non-adaptive with no band converged")
            # With the default epsilon the gates decide: the sums' order may
            # flip a round, so the bound is the reference's 10 * epsilon.
            got = ts.pd_solve_chunked(prep, uv, cfg, band, chunk, False)
            chain = ts.pd_solve(prep, uv, cfg)
            gated = (got - chain).abs().max().item()
            check(gated <= 10 * cfg.epsilon,
                  f"pd_solve_chunked vs pd_solve, gated: {gated}")
            adaptive = ts.pd_solve_chunked(prep, uv, cfg, band, chunk, True)
            a_dev = (adaptive - chain).abs().max().item()
            check(a_dev <= 10 * cfg.epsilon,
                  f"adaptive pd_solve_chunked vs pd_solve: {a_dev}")
            report["one_warp_1080x1920"] = {
                "pairs": HD_PAIRS,
                "gated_max_abs_vs_chain": gated,
                "adaptive_max_abs_vs_chain": a_dev,
                "chunked_adaptive_ms": cuda_ms(
                    torch, lambda: ts.pd_solve_chunked(prep, uv, cfg, band,
                                                       chunk, True), 2),
                "chunked_ms": cuda_ms(
                    torch, lambda: ts.pd_solve_chunked(prep, uv, cfg, band,
                                                       chunk, False), 2),
                "chain_ms": cuda_ms(
                    torch, lambda: ts.pd_solve(prep, uv, cfg), 2),
                "launches_chunked": cfg.outer_iterations * -(-K // chunk),
                "launches_chain": cfg.outer_iterations * (K + 1)}
            if sweep:
                sw = {}
                for c in (2, 3, 4, 5, 6, 8, 10, 15):
                    t, _ = ts.chunk_tile(c, cfg)
                    sw[c] = {"tile": t, "ms": cuda_ms(
                        torch, lambda: ts.pd_solve_chunked(
                            prep, uv, cfg, _TILE_ROWS * t, c, False), 2)}
                report["chunk_sweep_1080x1920"] = sw
    emit({"phase": "tvl1_chunk_kernels", "pairs": HD_PAIRS,
          "state_max_abs_err": max_err, "state_bit_exact": True,
          "band_sum_max_rel_err": max_sum_err, "tolerance": TOL_CHUNK_ERR,
          "by_level": report})
    return table


_TILE_ROWS = 4     # tile rows per gating band in the chunk sweep

HD_FRAMES = 11             # 10 pairs: one stack of the flow stream's fields
CLIP_FRAMES = 24           # the classify-clip phase's 1080p clip
CLIP_WINDOWS = 3


def hd_frames(np, n: int, seed: int):
    """n RGB frames of 1080x1920, uint8: one texture translating by VEL
    pixels per frame, its three channels at different gains."""
    planes = [scene(np, t, *FULL_HD, seed=seed) for t in range(n)]
    return np.stack([np.stack([g * img for g in (1.0, 0.85, 0.7)], axis=-1)
                     for img in planes]).round().astype(np.uint8)


def run_cli(argv):
    """The port's command line in this process.  Returns (exit code, the
    JSON object of its last output line or None)."""
    import contextlib
    import io

    from video_analytics_tpu_torch.cli.main import main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(argv)
    lines = buf.getvalue().strip().splitlines()
    return rc, json.loads(lines[-1]) if lines else None


def median_levels(torch, dev, pairs: int = 2):
    """K-C at k = 5 at the five TV-L1 levels of 1080x1920, `pairs` pairs
    of (u, v) planes with ties, a constant region and zeros of both signs,
    every image active (as the scale-end median of a flow call runs it):
    equal to the plain version by value, its device duration and the plain
    version's time, and the bound, with the pruned Batcher network's
    operations beside it.  Returns {level: numbers}."""
    from video_analytics_tpu_torch.config import TVL1Config
    from video_analytics_tpu_torch.flow.tvl1 import _level_sizes
    from video_analytics_tpu_torch.ops.cuda import tvl1_solve as ts

    g = torch.Generator(dev).manual_seed(21)
    on = torch.ones(pairs, dtype=torch.int32, device=dev)
    report = {}
    for h, w in _level_sizes(*FULL_HD, TVL1Config()):
        uv = torch.round(4.0 * torch.randn((pairs, 2, h, w), device=dev,
                                           generator=g)) / 2.0
        uv[:, :, : h // 3, : w // 3] = 1.5
        uv[torch.rand(uv.shape, device=dev, generator=g) < 0.1] = -0.0
        out = torch.empty_like(uv)
        check(torch.equal(ts.median5(uv, 5, on, out=out),
                          ts.median5_plain(uv, 5, on)),
              f"median5 at {h}x{w} is not the plain version's")
        px = pairs * 2 * h * w
        b = bound(8 * px, median_ops(5) * px)
        report[f"{h}x{w}"] = {
            "device_ms": device_ms(torch, lambda: ts.median5(uv, 5, on,
                                                            out=out),
                                   "median_kernel"),
            "ms": cuda_ms(torch, lambda: ts.median5(uv, 5, on, out=out), 10),
            "plain_ms": cuda_ms(torch, lambda: ts.median5_plain(uv, 5, on),
                                2),
            "bound_ms": b[0], "bound_by": b[1],
            "bound_ms_batcher_network": bound(
                8 * px, 2 * ROOFLINE.BATCHER_25 * px)[0]}
        del uv, out
    return report


def tvl1_1080p_phase(torch, np, dev, work: str):
    """``compute-flow --algo tvl1`` with ``TVL1Config()`` on a frames
    directory of 1080x1920 frames under `work`, with the launch counts of
    the TV-L1 kernels set to 0 just before the command and held to the
    expected numbers just after; the first pair's flow against the plain
    path's.  Returns (launches per kernel, frames directory, flow
    directory)."""
    from video_analytics_tpu_torch.cli.main import _load_frames
    from video_analytics_tpu_torch.config import TVL1Config
    from video_analytics_tpu_torch.flow.tvl1 import tvl1
    from video_analytics_tpu_torch.io.flowio import read_flo
    from video_analytics_tpu_torch.io.video import write_frames
    from video_analytics_tpu_torch.ops.cuda import tvl1_solve as ts
    from video_analytics_tpu_torch.ops.cuda.warp import warp_prep
    from video_analytics_tpu_torch.ops.preprocess import rgb_to_gray

    cfg = TVL1Config()
    src, out = os.path.join(work, "frames_1080p"), os.path.join(work,
                                                                "flow_1080p")
    write_frames(hd_frames(np, HD_FRAMES, seed=5), src)
    kernels = {"tvl1_pd_chunk": ts.pd_chunk,
               "tvl1_pd_chunk_flags": TestLaunches(ts.pd_chunk),
               "warp_prep": warp_prep, "median5": ts.median5,
               "tvl1_pd_step": ts.pd_step,
               "tvl1_pd_step_eps": TestLaunches(ts.pd_step),
               "tvl1_scale": ts.pd_solve_scale}
    zero_counts(kernels)
    t0 = time.perf_counter()
    rc, res = run_cli(["compute-flow", src, out, "--algo", "tvl1", "--format",
                       "flo", "--batch", str(CF_BATCH), "--no-bucket",
                       "--device", "cuda"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts(kernels)
    check(rc == 0 and res["flows"] == HD_FRAMES - 1,
          f"compute-flow --algo tvl1 exited {rc}: {res}")

    # Each flow call of --batch pairs runs, per level, `warps` times one
    # warp_prep and one chunked solve (outer_iterations rounds of
    # ceil(K / chunk) launches, the last of a round but the warp's last
    # ending with the bands' test), then the scale-end median.  Every level
    # of a 1080x1920 frame is above the size rule: neither the
    # per-iteration kernels nor the cluster solver are launched at all.
    calls = -(-(HD_FRAMES - 1) // CF_BATCH)
    per_call = expected_flow_launches("tvl1", *FULL_HD)
    check(per_call["tvl1_scale"] == 0, f"a 1080p level fits a cluster: "
                                       f"{per_call}")
    expected = {k: calls * per_call[k] for k in kernels}
    check(launches == expected,
          f"compute-flow --algo tvl1 launched {launches}, expected {expected}")
    files = sorted(f for f in os.listdir(out) if f.endswith(".flo"))
    check(len(files) == HD_FRAMES - 1, f"{len(files)} .flo files")
    flow = read_flo(os.path.join(out, files[0]))
    check(flow.shape == (*FULL_HD, 2) and bool(np.isfinite(flow).all()),
          f"flow read back: {flow.shape}")
    mean = flow[64:-64, 64:-64].reshape(-1, 2).mean(0).tolist()
    check(abs(mean[0] - VEL[0]) < TOL_MEAN_FLOW
          and abs(mean[1] - VEL[1]) < TOL_MEAN_FLOW,
          f"1080p TV-L1 mean flow {mean}, expected {VEL}")

    # The same pair through the plain versions, from the same decoded
    # frames.  The kernels' states are bit-equal to the plain versions'; a
    # band's error sum is taken in another order and can flip a flag at the
    # threshold, which moves the flow by less than the reference's bound
    # for a skipped round, 10 * epsilon.
    with torch.no_grad():
        gray = rgb_to_gray(torch.from_numpy(_load_frames(src, 3)).to(dev))
        plain = tvl1(gray[:1], gray[1:2], cfg, plain=True)[0].cpu().numpy()
        dev_abs = float(np.abs(flow - plain).max())
        check(dev_abs <= 10 * cfg.epsilon,
              f"1080p flow vs the plain path: max abs {dev_abs}")
        # With no gate to flip (epsilon = 0, at a smaller depth) the whole
        # pyramid is the plain path's to the bit.
        exact = dataclasses.replace(cfg, epsilon=0.0, warps=2,
                                    outer_iterations=2)
        e_exact = float((tvl1(gray[:1], gray[1:2], exact)
                         - tvl1(gray[:1], gray[1:2], exact, plain=True)
                         ).abs().max())
        check(e_exact == 0.0,
              f"1080p flow at epsilon 0 vs the plain path: {e_exact}")

        def flow_call():
            return tvl1(gray[:2], gray[1:3], cfg)

        def chain_call():
            return tvl1(gray[:2], gray[1:3], cfg,
                        whole_plane=lambda h, w, k: True)

        chain_dev = float((flow_call() - chain_call()).abs().max())
        check(chain_dev <= 10 * cfg.epsilon,
              f"1080p flow, chunked vs per-iteration path: {chain_dev}")
        # One flow call of 2 pairs launches the command's kernels per call
        # and nothing else: no kernel of its own for any convergence test.
        zero, read = flow_counters()
        zero()
        flow_call()
        call_launches = read()
        want = per_call
        check(call_launches == want,
              f"a 2-pair 1080p flow call launched {call_launches}, expected "
              f"{want}")
        call_ms = cuda_ms(torch, flow_call, 2)
        chain_ms = cuda_ms(torch, chain_call, 2)
        prof = device_profile(torch, flow_call)
        seen = {short_kernel_name(k["name"]).split("<")[0]
                for k in prof["port_kernels_device_ms"]}
        check(seen <= {"pd_chunk_kernel", "warp_prep_kernel", "median_kernel"},
              f"a 1080p flow call ran port kernels {seen}")
    medians = median_levels(torch, dev)
    emit({"phase": "tvl1_1080p", "frames": HD_FRAMES, "batch": CF_BATCH,
          "command_seconds": seconds,
          "command_seconds_per_pair": seconds / (HD_FRAMES - 1),
          "launches": launches, "launches_per_flow_call": call_launches,
          "mean_flow": mean, "max_abs_vs_plain_path": dev_abs,
          "bit_equal_to_plain_path": bool(np.array_equal(flow, plain)),
          "tolerance": 10 * cfg.epsilon,
          "max_abs_vs_plain_path_at_epsilon_0": e_exact,
          "flow_call_pairs": 2, "flow_call_ms": call_ms,
          "flow_call_ms_per_pair": call_ms / 2,
          "flow_call_ms_per_iteration_path": chain_ms,
          "max_abs_vs_per_iteration_path": chain_dev,
          "busy_share_of_unprofiled": prof["device_busy_ms"] / call_ms,
          "profile": prof, "median5_min_max_per_output": median_ops(5),
          "median5_levels_2_pairs": medians, **CARD})
    return launches, src, out


def stage_chain_phase(torch, np, dev, work: str, frames_dir: str,
                      flow_dir: str):
    """A checkpoint written from seed 0, then ``extract-features`` on the
    stored flow and on the frames of the phase before, and ``classify-clip
    --checkpoint`` on a 1080p clip, each at full width and held against
    the same steps taken on tensors with the kernels' plain versions."""
    from video_analytics_tpu_torch.cli.main import _load_frames
    from video_analytics_tpu_torch.config import PipelineConfig
    from video_analytics_tpu_torch.ingest.windows import apply_transport_crop
    from video_analytics_tpu_torch.io.flowio import read_flow_dir
    from video_analytics_tpu_torch.io.video import synthesize_video
    from video_analytics_tpu_torch.models.two_stream import TwoStreamModel
    from video_analytics_tpu_torch.ops import preprocess as pp
    from video_analytics_tpu_torch.ops.cuda import tvl1_solve as ts
    from video_analytics_tpu_torch.ops.cuda.warp import warp_prep
    from video_analytics_tpu_torch.runtime import pipeline
    from video_analytics_tpu_torch.runtime.checkpoint import (
        load_variables, save_variables)
    from video_analytics_tpu_torch.runtime.evaluate import classify_clip_file

    cfg = PipelineConfig()
    pre = cfg.preprocess

    def make():
        return TwoStreamModel.create(num_classes=cfg.num_classes,
                                     flow_stack=pre.flow_stack, width=64)

    ckpt = os.path.join(work, "two_stream.msgpack")
    written = make().init(torch.Generator().manual_seed(0))
    save_variables(ckpt, written.flax_variables())
    model = make()
    model.load_flax_variables(load_variables(ckpt, model.flax_variables()))
    for k, v in written.state_dict().items():
        check(torch.equal(model.state_dict()[k], v),
              f"checkpoint round trip changed {k}")
    model = model.to(dev).eval()
    dim = model.temporal.feature_dim

    def close(got, want, what):
        e = float(np.abs(got - want).max())
        check(got.shape == want.shape and bool(np.isfinite(got).all())
              and e <= TOL_PROBS * max(1.0, float(np.abs(want).max())),
              f"{what}: max abs {e}")
        return e

    # 1. The stored flow of compute-flow: resize, per-axis rescale, crop.
    out1 = os.path.join(work, "features_flow.npz")
    rc, res = run_cli(["extract-features", flow_dir, out1, "--stream", "flow",
                       "--checkpoint", ckpt, "--device", "cuda"])
    check(rc == 0 and res.get("source") == "flow_dir"
          and res["flow"] == [1, dim], f"extract-features (flow dir): {res}")
    with torch.no_grad():
        f = torch.from_numpy(read_flow_dir(flow_dir)).to(dev)
        h, w = f.shape[1], f.shape[2]
        f = pp.resize_short_side(f, pre.resize_short)
        f = f * torch.tensor([f.shape[2] / w, f.shape[1] / h], device=dev)
        f = pp.center_crop(f, pre.crop)
        want = model.temporal(pp.stacked_flow_input(
            f, pre.flow_stack, pre.flow_bound), return_features=True)
    e_stored = close(np.load(out1)["flow"], want.cpu().numpy(),
                     "flow features of the stored flow")

    # 2. The frames: both streams, TV-L1 on the 224² crop (every level
    # there fits a cluster: tvl1_scale, and nothing else).
    kernels = {"tvl1_scale": ts.pd_solve_scale, "warp_prep": warp_prep,
               "median5": ts.median5, "tvl1_pd_step": ts.pd_step,
               "tvl1_pd_step_eps": TestLaunches(ts.pd_step),
               "tvl1_pd_chunk": ts.pd_chunk}
    out2 = os.path.join(work, "features_frames.npz")
    zero_counts(kernels)
    rc, res = run_cli(["extract-features", frames_dir, out2, "--stream",
                       "both", "--algo", "tvl1", "--checkpoint", ckpt,
                       "--device", "cuda"])
    xf_launches = read_counts(kernels)
    check(rc == 0 and res["rgb"] == [HD_FRAMES, dim]
          and res["flow"] == [1, dim], f"extract-features (frames): {res}")
    # Its 10 pairs ride in one flow batch: one launch per scale.
    n_scales = len(SIZES)
    check(xf_launches == {**dict.fromkeys(kernels, 0),
                          "tvl1_scale": n_scales},
          f"extract-features on the 224² crop launched {xf_launches}")
    with torch.no_grad():
        frames, fcfg = apply_transport_crop(_load_frames(frames_dir, None),
                                            cfg)
        x = torch.from_numpy(frames).to(dev)
        want_rgb = pipeline.rgb_features(x, model.spatial, fcfg.preprocess)
        stacks = pipeline._flow_stacks(pipeline._crop(x, fcfg)[None], fcfg,
                                       plain=True)[0]
        want_flow = model.temporal(stacks, return_features=True)
    got = np.load(out2)
    e_rgb = close(got["rgb"], want_rgb.cpu().numpy(), "rgb features")
    e_flow = close(got["flow"], want_flow.cpu().numpy(),
                   "flow features of the frames")

    # 3. A 1080p clip through classify-clip.
    clip = synthesize_video(os.path.join(work, "clip_1080p.mp4"),
                            hd_frames(np, CLIP_FRAMES, seed=6))
    zero_counts(kernels)
    t0 = time.perf_counter()
    rc, res = run_cli(["classify-clip", clip, "--checkpoint", ckpt,
                       "--windows", str(CLIP_WINDOWS), "--topk",
                       str(cfg.num_classes), "--device", "cuda"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    cc_launches = read_counts(kernels)
    check(rc == 0 and len(res["topk"]) == cfg.num_classes,
          f"classify-clip: {rc}")
    # Its windows' 45 pairs ride in one flow batch: one launch per scale.
    check(cc_launches == {**dict.fromkeys(kernels, 0),
                          "tvl1_scale": n_scales},
          f"classify-clip launched {cc_launches}")
    probs = np.zeros(cfg.num_classes, np.float32)
    for entry in res["topk"]:
        probs[entry["class_id"]] = entry["prob"]
    check(abs(float(probs.sum()) - 1.0) < 1e-4, f"probs sum {probs.sum()}")
    check(res["top1"] == int(probs.argmax()), "top1 is not the argmax")
    plain = classify_clip_file(clip, model, cfg, dev,
                               num_windows=CLIP_WINDOWS, plain=True)
    e_probs = float(np.abs(plain - probs).max())
    check(e_probs <= TOL_PROBS,
          f"classify-clip probs vs plain versions: {e_probs} > {TOL_PROBS}")
    emit({"phase": "stage_chain", "checkpoint_bytes": os.path.getsize(ckpt),
          "features_max_abs_vs_tensors": {"stored_flow": e_stored,
                                          "rgb": e_rgb, "flow": e_flow},
          "extract_features_launches": xf_launches,
          "classify_clip": {"frames": CLIP_FRAMES, "windows": CLIP_WINDOWS,
                            "seconds": seconds, "top1": res["top1"],
                            "probs_max_abs_vs_plain": e_probs,
                            "launches": cc_launches},
          "tolerance": TOL_PROBS})



EVAL_CLASSES = 4           # the synthetic UCF101: 4 classes x 4 clips, half
EVAL_CLIPS_PER_CLASS = 4   # of them test clips: 8, at UCF101's 240x320
EVAL_FRAMES = 48
EVAL_BATCH = 8             # --batch-clips: the 8 test clips in one batch


def eval_ucf101_phase(torch, np, dev):
    """``tpuva-torch eval-ucf101`` on a synthetic UCF101 at 240x320 (8 test
    clips and a truncated one) from a full-width checkpoint written from
    seed 0: ``--batched`` (120 frame pairs in one ``tvl1`` call), with
    ``--windows 3`` (360), clip by clip with a manifest and a predictions
    file, again on that manifest, and ``--batched --algo farneback``; the
    launch counts set to 0 just before each command and held to the
    expected numbers just after.  One batch of the first run and one of
    the Farneback run through the batch function with the kernels and with
    their plain versions, and the ``tvl1_scale`` launches of the 120- and
    360-pair calls profiled.  Returns the launches per kernel summed over
    the commands."""
    import tempfile

    from video_analytics_tpu_torch.config import PipelineConfig
    from video_analytics_tpu_torch.flow.farneback import _level_sizes
    from video_analytics_tpu_torch.io.synthetic import build_synthetic_ucf101
    from video_analytics_tpu_torch.models.two_stream import TwoStreamModel
    from video_analytics_tpu_torch.runtime import evaluate as ev
    from video_analytics_tpu_torch.runtime.checkpoint import save_variables

    cfg = PipelineConfig()
    pairs = cfg.window - 1
    n_scales = len(SIZES)
    zero, read = main_path_counters()
    nothing = dict.fromkeys(read(), 0)
    # What the batch function was called with in a command (one call a
    # batch), and the order in which the decode workers handed the clips
    # over: the rows of a batch.
    calls, streamed, started = [], [], []
    real_metrics, real_prefetch = ev.batch_clip_metrics, ev.prefetch_clips

    def metrics_spy(windows, labels, valid, model, bcfg, *rest, **kw):
        out = real_metrics(windows, labels, valid, model, bcfg, *rest, **kw)
        calls.append((windows, bcfg, out[1]))
        return out

    def prefetch_spy(*a, **kw):
        started.append(time.perf_counter())
        for item in real_prefetch(*a, **kw):
            streamed.append(item[0])
            yield item

    def command(base, extra, expected):
        """One command with every launch count set to 0 just before it and
        held to `expected` (the rest 0) just after."""
        del calls[:], streamed[:], started[:]
        zero()
        t0 = time.perf_counter()
        rc, res = run_cli(base + extra)
        torch.cuda.synchronize()
        end = time.perf_counter()
        launches = read()
        check(rc == 0, f"eval-ucf101 {extra} exited {rc}: {res}")
        want = {**nothing, **expected}
        check(launches == want,
              f"eval-ucf101 {extra} launched {launches}, expected {want}")
        run = {"seconds": end - t0, "launches": launches}
        if started:         # --batched: from the start of its decode
            run["eval_seconds"] = end - started[0]
        return res, run

    runs = {}
    ev.batch_clip_metrics, ev.prefetch_clips = metrics_spy, prefetch_spy
    try:
        with tempfile.TemporaryDirectory() as work:
            ds = build_synthetic_ucf101(
                os.path.join(work, "ucf101"), num_classes=EVAL_CLASSES,
                clips_per_class=EVAL_CLIPS_PER_CLASS, num_frames=EVAL_FRAMES,
                h=NATIVE[0], w=NATIVE[1], seed=0)
            n_clips = len(ds.test_records())
            # A corrupt clip in the test list: a truncated container.
            corrupt = os.path.join(ds.videos_root, "Right",
                                   "v_Right_g99_c01.avi")
            with open(ds.test_records()[0].path, "rb") as f, \
                    open(corrupt, "wb") as g:
                g.write(f.read(256))
            with open(os.path.join(ds.annotations_root, "testlist01.txt"),
                      "a") as f:
                f.write("Right/v_Right_g99_c01.avi\n")
            ckpt = os.path.join(work, "two_stream.msgpack")
            model = TwoStreamModel.create(
                num_classes=cfg.num_classes,
                flow_stack=cfg.preprocess.flow_stack,
                width=64).init(torch.Generator().manual_seed(0))
            save_variables(ckpt, model.flax_variables())
            model = model.to(dev).eval()
            base = ["eval-ucf101", "--videos", ds.videos_root,
                    "--annotations", ds.annotations_root, "--checkpoint",
                    ckpt, "--device", "cuda"]

            def counts_ok(res, what):
                check(res["total"] == n_clips and res["failed"] == 1
                      and res["failures"][0]["path"] == corrupt
                      and 0 <= res["correct"] <= n_clips,
                      f"eval-ucf101 {what}: {res}")

            # 1. --batched: one batch of 8 clips, 120 pairs in one call.
            batched = ["--batched", "--batch-clips", str(EVAL_BATCH)]
            res, runs["batched"] = command(base, batched,
                                           {"tvl1_scale": n_scales,
                                            **norm_expected(1)})
            counts_ok(res, "--batched")
            check(len(calls) == 1 and tuple(calls[0][0].shape[:3])
                  == (n_clips, 1, cfg.window),
                  f"--batched: batches {[c[0].shape for c in calls]}")
            one = calls[0]
            batch_preds = dict(zip(streamed, one[2].tolist()))
            runs["batched"].update(result=res, pairs_per_tvl1_call=n_clips
                                   * pairs)
            # Again: the first run's seconds hold the first calls at its
            # shapes (cuDNN's choice of algorithms, allocations).
            res_again, runs["batched_again"] = command(
                base, batched, {"tvl1_scale": n_scales, **norm_expected(1)})
            check(res_again == res, f"--batched again: {res_again} != {res}")

            # 2. --windows 3: 360 pairs in one call.
            res3, runs["batched_windows3"] = command(
                base, batched + ["--windows", "3"],
                {"tvl1_scale": n_scales, **norm_expected(1)})
            counts_ok(res3, "--batched --windows 3")
            check(len(calls) == 1
                  and tuple(calls[0][0].shape[:2]) == (n_clips, 3),
                  f"--windows 3: batches {[c[0].shape for c in calls]}")
            three = calls[0]
            runs["batched_windows3"].update(result=res3,
                                            pairs_per_tvl1_call=3 * n_clips
                                            * pairs)

            # 3. Clip by clip, then again on the same manifest.
            preds_file = os.path.join(work, "predictions.jsonl")
            seq = ["--predictions", preds_file, "--manifest",
                   os.path.join(work, "manifest.txt")]
            res_s, runs["sequential"] = command(
                base, seq, {"tvl1_scale": n_scales * n_clips,
                            **norm_expected(n_clips)})
            counts_ok(res_s, "sequential")
            with open(preds_file) as f:
                seq_preds = {e["path"]: e["pred"]
                             for e in map(json.loads, f.read().splitlines())}
            check(seq_preds == batch_preds
                  and res_s["correct"] == res["correct"],
                  f"sequential predictions {seq_preds}, correct "
                  f"{res_s['correct']}; --batched {batch_preds}, "
                  f"{res['correct']}")
            runs["sequential"]["result"] = res_s
            res_r, runs["sequential_rerun"] = command(base, seq, {})
            check(res_r["total"] == 0 and res_r["failed"] == 1,
                  f"rerun on the manifest: {res_r}")
            runs["sequential_rerun"]["result"] = res_r

            # 4. Farneback, batched.
            fcfg = cfg.farneback
            res_f, runs["farneback_batched"] = command(
                base, batched + ["--algo", "farneback"],
                {**fb_expected(len(_level_sizes(cfg.preprocess.crop,
                                                cfg.preprocess.crop, fcfg)),
                               fcfg.iterations), **norm_expected(1)})
            counts_ok(res_f, "--batched --algo farneback")
            fb_one = calls[0]
            runs["farneback_batched"]["result"] = res_f
    finally:
        ev.batch_clip_metrics, ev.prefetch_clips = real_metrics, real_prefetch
    # Clips a second over the whole command (checkpoint load and model
    # set-up included) and, for --batched, from the start of its
    # decode to the end of its device work.
    for name in ("batched", "batched_again", "batched_windows3",
                 "sequential", "farneback_batched"):
        runs[name]["clips_per_s"] = n_clips / runs[name]["seconds"]
        if "eval_seconds" in runs[name]:
            runs[name]["eval_clips_per_s"] = (n_clips
                                              / runs[name]["eval_seconds"])

    # Answer agreement: a batch of run 1 and one of run 4 through the batch
    # function with the kernels and with their plain versions.
    agree = {}
    for name, (windows, bcfg, preds) in (("tvl1", one),
                                         ("farneback", fb_one)):
        got = ev.batch_clip_probs(windows, model, bcfg)
        want = ev.batch_clip_probs(windows, model, bcfg, plain=True)
        e = float((got - want).abs().max())
        check(e <= TOL_PROBS and torch.equal(got.argmax(-1), preds),
              f"eval batch ({name}) vs plain versions: {e} > {TOL_PROBS}")
        agree[name] = e
    # The device time of the tvl1_scale launches of the 120- and 360-pair
    # calls (their count is checked above, from the wrapper).  A profile
    # short of the count is taken again; if none has it, the time is not
    # measured (null).
    scale_ms = {}
    for name, (windows, bcfg, _) in (("pairs_120", one),
                                     ("pairs_360", three)):
        def scale_hits(prof):
            return [k for k in prof["port_kernels_device_ms"]
                    if "pd_warp_kernel" in k["name"]]

        prof, ok = device_profile_until(
            torch, lambda: ev.batch_clip_probs(windows, model, bcfg),
            lambda p: sum(k["count"] for k in scale_hits(p)) == n_scales)
        hits = scale_hits(prof)
        scale_ms[name] = {"tvl1_scale_device_ms":
                          sum(k["ms"] for k in hits) if ok else None,
                          "by_launch": hits,
                          "batch_call_wall_ms": prof["profiled_wall_ms"],
                          "device_busy_ms": prof["device_busy_ms"]}
    emit({"phase": "eval_ucf101", "clips": n_clips, "corrupt": 1,
          "frames": EVAL_FRAMES, "size": list(NATIVE),
          "batch_clips": EVAL_BATCH, "runs": runs,
          "probs_max_abs_vs_plain": agree, "tolerance": TOL_PROBS,
          "tvl1_scale_per_batch_call": scale_ms})
    total = dict(nothing)
    for run in runs.values():
        for k, n in run["launches"].items():
            total[k] += n
    return total


TRAIN_BATCH = 32           # train's --batch default
TRAIN_STEPS = 6            # steps of each TV-L1 train command
TRAIN_FB_STEPS = 3         # steps of the Farneback train command
# One train step on the card against the same step on the CPU (cuDNN
# against the CPU's convolutions, both float32 with TF32 off): the loss
# to 1e-4 relative; the accuracy to one window of the batch (a near-tie
# among 101 random-weight logits may fall either way).
TOL_TRAIN_LOSS = 1e-4
# The BatchNorm running variance against 0.9·old + 0.1·(the biased
# variance of the layer's input, in float64): float32 sums over the batch.
TOL_BN_VAR = 1e-5


def train_windows(np, n: int, t: int, seed: int):
    """n RGB windows of t frames at UCF101's 240x320, uint8: window b one
    texture moving by VEL, its channels at different gains."""
    out = []
    for b in range(n):
        planes = [scene(np, k, *NATIVE, seed=seed + b) for k in range(t)]
        out.append(np.stack([np.stack([g * img for g in (1.0, 0.85, 0.7)],
                                      axis=-1) for img in planes]))
    return np.stack(out).round().astype(np.uint8)


def train_phase(torch, np, dev):
    """``train`` at full width: two ResNet-18s of width 64, 101 classes,
    crop 224, ``flow_stack`` 10, batch 32, ``TVL1Config()``.

    1. ``build_examples`` on 32 in-memory 11-frame windows of 240x320
       through the kernels and through their plain versions, the same
       crops: equal, with 5 ``tvl1_scale`` launches (TV-L1) and 3 K-D + 9
       ``fb_iteration`` (Farneback) and nothing else;
    2. one two-stream step from the same weights and examples on the card
       and on the CPU: loss and accuracy within TOL_TRAIN_LOSS; the last
       BatchNorm of each stream against the biased-variance rule;
    3. the loop of the command (sampler, DevicePrefetcher, train_iter) on
       a synthetic UCF101 with a StageTimer: ms per stage and per step,
       every prefetched batch equal to its host batch; the device-busy
       share of a step under torch.profiler; the peak memory;
    4. ``tpuva-torch train`` decoding every window, twice with
       ``--cache-dir`` (filling it, then from it: no decode) and once with
       ``--algo farneback``, the
       launch counts set to 0 just before each and held to the expected
       numbers just after; steps/s over steps 2-6 from CUDA events; then
       ``eval-ucf101 --batched`` and ``classify-clip`` on the checkpoint.

    Returns the launches per kernel summed over the train commands."""
    import copy
    import tempfile

    from video_analytics_tpu_torch.config import PipelineConfig
    from video_analytics_tpu_torch.flow.farneback import _level_sizes
    from video_analytics_tpu_torch.ingest.prefetch import DevicePrefetcher
    from video_analytics_tpu_torch.ingest.train_loader import (
        TrainWindowSampler)
    from video_analytics_tpu_torch.io.synthetic import build_synthetic_ucf101
    from video_analytics_tpu_torch.models.two_stream import TwoStreamModel
    from video_analytics_tpu_torch.runtime import train_two_stream as tts
    from video_analytics_tpu_torch.runtime.profiling import StageTimer

    base = PipelineConfig()
    cfg = dataclasses.replace(base, preprocess=dataclasses.replace(
        base.preprocess, random_crop=True, random_flip=True))
    fcfg = dataclasses.replace(cfg, flow_algo="farneback")
    L = cfg.preprocess.flow_stack
    n_scales = len(SIZES)
    fb_levels = len(_level_sizes(cfg.preprocess.crop, cfg.preprocess.crop,
                                 cfg.farneback))
    zero, read = flow_counters()
    nothing = dict.fromkeys(read(), 0)
    fb_want = {**nothing, **fb_expected(fb_levels, cfg.farneback.iterations)}
    tv_want = {**nothing, "tvl1_scale": n_scales}
    report = {}

    # 1. build_examples: kernels against plain versions.
    host = train_windows(np, TRAIN_BATCH, L + 1, seed=40)
    windows = torch.from_numpy(host).to(dev)
    crops = tts.draw_crops(torch.Generator().manual_seed(0), windows, cfg)
    check(bool(crops[2].any()) and not bool(crops[2].all()),
          f"crop draws flip all or none: {crops[2].tolist()}")
    examples = {}
    for name, c, want in (("tvl1", cfg, tv_want), ("farneback", fcfg,
                                                   fb_want)):
        zero()
        got = tts.build_examples(windows, c, "both", crops)
        torch.cuda.synchronize()
        launches = read()
        check(launches == want,
              f"build_examples ({name}) launched {launches}, expected {want}")
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        plain = tts.build_examples(windows, c, "both", crops, plain=True)
        t1.record()
        torch.cuda.synchronize()
        check(read() == launches, "the plain build_examples launched kernels")
        errs = {k: float((got[k] - plain[k]).abs().max()) for k in got}
        check(all(torch.equal(got[k], plain[k]) for k in got),
              f"build_examples ({name}) vs plain versions: {errs}")
        crop = cfg.preprocess.crop
        check(got["flow"].shape == (TRAIN_BATCH, crop, crop, 2 * L)
              and got["rgb"].shape == (TRAIN_BATCH, crop, crop, 3)
              and bool(torch.isfinite(got["flow"]).all()),
              f"build_examples ({name}) shapes {got['flow'].shape}")
        prof = device_profile(torch, lambda: tts.build_examples(
            windows, c, "both", crops))
        report[f"build_examples_{name}"] = {
            "launches": launches, "max_abs_vs_plain": errs,
            "ms": cuda_ms(torch, lambda: tts.build_examples(
                windows, c, "both", crops), 3),
            "plain_ms": t0.elapsed_time(t1),
            "flow_kernels_device_ms": prof["port_kernels_device_ms"],
            "device_busy_ms": prof["device_busy_ms"],
            "pairs_per_flow_call": TRAIN_BATCH * L}
        examples[name] = got

    # 2. One step on the card and on the CPU from the same weights.
    model = TwoStreamModel.create(num_classes=cfg.num_classes, flow_stack=L,
                                  width=64).init(
        torch.Generator().manual_seed(0))
    cpu_model = copy.deepcopy(model)
    model.to(dev)
    y = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.num_classes, TRAIN_BATCH))
    bns = {"rgb": model.spatial.layer4[-1].bn2,
           "flow": model.temporal.layer4[-1].bn2}
    seen = {}
    hooks = [bn.register_forward_pre_hook(
        lambda m, inp, k=k: seen.__setitem__(k, inp[0].detach().double()))
        for k, bn in bns.items()]
    old_var = {k: bn.running_var.detach().double().clone()
               for k, bn in bns.items()}
    card = tts.make_two_stream_train_steps(
        tts.create_two_stream_states(model, 1e-3, "both"))
    host_steps = tts.make_two_stream_train_steps(
        tts.create_two_stream_states(cpu_model, 1e-3, "both"))
    ex = examples["tvl1"]
    step_cmp = {}
    for k in ("rgb", "flow"):
        got = {m: float(v) for m, v in card[k](ex[k], y.to(dev)).items()}
        want = {m: float(v) for m, v in host_steps[k](ex[k].cpu(),
                                                      y).items()}
        rel = abs(got["loss"] - want["loss"]) / abs(want["loss"])
        check(rel <= TOL_TRAIN_LOSS and abs(got["accuracy"]
                                            - want["accuracy"])
              <= 1.0 / TRAIN_BATCH + 1e-9,
              f"train step ({k}) on the card {got}, on the CPU {want}")
        var = seen[k].var(dim=(0, 2, 3), unbiased=False)
        n = seen[k].numel() // seen[k].shape[1]
        expect = 0.9 * old_var[k] + 0.1 * var
        bn_err = float(((bns[k].running_var.double() - expect).abs()
                        / expect).max())
        unbiased_err = float(((0.9 * old_var[k] + 0.1 * var * n / (n - 1)
                               - expect).abs() / expect).max())
        check(bn_err <= TOL_BN_VAR,
              f"BatchNorm running var ({k}): {bn_err} from the biased rule")
        stream = model.spatial if k == "rgb" else model.temporal
        other = cpu_model.spatial if k == "rgb" else cpu_model.temporal
        step_cmp[k] = {"card": got, "cpu": want, "loss_rel_diff": rel,
                       "bn_running_var_rel_err": bn_err,
                       "unbiased_rule_would_differ_by": unbiased_err,
                       "values_per_channel": n,
                       "params_max_abs_diff_after_step": max(
                           float((a.detach().cpu() - b.detach()).abs().max())
                           for a, b in zip(stream.parameters(),
                                           other.parameters()))}
    for h in hooks:
        h.remove()
    report["step_card_vs_cpu"] = {**step_cmp, "tolerance_loss_rel":
                                  TOL_TRAIN_LOSS, "tolerance_accuracy":
                                  1.0 / TRAIN_BATCH,
                                  "tolerance_bn_var_rel": TOL_BN_VAR}
    del cpu_model, host_steps

    runs, total = {}, dict(nothing)
    with tempfile.TemporaryDirectory() as work:
        ds = build_synthetic_ucf101(
            os.path.join(work, "ucf101"), num_classes=EVAL_CLASSES,
            clips_per_class=EVAL_CLIPS_PER_CLASS, num_frames=EVAL_FRAMES,
            h=NATIVE[0], w=NATIVE[1], seed=0)

        # 3. The command's loop, instrumented.
        sent = []
        sampler = TrainWindowSampler(
            ds.train_records(), window=tts.train_window_len(cfg),
            batch=TRAIN_BATCH, seed=0, max_frames=120, num_workers=2)

        def host_batches():
            for i, batch in enumerate(sampler.batches()):
                if i >= TRAIN_STEPS:
                    return
                sent.append(batch)
                yield batch

        timer = StageTimer()
        feed = DevicePrefetcher(host_batches(), depth=2, device=dev)
        received, marks = [], []

        def spy_feed():
            for batch in feed:
                received.append(batch)
                yield batch

        torch.cuda.reset_peak_memory_stats(dev)
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        try:
            for _ in tts.train_iter(spy_feed(), card, cfg, "both",
                                    torch.Generator().manual_seed(0),
                                    timer=timer):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                marks.append(ev)
        finally:
            sampler.stop()
            feed.close()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev)
        check(len(received) == len(sent) == TRAIN_STEPS,
              f"{len(received)} batches received, {len(sent)} sent")
        for i, ((w, yy), (w_host, y_host)) in enumerate(zip(received, sent)):
            check(w.device.type == dev.type
                  and torch.equal(w.cpu(), torch.from_numpy(w_host))
                  and torch.equal(yy.cpu(), torch.from_numpy(y_host)),
                  f"prefetched batch {i} differs from its host batch")
        step_ms = [start.elapsed_time(marks[0])] + [
            a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        w0, y0 = received[-1]

        def one_step():
            e = tts.build_examples(w0, cfg, "both", tts.draw_crops(
                torch.Generator().manual_seed(1), w0, cfg))
            for k, step in card.items():
                step(e[k], y0)

        prof = device_profile(torch, one_step)
        report["loop"] = {
            "steps": TRAIN_STEPS, "batch": TRAIN_BATCH,
            "stages": timer.report(), "step_ms_cuda_events": step_ms,
            "prefetched_batches_equal_host": True,
            "prefetcher_stats": dict(feed.stats),
            "sampler_stats": dict(sampler.stats),
            "max_memory_allocated_bytes": peak,
            "step_profile": {k: prof[k] for k in (
                "profiled_wall_ms", "device_events", "device_sum_ms",
                "device_busy_ms", "busy_share_of_profiled",
                "port_kernels_device_ms")}}
        del received, sent, w0, y0

        # 4. The command.
        ckpt = os.path.join(work, "trained.msgpack")
        argv = ["train", "--videos", ds.videos_root, "--annotations",
                ds.annotations_root, "--device", "cuda",
                "--batch", str(TRAIN_BATCH), "--log-every", "1"]
        real_iter = tts.train_iter
        events = []

        def iter_spy(*a, **kw):
            for m in real_iter(*a, **kw):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                events.append(ev)
                yield m

        def command(name, extra, steps, expected):
            del events[:]
            zero()
            t0 = time.perf_counter()
            rc, res = run_cli(argv + extra)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = read()
            want = {**nothing, **{k: v * steps for k, v in expected.items()}}
            check(rc == 0 and res["steps"] == steps,
                  f"train {extra} exited {rc}: {res}")
            check(launches == want,
                  f"train {extra} launched {launches}, expected {want}")
            check(len(events) == steps, f"{len(events)} steps seen")
            rate = (steps - 1) / (1e-3 * events[0].elapsed_time(events[-1]))
            runs[name] = {"result": res, "launches": launches,
                          "seconds": seconds,
                          "step_ms": [a.elapsed_time(b) for a, b in
                                      zip(events, events[1:])],
                          f"steps_per_s_steps_2_to_{steps}": rate,
                          f"windows_per_s_steps_2_to_{steps}":
                          rate * TRAIN_BATCH}
            for k, n in launches.items():
                total[k] += n
            return res

        tts.train_iter = iter_spy
        cache = ["--cache-dir", os.path.join(work, "cache")]
        both = ["--stream", "both", "--steps", str(TRAIN_STEPS), "--out",
                ckpt]
        try:
            # Every window decoded from its container; then the cache
            # filled (each clip decoded once) and read.
            res = command("decoding", both, TRAIN_STEPS,
                          {"tvl1_scale": n_scales})
            check(res["ingest"]["decodes"] >= TRAIN_STEPS * TRAIN_BATCH
                  and res["ingest"]["cache_hits"] == 0 and all(
                      f"final_loss_{k}" in res for k in ("rgb", "flow")),
                  f"train, decoding: {res}")
            res = command("cache_fill", both + cache, TRAIN_STEPS,
                          {"tvl1_scale": n_scales})
            check(res["ingest"]["decodes"] > 0,
                  f"train, filling the cache: {res['ingest']}")
            res = command("cached", both + cache, TRAIN_STEPS,
                          {"tvl1_scale": n_scales})
            check(res["ingest"]["decodes"] == 0
                  and res["ingest"]["cache_hits"] > 0,
                  f"train from the cache decoded: {res['ingest']}")
            res = command("farneback", [
                "--stream", "flow", "--algo", "farneback", "--steps",
                str(TRAIN_FB_STEPS), "--out",
                os.path.join(work, "flow.msgpack")], TRAIN_FB_STEPS,
                fb_expected(fb_levels, cfg.farneback.iterations))
            check(set(res) >= {"final_loss_flow"}
                  and "final_loss_rgb" not in res, f"train flow: {res}")
        finally:
            tts.train_iter = real_iter
        # The checkpoint in the other commands.
        rc, ev_res = run_cli(["eval-ucf101", "--videos", ds.videos_root,
                              "--annotations", ds.annotations_root,
                              "--checkpoint", ckpt, "--batched",
                              "--batch-clips", str(EVAL_BATCH), "--device",
                              "cuda"])
        check(rc == 0 and ev_res["total"] == len(ds.test_records())
              and ev_res["failed"] == 0,
              f"eval-ucf101 on the trained checkpoint: {rc} {ev_res}")
        rc, cc_res = run_cli(["classify-clip", ds.test_records()[0].path,
                              "--checkpoint", ckpt, "--device", "cuda"])
        check(rc == 0 and 0 <= cc_res["top1"] < cfg.num_classes,
              f"classify-clip on the trained checkpoint: {rc} {cc_res}")
    report["commands"] = runs
    report["eval_ucf101_on_checkpoint"] = ev_res
    report["classify_clip_top1"] = cc_res["top1"]
    emit({"phase": "train", **report})
    return total


SPY_HD_PAIRS = 2           # pairs of the 1080x1920 SpyNet call
SPY_CLASSES = 2            # the SpyNet phase's synthetic UCF101: 2 classes x
SPY_CLIPS_PER_CLASS = 4    # 4 clips of 48 frames, half of them test clips
SPY_CMD_STEPS = 3          # steps of the SpyNet train command
SPY_TRAIN_STEPS = 20       # SpyNet's own training steps, at 64², batch 8
SPY_TRAIN_BATCH = 8
SPY_TRAIN_HW = 64
# SpyNet on the card against the CPU (cuDNN against the CPU's
# convolutions, both float32 with TF32 off): the flow in px; a window's
# probabilities alone and inside a batch (cuDNN may pick another algorithm
# for another batch size); one training step's loss, relative.
TOL_SPY_FLOW = 1e-4
TOL_SPY_BATCH = 1e-5
TOL_SPY_LOSS = 1e-4


def spynet_phase(torch, np, dev):
    """The learned flow (``--algo spynet``) at full width, on the bundled
    weights.  SpyNet reaches no hand-written kernel: every launch count is
    set to 0 just before each path below and held to 0 just after.

    1. 2 pairs at 224² on the card against the CPU (TOL_SPY_FLOW);
    2. ms per pair (CUDA events) at 224² (15 pairs: one request's flow
       batch) and at 1080×1920 (2 pairs), beside the float32 operations
       bound (``models/spynet.conv_flops`` over 67 TFLOP/s) and the share
       of it reached; device time and busy share of one call
       (torch.profiler); peak memory;
    3. ``ClipServer`` with ``PipelineConfig(flow_algo="spynet")``, two
       ResNet-18s of width 64 from seed 0, 16-frame windows: three
       requests (ms each), phase 4's profile of one, probabilities summing
       to 1, and the window alone against inside a batch (TOL_SPY_BATCH);
    4. ``compute-flow --algo spynet`` on a 3-frame 1080p clip: 2 ``.flo``
       files, the first equal to SpyNet's flow of the decoded frames;
    5. ``eval-ucf101 --algo spynet --batched`` and clip by clip on a
       synthetic UCF101 (4 test clips at 240×320) from a full-width
       checkpoint: the same counts;
    6. ``build_examples`` with SpyNet on 32 in-memory 11-frame windows
       (320 pairs at 224²): ms and device time; then ``train --algo
       spynet`` for 3 steps at the defaults (batch 32), its checkpoint
       written;
    7. SpyNet's own training (``make_spynet_train_step``, Adam, 64²,
       batch 8) from the bundled weights: one step on the card against
       the same step on the CPU (the same draws; loss within TOL_SPY_LOSS),
       then 20 steps timed with CUDA events."""
    import copy
    import tempfile

    from video_analytics_tpu_torch.config import PipelineConfig
    from video_analytics_tpu_torch.ingest.windows import apply_transport_crop
    from video_analytics_tpu_torch.io.flowio import read_flo
    from video_analytics_tpu_torch.io.synthetic import build_synthetic_ucf101
    from video_analytics_tpu_torch.io.video import (
        VideoReader, synthesize_video)
    from video_analytics_tpu_torch.models.spynet import (
        SpyNet, conv_flops, default_spynet_checkpoint,
        make_spynet_train_step)
    from video_analytics_tpu_torch.models.two_stream import TwoStreamModel
    from video_analytics_tpu_torch.ops.preprocess import rgb_to_gray
    from video_analytics_tpu_torch.runtime import pipeline
    from video_analytics_tpu_torch.runtime import train_two_stream as tts
    from video_analytics_tpu_torch.runtime.checkpoint import (
        load_variables, save_variables)
    from video_analytics_tpu_torch.runtime.serve import ClipServer

    zero, read = flow_counters()
    nothing = dict.fromkeys(read(), 0)

    def no_kernels(what: str) -> None:
        launches = read()
        check(launches == nothing,
              f"{what} launched port kernels: {launches}")

    cpu_net = SpyNet(levels=4)
    cpu_net.load_flax_variables(load_variables(
        default_spynet_checkpoint(), cpu_net.flax_variables())).eval()
    net = copy.deepcopy(cpu_net).to(dev)
    cfg = PipelineConfig(flow_algo="spynet")
    crop = cfg.preprocess.crop
    report = {"tolerances": {"flow_vs_cpu_px": TOL_SPY_FLOW,
                             "probs_alone_vs_batch": TOL_SPY_BATCH,
                             "train_loss_rel": TOL_SPY_LOSS}}

    def gray_pairs(n: int, h: int, w: int, seed: int):
        g = torch.from_numpy(np.stack([scene(np, t, h, w, seed)
                                       for t in range(n + 1)]))
        return g[:-1], g[1:]

    # 1. The card against the CPU.
    prev, nxt = gray_pairs(2, crop, crop, 60)
    with torch.no_grad():
        zero()
        got = net(prev.to(dev), nxt.to(dev))
        torch.cuda.synchronize()
        no_kernels("SpyNet")
        want = cpu_net(prev, nxt)
    err = float((got.cpu() - want).abs().max())
    check(got.shape == (2, crop, crop, 2) and bool(torch.isfinite(got).all()),
          f"SpyNet flow {tuple(got.shape)}")
    check(err <= TOL_SPY_FLOW,
          f"SpyNet on the card vs the CPU: max abs {err} > {TOL_SPY_FLOW}")
    report["flow_vs_cpu_max_abs"] = err
    report["mean_flow_224"] = got[:, 16:-16, 16:-16].reshape(
        -1, 2).mean(0).tolist()           # the scene moves VEL px a frame

    # 2. ms per pair against the operations bound.
    for name, (n, h, w) in (("224", (PAIRS, crop, crop)),
                            ("1080p", (SPY_HD_PAIRS, *FULL_HD))):
        p, q = (t.to(dev) for t in gray_pairs(n, h, w, 61))
        with torch.no_grad():
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_ms(torch, lambda: net(p, q), 5)
            prof = device_profile(torch, lambda: net(p, q))
        flops = conv_flops(n, h, w)
        b_ms, b_by = bound(4 * n * h * w * (2 + 2), flops)
        report[f"flow_{name}"] = {
            "pairs": n, "hw": [h, w], "ms": ms, "ms_per_pair": ms / n,
            "gflop": flops / 1e9, "bound_ms": b_ms, "bound_by": b_by,
            "share_of_bound": b_ms / ms,
            "device_sum_ms": prof["device_sum_ms"],
            "device_busy_ms": prof["device_busy_ms"],
            "busy_share_of_profiled": prof["busy_share_of_profiled"],
            "top_device_ms": prof["top_device_ms"][:6],
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}

    # 3. Serving.
    frames = np.stack([np.stack([scene(np, t, 256, 256, seed=c)
                                 for c in range(3)], axis=-1)
                       for t in range(16)]).round().astype(np.uint8)
    model = TwoStreamModel.create(num_classes=cfg.num_classes,
                                  flow_stack=cfg.preprocess.flow_stack,
                                  width=64).init(
        torch.Generator().manual_seed(0))
    server = ClipServer(model, cfg, dev, flow_net=net)
    warm_s = server.warmup()
    request_ms, outs, _ = serve_requests(server, frames, zero, read,
                                         nothing)
    probs = outs[0]
    check(probs.shape == (cfg.num_classes,)
          and bool(np.isfinite(probs).all()) and bool((probs >= 0).all())
          and abs(float(probs.sum()) - 1.0) < 1e-4,
          f"SpyNet serve probs: shape {probs.shape}, sum {probs.sum()}")
    wins, wcfg = apply_transport_crop(server._windows_from_frames(frames),
                                      cfg)
    x = torch.from_numpy(wins[0]).to(dev)
    with torch.no_grad():
        alone = pipeline.classify_window(x, server.model, wcfg, flow_net=net)
        batch = pipeline.classify_batch(torch.stack([x, x.flip(0)]),
                                        server.model, wcfg, flow_net=net)
    e_batch = float((batch[0] - alone).abs().max())
    check(e_batch <= TOL_SPY_BATCH,
          f"SpyNet window alone vs batched: {e_batch} > {TOL_SPY_BATCH}")
    report["serve"] = {
        "warmup_s": warm_s, "request_ms": request_ms,
        "top1": int(probs.argmax()), "alone_vs_batch_max_abs": e_batch,
        "repeat_max_abs": max(float(np.abs(o - probs).max()) for o in outs),
        "flow_gflop_per_request": conv_flops(PAIRS, crop, crop) / 1e9,
        "flow_bound_ms_per_request": bound(
            0, conv_flops(PAIRS, crop, crop))[0],
        "profile": profile_request(torch, np, server, frames, request_ms)}

    with tempfile.TemporaryDirectory() as work:
        # 4. compute-flow on a 1080p clip.
        clip = synthesize_video(os.path.join(work, "hd.mp4"),
                                list(hd_frames(np, 3, seed=62)), fps=25.0)
        out_dir = os.path.join(work, "flow")
        zero()
        t0 = time.perf_counter()
        rc, res = run_cli(["compute-flow", clip, out_dir, "--algo", "spynet",
                           "--no-bucket", "--device", "cuda"])
        torch.cuda.synchronize()
        cf_s = time.perf_counter() - t0
        no_kernels("compute-flow --algo spynet")
        check(rc == 0 and res["flows"] == 2, f"compute-flow: {rc} {res}")
        with VideoReader(clip) as r:
            decoded = r.read_all()
        with torch.no_grad():
            g = rgb_to_gray(torch.from_numpy(decoded).to(dev))
            direct = net(g[:-1], g[1:])[0].cpu().numpy()
        flo = read_flo(os.path.join(out_dir, "flow_000001.flo"))
        e_cf = float(np.abs(flo - direct).max())
        check(flo.shape == (*FULL_HD, 2) and e_cf <= TOL_SPY_FLOW,
              f"compute-flow .flo {flo.shape} vs SpyNet: {e_cf}")
        report["compute_flow_1080p"] = {"seconds": cf_s, "flows": 2,
                                        "max_abs_vs_direct": e_cf}

        # 5. eval-ucf101, batched and clip by clip.
        ds = build_synthetic_ucf101(
            os.path.join(work, "ucf101"), num_classes=SPY_CLASSES,
            clips_per_class=SPY_CLIPS_PER_CLASS, num_frames=EVAL_FRAMES,
            h=NATIVE[0], w=NATIVE[1], seed=0)
        ckpt = os.path.join(work, "two_stream.msgpack")
        save_variables(ckpt, model.flax_variables())
        base = ["eval-ucf101", "--videos", ds.videos_root, "--annotations",
                ds.annotations_root, "--checkpoint", ckpt, "--algo",
                "spynet", "--device", "cuda"]
        evals = {}
        for name, extra in (("batched", ["--batched", "--batch-clips", "8"]),
                            ("sequential", [])):
            zero()
            t0 = time.perf_counter()
            rc, res = run_cli(base + extra)
            torch.cuda.synchronize()
            evals[name] = {"seconds": time.perf_counter() - t0, **res}
            no_kernels(f"eval-ucf101 --algo spynet {extra}")
            check(rc == 0 and res["failed"] == 0
                  and res["total"] == len(ds.test_records()),
                  f"eval-ucf101 --algo spynet {extra}: {rc} {res}")
        check(evals["batched"]["correct"] == evals["sequential"]["correct"],
              f"eval-ucf101 --algo spynet batched vs sequential: {evals}")
        report["eval_ucf101"] = evals

        # 6. build_examples with SpyNet, then the train command.
        tcfg = dataclasses.replace(cfg, preprocess=dataclasses.replace(
            cfg.preprocess, random_crop=True, random_flip=True))
        L = tcfg.preprocess.flow_stack
        windows = torch.from_numpy(train_windows(np, TRAIN_BATCH, L + 1,
                                                 seed=40)).to(dev)
        crops = tts.draw_crops(torch.Generator().manual_seed(0), windows,
                               tcfg)

        def examples():
            return tts.build_examples(windows, tcfg, "both", crops,
                                      flow_net=net)

        zero()
        ex = examples()
        torch.cuda.synchronize()
        no_kernels("build_examples (spynet)")
        check(ex["flow"].shape == (TRAIN_BATCH, crop, crop, 2 * L)
              and bool(torch.isfinite(ex["flow"]).all()),
              f"build_examples (spynet) {tuple(ex['flow'].shape)}")
        prof = device_profile(torch, examples)
        flops = conv_flops(TRAIN_BATCH * L, crop, crop)
        report["build_examples"] = {
            "pairs": TRAIN_BATCH * L, "ms": cuda_ms(torch, examples, 3),
            "device_busy_ms": prof["device_busy_ms"],
            "device_sum_ms": prof["device_sum_ms"],
            "top_device_ms": prof["top_device_ms"][:6],
            "flow_gflop": flops / 1e9, "flow_bound_ms": bound(0, flops)[0]}
        out = os.path.join(work, "spy_train.msgpack")
        zero()
        t0 = time.perf_counter()
        rc, res = run_cli(["train", "--videos", ds.videos_root,
                           "--annotations", ds.annotations_root, "--out",
                           out, "--algo", "spynet", "--steps",
                           str(SPY_CMD_STEPS), "--device", "cuda"])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        no_kernels("train --algo spynet")
        check(rc == 0 and res["steps"] == SPY_CMD_STEPS
              and os.path.getsize(out) > 0
              and all(np.isfinite(res[f"final_loss_{k}"])
                      for k in ("rgb", "flow")),
              f"train --algo spynet: {rc} {res}")
        report["train_command"] = {"seconds": train_s, **res}

    # 7. SpyNet's own training: one step against the CPU, then 20 timed.
    def trainer(m):
        return make_spynet_train_step(
            m, torch.optim.Adam(m.parameters(), lr=2e-4),
            batch=SPY_TRAIN_BATCH, hw=(SPY_TRAIN_HW, SPY_TRAIN_HW),
            local_blobs=2)

    card_net = copy.deepcopy(cpu_net).to(dev)
    step = trainer(card_net)
    # Draws from one CPU generator seed on both sides: the same batch.
    loss_d, epe_d = step(torch.Generator().manual_seed(7))
    loss_c, epe_c = trainer(copy.deepcopy(cpu_net))(
        torch.Generator().manual_seed(7))
    rel = abs(float(loss_d) - float(loss_c)) / abs(float(loss_c))
    check(rel <= TOL_SPY_LOSS,
          f"SpyNet train step loss card {float(loss_d)} vs CPU "
          f"{float(loss_c)}: {rel} > {TOL_SPY_LOSS}")
    gen = torch.Generator(dev).manual_seed(8)
    zero()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    losses = [step(gen) for _ in range(SPY_TRAIN_STEPS)]
    end.record()
    torch.cuda.synchronize()
    no_kernels("SpyNet training")
    losses = [(float(a), float(b)) for a, b in losses]
    check(all(np.isfinite(v).all() for v in losses),
          f"SpyNet training losses {losses}")
    flops = 3 * conv_flops(SPY_TRAIN_BATCH, SPY_TRAIN_HW, SPY_TRAIN_HW)
    report["spynet_training"] = {
        "loss_card": float(loss_d), "loss_cpu": float(loss_c),
        "loss_rel_err": rel, "epe_card": float(epe_d),
        "epe_cpu": float(epe_c),
        "steps": SPY_TRAIN_STEPS, "ms_per_step": start.elapsed_time(end)
        / SPY_TRAIN_STEPS,
        "first_last_loss": [losses[0][0], losses[-1][0]],
        "bound_ms_per_step": bound(0, flops)[0]}
    emit({"phase": "spynet", **report})


DIST_WORLD = 2             # processes of the gloo group on the one card
DIST_TRAIN_STEPS = 2       # two-stream steps at the global batch TRAIN_BATCH
# Each process of the gloo group, on cuda:0: argv = rank, spec file.
DIST_WORKER = r"""
import datetime, hashlib, json, sys, time
import numpy as np
import torch
import torch.distributed as dist

rank = int(sys.argv[1])
spec = json.load(open(sys.argv[2]))
sys.path.insert(0, spec["here"])
import chip_smoke as cs
from video_analytics_tpu_torch.config import PipelineConfig
from video_analytics_tpu_torch.io.dataset import UCF101
from video_analytics_tpu_torch.models.two_stream import TwoStreamModel
from video_analytics_tpu_torch.parallel import mesh
from video_analytics_tpu_torch.runtime import evaluate as ev
from video_analytics_tpu_torch.runtime import train_two_stream as tts

torch.cuda.set_device(0)
dev = torch.device("cuda", 0)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{spec['port']}",
                        world_size=spec["world"], rank=rank,
                        timeout=datetime.timedelta(minutes=5))
zero, read = cs.flow_counters()
out = {"rank": rank}
cfg = PipelineConfig()
model = TwoStreamModel.create(num_classes=cfg.num_classes,
                              flow_stack=cfg.preprocess.flow_stack,
                              width=64).init(torch.Generator().manual_seed(0))
model = model.to(dev).eval()
records = UCF101(videos_root=spec["videos"],
                 annotations_root=spec["annotations"]).test_records()
zero()
res = ev.evaluate_batched(records, model, cfg, dev,
                          batch_clips=spec["batch_clips"], host_resize=True)
torch.cuda.synchronize()
out["eval"] = res.as_dict()
out["eval_launches"] = read()

tcfg = cs.train_config()
model = TwoStreamModel.create(num_classes=cfg.num_classes,
                              flow_stack=cfg.preprocess.flow_stack,
                              width=64).init(torch.Generator().manual_seed(0))
states = tts.create_two_stream_states(model.to(dev), 1e-3, "both")
steps = tts.make_two_stream_train_steps(states)
host = cs.train_windows(np, spec["batch"], cfg.preprocess.flow_stack + 1,
                        seed=40)
y_host = np.random.default_rng(1).integers(0, cfg.num_classes, spec["batch"])
rows = slice(rank * spec["batch"] // spec["world"],
             (rank + 1) * spec["batch"] // spec["world"])
windows = torch.from_numpy(host[rows]).to(dev)
y = torch.from_numpy(y_host[rows]).to(dev)
gen = torch.Generator().manual_seed(0)


def step():
    ex = tts.build_examples(windows, tcfg, "both",
                            tts.draw_crops(gen, windows, tcfg))
    return {k: {m: float(v) for m, v in fn(ex[k], y).items()}
            for k, fn in steps.items()}


zero()
out["losses"] = []
for i in range(spec["steps"]):
    out["losses"].append(step())
    if rank == 0 and i < spec["steps"] - 1:
        # The state the next step starts from, for the one-process step.
        torch.save(cs.train_state(states), spec["state"] + f".{i}")
torch.cuda.synchronize()
out["train_launches"] = read()
digest = hashlib.sha256()
for name, t in model.state_dict().items():
    digest.update(name.encode() + t.detach().cpu().numpy().tobytes())
out["state_sha256"] = digest.hexdigest()
# One more step, timed, with every all-reduce fenced and timed: the
# group's share of a step (through host memory, gloo on one card).
real, spent = dist.all_reduce, []


def fenced(t, *a, **kw):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = real(t, *a, **kw)
    torch.cuda.synchronize()
    spent.append(time.perf_counter() - t0)
    return r


torch.cuda.synchronize()
t0 = time.perf_counter()
step()
torch.cuda.synchronize()
out["step_s"] = time.perf_counter() - t0
dist.all_reduce = fenced
torch.cuda.synchronize()
t0 = time.perf_counter()
step()
torch.cuda.synchronize()
out["fenced_step_s"] = time.perf_counter() - t0
dist.all_reduce = real
out["all_reduce_s"], out["all_reduces"] = sum(spent), len(spent)
dist.destroy_process_group()
print(json.dumps(out), flush=True)
"""


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def train_config():
    """The train command's config: ``PipelineConfig()`` with its random
    crop and flip."""
    from video_analytics_tpu_torch.config import PipelineConfig
    base = PipelineConfig()
    return dataclasses.replace(base, preprocess=dataclasses.replace(
        base.preprocess, random_crop=True, random_flip=True))


def train_state(states):
    """The two-stream model's weights and statistics and each stream's SGD
    momentum, by parameter name (``load_train_state`` restores them)."""
    model = {k: st.model.state_dict() for k, st in states.items()}
    momentum = {k: {n: st.optimizer.state[p]["momentum_buffer"]
                    for n, p in st.model.named_parameters()}
                for k, st in states.items()}
    return {"model": model, "momentum": momentum}


def load_train_state(states, saved) -> None:
    for k, st in states.items():
        st.model.load_state_dict(saved["model"][k])
        for n, p in st.model.named_parameters():
            st.optimizer.state[p]["momentum_buffer"] = (
                saved["momentum"][k][n].clone())


def distributed_phase(torch, np, dev):
    """``parallel/mesh`` on the card, at full width.

    (a) ``eval-ucf101 --batched --coordinator 127.0.0.1:<port>
        --num-processes 1 --process-id 0`` (a one-process NCCL group) on a
        synthetic UCF101 of 8 test clips at 240x320, against the same
        command without the flags: equal JSON, 5 ``tvl1_scale`` launches
        each and nothing else; then ``evaluate_batched_multiprocess`` in a
        one-process NCCL group (one NCCL all-reduce of the counts), equal
        again.
    (b) two processes on cuda:0 in a gloo group (NCCL refuses two
        processes on one card), through the library:
        ``evaluate_batched`` (routed to ``evaluate_batched_multiprocess``:
        4 clips a process) equal to (a); two two-stream steps at the
        global batch of 32 (16 a process) from seed 0's weights against
        one process's steps on the 32 windows, each from the state the
        processes' step started from (loss within TOL_TRAIN_LOSS, accuracy
        to a window: a step's rounding differences move the next step's
        flow-stream loss by up to ~2e-4 relative, as cuDNN's own run-to-run
        differences do); the processes' weights and
        statistics bit-equal; each process's launches held (5
        ``tvl1_scale`` for its eval batch, 5 a step); the all-reduces'
        share of a third step, for information.

    Returns the launches per kernel summed over (a), (b)'s processes and
    its one-process reference."""
    import tempfile

    from video_analytics_tpu_torch.config import PipelineConfig
    from video_analytics_tpu_torch.flow.farneback import _level_sizes
    from video_analytics_tpu_torch.io.synthetic import build_synthetic_ucf101
    from video_analytics_tpu_torch.models.two_stream import TwoStreamModel
    from video_analytics_tpu_torch.parallel import mesh
    from video_analytics_tpu_torch.runtime import evaluate as ev
    from video_analytics_tpu_torch.runtime import train_two_stream as tts
    from video_analytics_tpu_torch.runtime.checkpoint import save_variables

    cfg = PipelineConfig()
    n_scales = len(SIZES)
    zero, read = flow_counters()
    nothing = dict.fromkeys(read(), 0)
    total = dict(nothing)

    def counted(fn, want, what):
        zero()
        out = fn()
        torch.cuda.synchronize()
        launches = read()
        check(launches == {**nothing, **want},
              f"{what} launched {launches}, expected {want}")
        for k, n in launches.items():
            total[k] += n
        return out

    report = {}
    with tempfile.TemporaryDirectory() as work:
        ds = build_synthetic_ucf101(
            os.path.join(work, "ucf101"), num_classes=EVAL_CLASSES,
            clips_per_class=EVAL_CLIPS_PER_CLASS, num_frames=EVAL_FRAMES,
            h=NATIVE[0], w=NATIVE[1], seed=0)
        records = ds.test_records()
        ckpt = os.path.join(work, "two_stream.msgpack")
        model = TwoStreamModel.create(
            num_classes=cfg.num_classes, flow_stack=cfg.preprocess.flow_stack,
            width=64).init(torch.Generator().manual_seed(0))
        save_variables(ckpt, model.flax_variables())
        model = model.to(dev).eval()
        base = ["eval-ucf101", "--videos", ds.videos_root, "--annotations",
                ds.annotations_root, "--checkpoint", ckpt, "--batched",
                "--batch-clips", str(EVAL_BATCH), "--device", "cuda"]
        one_batch = {"tvl1_scale": n_scales}

        # (a) a one-process NCCL group.
        t0 = time.perf_counter()
        rc, plain = counted(lambda: run_cli(base), one_batch, "eval-ucf101")
        t1 = time.perf_counter()
        group = ["--coordinator", f"127.0.0.1:{free_port()}",
                 "--num-processes", "1", "--process-id", "0"]
        rc_g, grouped = counted(lambda: run_cli(base + group), one_batch,
                                "eval-ucf101 --coordinator")
        t2 = time.perf_counter()
        check(rc == rc_g == 0 and grouped == plain
              and plain["total"] == len(records) and plain["failed"] == 0,
              f"eval-ucf101 in a one-process group: {grouped}, without: "
              f"{plain}")
        mesh.init_distributed(f"127.0.0.1:{free_port()}", 1, 0, "cuda")
        try:
            lib = counted(lambda: ev.evaluate_batched_multiprocess(
                records, model, cfg, dev, batch_clips=EVAL_BATCH,
                host_resize=True), one_batch,
                "evaluate_batched_multiprocess (NCCL, one process)")
        finally:
            mesh.shutdown()
        check(lib.as_dict() == plain,
              f"evaluate_batched_multiprocess {lib.as_dict()} != {plain}")
        fb = ["--algo", "farneback"]
        crop = cfg.preprocess.crop
        fb_batch = fb_expected(len(_level_sizes(crop, crop, cfg.farneback)),
                               cfg.farneback.iterations)
        t3 = time.perf_counter()
        rc, fb_plain = counted(lambda: run_cli(base + fb), fb_batch,
                               "eval-ucf101 --algo farneback")
        t4 = time.perf_counter()
        group = ["--coordinator", f"127.0.0.1:{free_port()}",
                 "--num-processes", "1", "--process-id", "0"]
        rc_g, fb_grouped = counted(lambda: run_cli(base + fb + group),
                                   fb_batch,
                                   "eval-ucf101 --algo farneback "
                                   "--coordinator")
        t5 = time.perf_counter()
        check(rc == rc_g == 0 and fb_grouped == fb_plain
              and fb_plain["total"] == len(records),
              f"eval-ucf101 --algo farneback in a one-process group: "
              f"{fb_grouped}, without: {fb_plain}")
        report["one_process_nccl"] = {
            "result": plain, "launches": one_batch,
            "seconds_without_group": t1 - t0, "seconds_with_group": t2 - t1,
            "farneback": {"result": fb_plain, "launches": fb_batch,
                          "seconds_without_group": t4 - t3,
                          "seconds_with_group": t5 - t4}}

        # (b) two processes on the card in a gloo group.
        spec = os.path.join(work, "spec.json")
        state = os.path.join(work, "state.pt")
        with open(spec, "w") as f:
            json.dump({"here": HERE, "port": free_port(), "world": DIST_WORLD,
                       "state": state,
                       "videos": ds.videos_root,
                       "annotations": ds.annotations_root,
                       "batch_clips": EVAL_BATCH, "batch": TRAIN_BATCH,
                       "steps": DIST_TRAIN_STEPS}, f)
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, "-c", DIST_WORKER, str(r),
                                   spec], cwd=HERE, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for r in range(DIST_WORLD)]
        try:
            # Meanwhile, one process's steps on the 32 windows.
            tcfg = train_config()
            m1 = TwoStreamModel.create(
                num_classes=cfg.num_classes,
                flow_stack=cfg.preprocess.flow_stack,
                width=64).init(torch.Generator().manual_seed(0)).to(dev)
            states = tts.create_two_stream_states(m1, 1e-3, "both")
            steps = tts.make_two_stream_train_steps(states)
            windows = torch.from_numpy(train_windows(
                np, TRAIN_BATCH, cfg.preprocess.flow_stack + 1,
                seed=40)).to(dev)
            y = torch.from_numpy(np.random.default_rng(1).integers(
                0, cfg.num_classes, TRAIN_BATCH)).to(dev)
            gen = torch.Generator().manual_seed(0)

            def one_process_step():
                ex = tts.build_examples(windows, tcfg, "both",
                                        tts.draw_crops(gen, windows, tcfg))
                return {k: {m: float(v) for m, v in fn(ex[k], y).items()}
                        for k, fn in steps.items()}

            ref = [counted(one_process_step, one_batch,
                           "one process's first train step")]
            outs = [p.communicate(timeout=600) for p in procs]
            # Each later step from the state process 0's step started from.
            for i in range(1, DIST_TRAIN_STEPS):
                load_train_state(states, torch.load(f"{state}.{i - 1}",
                                                    map_location=dev))
                ref.append(counted(one_process_step, one_batch,
                                   f"one process's train step {i}"))
            del m1, states, steps, windows
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        seconds = time.perf_counter() - t0
        for r, (p, (stdout, stderr)) in enumerate(zip(procs, outs)):
            check(p.returncode == 0, f"gloo process {r} exited "
                  f"{p.returncode}: {stderr[-3000:]}")
        got = [json.loads(o[0].strip().splitlines()[-1]) for o in outs]
    want_train = {**nothing, "tvl1_scale": n_scales * DIST_TRAIN_STEPS}
    worst = 0.0
    for g in got:
        check(g["eval"]["total"] == plain["total"]
              and g["eval"]["correct"] == plain["correct"]
              and g["eval"]["failures"] == [],
              f"process {g['rank']} eval {g['eval']}, one process {plain}")
        check(g["eval_launches"] == {**nothing, **one_batch},
              f"process {g['rank']} eval launched {g['eval_launches']}")
        check(g["train_launches"] == want_train,
              f"process {g['rank']} steps launched {g['train_launches']}")
        for s, (a, b) in enumerate(zip(g["losses"], ref)):
            for k in a:
                rel = abs(a[k]["loss"] - b[k]["loss"]) / abs(b[k]["loss"])
                worst = max(worst, rel)
                check(rel <= TOL_TRAIN_LOSS and abs(
                    a[k]["accuracy"] - b[k]["accuracy"])
                    <= 1.0 / TRAIN_BATCH + 1e-9,
                    f"step {s} ({k}): process {g['rank']} {a[k]}, one "
                    f"process {b[k]}")
        for k, n in g["eval_launches"].items():
            total[k] += n + g["train_launches"][k]
    check(got[0]["losses"] == got[1]["losses"]
          and got[0]["state_sha256"] == got[1]["state_sha256"],
          "the two processes' losses or weights differ")
    report["two_processes_gloo"] = {
        "eval": got[0]["eval"], "losses_process_0": got[0]["losses"],
        "losses_one_process": ref, "loss_max_rel_diff": worst,
        "tolerance_loss_rel": TOL_TRAIN_LOSS,
        "state_sha256_equal": True, "seconds": seconds,
        "per_process": [{k: g[k] for k in (
            "eval_launches", "train_launches", "step_s", "fenced_step_s",
            "all_reduce_s", "all_reduces")} for g in got],
        "all_reduce_share_of_fenced_step": [
            g["all_reduce_s"] / g["fenced_step_s"] for g in got]}
    emit({"phase": "distributed", "card": CARD.get("card"), **report})
    for k, n in model_axis_phase(torch, np, dev).items():
        total[k] += n
    return total


MODEL_AXIS_CLASSES = (101, 100)   # the fc stays whole; split 50/50
MODEL_AXIS_WINDOWS = 2            # 16-frame windows at 240x320
TOL_MODEL_AXIS = 1e-5
# Each process of the model group, on cuda:0: argv = rank, spec file.
MODEL_AXIS_WORKER = r"""
import datetime, json, sys, time
import numpy as np
import torch
import torch.distributed as dist

rank = int(sys.argv[1])
spec = json.load(open(sys.argv[2]))
sys.path.insert(0, spec["here"])
import chip_smoke as cs
from video_analytics_tpu_torch.config import PipelineConfig
from video_analytics_tpu_torch.models.two_stream import TwoStreamModel
from video_analytics_tpu_torch.parallel import mesh
from video_analytics_tpu_torch.runtime.pipeline import classify_batch

torch.cuda.set_device(0)
dev = torch.device("cuda", 0)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{spec['port']}",
                        world_size=spec["world"], rank=rank,
                        timeout=datetime.timedelta(minutes=5))
group = mesh.model_parallel_groups(spec["world"])
cfg = PipelineConfig()
windows = torch.from_numpy(np.load(spec["windows"])).to(dev)
real, spent = dist.all_gather, []


def fenced(*a, **kw):
    # Both processes arrive before the clock starts: the gather alone.
    torch.cuda.synchronize()
    dist.barrier(group=kw["group"])
    t0 = time.perf_counter()
    r = real(*a, **kw)
    torch.cuda.synchronize()
    spent.append(1e3 * (time.perf_counter() - t0))
    return r


zero, read = cs.flow_counters()
zero()
out = {"rank": rank}
for classes in spec["classes"]:
    model = TwoStreamModel.create(num_classes=classes, flow_stack=10,
                                  width=64).init(
        torch.Generator().manual_seed(0))
    model = mesh.shard_dense_over_model(model, group).to(dev).eval()
    with torch.no_grad():
        probs = classify_batch(windows, model, cfg)
        dist.all_gather, spent[:] = fenced, []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        classify_batch(windows, model, cfg)
        torch.cuda.synchronize()
        fenced_ms = 1e3 * (time.perf_counter() - t0)
        dist.all_gather = real
    fc = model.spatial.fc
    out[str(classes)] = {"probs": probs.cpu().tolist(),
                         "fc": [type(fc).__name__, list(fc.weight.shape)],
                         "gather_ms": list(spent),
                         "fenced_classify_ms": fenced_ms}
torch.cuda.synchronize()
out["launches"] = read()
dist.destroy_process_group()
print(json.dumps(out), flush=True)
"""


def model_axis_phase(torch, np, dev):
    """The model axis (``parallel/mesh``): two processes on cuda:0 in a
    gloo group, one model group of both (``model_parallel_groups(2)``),
    each running ``classify_batch`` (``PipelineConfig()``) on the same 2
    windows with the full-width ``TwoStreamModel`` after
    ``shard_dense_over_model``: at 101 classes the ``fc`` stays whole, at
    100 it is split 50/50 and its outputs all-gathered.  Each process's
    fused probabilities against the one-process model's on the same
    windows (TOL_MODEL_AXIS); a second call with every all-gather fenced
    and timed.  Returns the launches per kernel of both processes and of
    the one-process reference."""
    import tempfile

    from video_analytics_tpu_torch.config import PipelineConfig
    from video_analytics_tpu_torch.models.two_stream import TwoStreamModel
    from video_analytics_tpu_torch.runtime.pipeline import classify_batch

    cfg = PipelineConfig()
    zero, read = flow_counters()
    nothing = dict.fromkeys(read(), 0)
    calls = 2 * len(MODEL_AXIS_CLASSES)
    frames = np.stack([np.stack([scene(np, t, *NATIVE, seed=c + 3 * w)
                                 for c in range(3)], axis=-1)
                       for w in range(MODEL_AXIS_WINDOWS)
                       for t in range(16)]).round().astype(np.uint8)
    frames = frames.reshape(MODEL_AXIS_WINDOWS, 16, *NATIVE, 3)
    with tempfile.TemporaryDirectory() as work:
        spec = os.path.join(work, "spec.json")
        np.save(os.path.join(work, "windows.npy"), frames)
        with open(spec, "w") as f:
            json.dump({"here": HERE, "port": free_port(), "world": DIST_WORLD,
                       "windows": os.path.join(work, "windows.npy"),
                       "classes": list(MODEL_AXIS_CLASSES)}, f)
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, "-c", MODEL_AXIS_WORKER,
                                   str(r), spec], cwd=HERE,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for r in range(DIST_WORLD)]
        try:
            zero()
            ref = {}
            x = torch.from_numpy(frames).to(dev)
            for classes in MODEL_AXIS_CLASSES:
                model = TwoStreamModel.create(
                    num_classes=classes, flow_stack=10, width=64).init(
                    torch.Generator().manual_seed(0)).to(dev).eval()
                with torch.no_grad():
                    ref[classes] = classify_batch(x, model, cfg).cpu()
                del model
            torch.cuda.synchronize()
            launches = read()
            outs = [p.communicate(timeout=600) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        seconds = time.perf_counter() - t0
    check(launches == {**nothing, "tvl1_scale": len(SIZES)
                       * len(MODEL_AXIS_CLASSES)},
          f"the one-process reference launched {launches}")
    for r, (p, (stdout, stderr)) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"model-axis process {r} exited "
              f"{p.returncode}: {stderr[-3000:]}")
    got = [json.loads(o[0].strip().splitlines()[-1]) for o in outs]
    report = {}
    for classes in MODEL_AXIS_CLASSES:
        split = classes % DIST_WORLD == 0
        want_fc = (["ColumnParallelLinear", [classes // DIST_WORLD, 512]]
                   if split else ["Linear", [classes, 512]])
        errs = []
        for g in got:
            c = g[str(classes)]
            check(c["fc"] == want_fc, f"process {g['rank']} fc {c['fc']}, "
                  f"expected {want_fc}")
            errs.append(float((torch.tensor(c["probs"])
                               - ref[classes]).abs().max()))
            check(len(c["gather_ms"]) == (2 if split else 0),
                  f"process {g['rank']} gathered {len(c['gather_ms'])} "
                  f"times at {classes} classes")
        check(max(errs) <= TOL_MODEL_AXIS, f"model axis at {classes} "
              f"classes vs one process: {errs} > {TOL_MODEL_AXIS}")
        report[str(classes)] = {
            "fc": want_fc, "max_abs_vs_one_process": errs,
            "gather_ms": [g[str(classes)]["gather_ms"] for g in got],
            "fenced_classify_ms": [g[str(classes)]["fenced_classify_ms"]
                                   for g in got]}
    total = dict(launches)
    for g in got:
        check(g["launches"] == {**nothing, "tvl1_scale": len(SIZES) * calls},
              f"model-axis process {g['rank']} launched {g['launches']}")
        for k, n in g["launches"].items():
            total[k] += n
    emit({"phase": "model_axis", "card": CARD.get("card"),
          "processes": DIST_WORLD, "windows": MODEL_AXIS_WINDOWS,
          "tolerance": TOL_MODEL_AXIS, "seconds": seconds, **report})
    return total


WARMUP_SIZES = "240x320,1080x1920"
# The warmup command in a fresh process, then its launches per kernel.
WARMUP_CODE = r"""
import json, sys
import torch
import chip_smoke as cs
from video_analytics_tpu_torch.cli.main import main
zero, read = cs.flow_counters()
zero()
rc = main(sys.argv[1:])
torch.cuda.synchronize()
print(json.dumps({"rc": rc, "launches": read()}), flush=True)
"""
# A fresh process's first flow call at warmup's first bucket (240x320's).
FIRST_CALL_CODE = r"""
import json, time
t0 = time.perf_counter()
import torch
from video_analytics_tpu_torch.config import PipelineConfig
from video_analytics_tpu_torch.ops.cuda import _build
from video_analytics_tpu_torch.runtime.pipeline import compute_flow
x = torch.zeros((8, 256, 320), device="cuda")
torch.cuda.synchronize()
t1 = time.perf_counter()
times = []
for _ in range(2):
    with torch.no_grad():
        compute_flow(x, x, PipelineConfig())
    torch.cuda.synchronize()
    times.append(time.perf_counter() - t1)
    t1 = time.perf_counter()
print(json.dumps({"import_and_cuda_init_s": t1 - t0 - sum(times),
                  "first_call_s": times[0], "second_call_s": times[1],
                  "nvcc_seconds": _build.build_info.get("seconds"),
                  "library": _build.build_info.get("path")}), flush=True)
"""


def warmup_phase(torch, np):
    """``tpuva-torch warmup --surface all --algos tvl1,farneback --sizes
    240x320,1080x1920`` in a fresh process, in a copy of the package with
    no build directory (so it builds the kernels), every launch count set
    to 0 just before the command and read just after; its entries (the
    flow's at the sizes' buckets, 256x320 and 1088x1920) and their
    seconds; then a second fresh process's first flow call at the first
    bucket, which finds the library warmup built.  Returns the command's
    launches per kernel."""
    import shutil
    import tempfile

    from video_analytics_tpu_torch.ops.bucketing import bucket_hw

    with tempfile.TemporaryDirectory() as work:
        shutil.copytree(os.path.join(HERE, "video_analytics_tpu_torch"),
                        os.path.join(work, "video_analytics_tpu_torch"),
                        ignore=shutil.ignore_patterns("_build",
                                                      "__pycache__"))
        shutil.copy(os.path.join(HERE, "chip_smoke.py"), work)
        # chip_smoke.py loads its work counts from the roofline tool.
        os.makedirs(os.path.join(work, "tools"))
        shutil.copy(os.path.join(HERE, "tools", "torch_roofline.py"),
                    os.path.join(work, "tools"))
        env = {**os.environ, "PYTHONPATH": work}
        argv = ["warmup", "--surface", "all", "--algos", "tvl1,farneback",
                "--sizes", WARMUP_SIZES, "--device", "cuda"]
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", WARMUP_CODE, *argv],
                              cwd=work, env=env, capture_output=True,
                              text=True, timeout=900)
        seconds = time.perf_counter() - t0
        check(proc.returncode == 0,
              f"warmup exited {proc.returncode}: {proc.stderr[-3000:]}")
        lines = proc.stdout.strip().splitlines()
        out, tail = json.loads(lines[-2]), json.loads(lines[-1])
        check(tail["rc"] == 0, f"warmup returned {tail['rc']}")
        compiled = out["compiled"]
        flow = [(e["algo"], tuple(e["bucket"])) for e in compiled
                if set(e) == {"algo", "bucket", "secs"}]
        classify = [(e["algo"], e["surface"]) for e in compiled
                    if set(e) in ({"algo", "surface", "shape", "secs"},
                                  {"algo", "surface", "secs"})]
        check(flow == [(a, bucket_hw(*hw)) for a in ("tvl1", "farneback")
                       for hw in (NATIVE, FULL_HD)]
              and classify == [(a, s) for a in ("tvl1", "farneback")
                               for s in ("eval-batched", "serve")]
              and len(compiled) == 8, f"warmup entries: {compiled}")
        shapes = [e["shape"] for e in compiled if "shape" in e]
        check(all(len(s) == 6 and s[:3] == [EVAL_BATCH, 1, 16]
                  and s[5] == 3 for s in shapes),
              f"eval-batched shapes {shapes}")
        cache = out["cache_dir"]
        check(os.path.realpath(cache).startswith(os.path.realpath(work))
              and os.path.exists(os.path.join(cache, "libva_kernels.so")),
              f"warmup's cache_dir {cache} holds no library")
        launches = tail["launches"]
        for k in ("tvl1_scale", "tvl1_pd_chunk", "warp_prep", "median5",
                  "fb_prologue", "fb_iteration"):
            check(launches[k] > 0, f"warmup launched no {k}: {launches}")
        t0 = time.perf_counter()
        again = subprocess.run([sys.executable, "-c", FIRST_CALL_CODE],
                               cwd=work, env=env, capture_output=True,
                               text=True, timeout=300)
        again_s = time.perf_counter() - t0
        check(again.returncode == 0,
              f"the second process exited {again.returncode}: "
              f"{again.stderr[-3000:]}")
        first = json.loads(again.stdout.strip().splitlines()[-1])
        check(first["nvcc_seconds"] == 0.0,
              f"the second process built the kernels: {first}")
    emit({"phase": "warmup", "card": CARD.get("card"),
          "command_seconds": seconds,
          "entries": [{"what": e.get("surface", e.get("bucket")),
                       "algo": e["algo"], "secs": e["secs"],
                       **({"shape": e["shape"]} if "shape" in e else {})}
                      for e in compiled],
          "launches": launches, "second_process": first,
          "second_process_seconds": again_s})
    return launches


# BASELINE.json config #5 as bench.py's measure_sustained_1080p sets it up:
# 128 frames of 1080x1920 in windows of 16 (stride 16), 4 windows a
# classify_batch, through DevicePrefetcher at depth 2.
SUSTAINED_FRAMES = 128
SUSTAINED_WINDOW = 16
SUSTAINED_WB = 4
SUSTAINED_PASSES = 3       # timed passes, after one warm pass


def sustained_frames(np, n: int, h: int, w: int, seed: int):
    """bench.py's make_frames: a blurred uniform texture on (h+64, w+64),
    frame t its window at (1.3t mod 40, 2t mod 40), uint8."""
    import cv2
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 255, (h + 64, w + 64, 3)).astype(np.float32)
    base = cv2.GaussianBlur(base, (11, 11), 0)
    frames = []
    for t in range(n):
        dx, dy = int(2 * t) % 40, int(1.3 * t) % 40
        frames.append(base[dy:dy + h, dx:dx + w].astype(np.uint8))
    return np.stack(frames)


def sustained_phase(torch, np, dev):
    """The sustained 1080p path (BASELINE.json config #5): a 128-frame
    1080x1920 stream cut by ``sliding_windows`` into 8 windows of 16,
    batches of 4 fed through ``DevicePrefetcher`` (depth 2) to
    ``classify_batch`` with the full-width ``TwoStreamModel`` (two
    ResNet-18s, width 64, 101 classes), with ``PipelineConfig(flow_algo=
    "farneback", window=16)`` and then ``PipelineConfig()`` (TV-L1), first
    with the CNN in float32 and then in bfloat16 (``dtype``, as the
    reference's bench builds it; keys ``<algo>_bf16``).  Per flow and
    dtype: one warm pass with the launch counts set to 0 just before and
    held to the expected numbers per batch just after, the peak device
    memory and the prefetcher's pinned buffers; frames/s (decode excluded)
    over 3 timed passes; the device-busy share of one pass under
    torch.profiler; each batch's probabilities against ``classify_batch``
    on the plain path (TOL_PROBS); the clip's mean over the windows,
    summed batch by batch, against the mean of ``classify_window`` on each
    window (TOL_PROBS).  The figures go through
    ``runtime/metrics.MetricsWriter`` into
    a temporary file and are read back.  Returns the warm passes'
    launches per kernel."""
    import tempfile

    from video_analytics_tpu_torch.config import PipelineConfig
    from video_analytics_tpu_torch.flow.farneback import _level_sizes
    from video_analytics_tpu_torch.ingest import (
        DevicePrefetcher, sliding_windows)
    from video_analytics_tpu_torch.models.two_stream import TwoStreamModel
    from video_analytics_tpu_torch.runtime.metrics import MetricsWriter
    from video_analytics_tpu_torch.runtime.pipeline import (
        classify_batch, classify_window)

    stream = sustained_frames(np, SUSTAINED_FRAMES, *FULL_HD, seed=3)
    wins = list(sliding_windows(stream, SUSTAINED_WINDOW, SUSTAINED_WINDOW))
    check(len(wins) == SUSTAINED_FRAMES // SUSTAINED_WINDOW
          and all(w.shape == (SUSTAINED_WINDOW, *FULL_HD, 3) for w in wins),
          f"sliding_windows gave {[w.shape for w in wins]}")
    batches = [np.stack(wins[i:i + SUSTAINED_WB])
               for i in range(0, len(wins) - SUSTAINED_WB + 1, SUSTAINED_WB)]
    n_frames = len(batches) * SUSTAINED_WB * SUSTAINED_WINDOW
    models = {dtype: TwoStreamModel.create(
        num_classes=101, flow_stack=10, dtype=dtype, width=64).init(
            torch.Generator().manual_seed(0)).to(dev).eval()
        for dtype in (torch.float32, torch.bfloat16)}
    zero, read = main_path_counters()
    nothing = dict.fromkeys(read(), 0)
    total = dict(nothing)
    report = {"frames": n_frames, "frame_hw": list(FULL_HD),
              "windows": len(wins), "batches": len(batches),
              "windows_per_batch": SUSTAINED_WB,
              "cnn_dtypes": {"": "float32", "_bf16": "bfloat16"},
              "host_bytes_per_batch": int(batches[0].nbytes)}

    def one_pass(cfg):
        feed = DevicePrefetcher(batches, depth=2, device=dev)
        with torch.no_grad():
            probs = [classify_batch(wb, model, cfg) for wb in feed]
        torch.cuda.synchronize()
        return probs, feed

    with tempfile.TemporaryDirectory() as work:
        writer = MetricsWriter(os.path.join(work, "metrics.jsonl"))
        emitted = []
        for (algo, dtype), model in (
                ((a, d), models[d]) for d in models
                for a in ("farneback", "tvl1")):
            suffix = "" if dtype == torch.float32 else "_bf16"
            cfg = PipelineConfig(flow_algo=algo, window=SUSTAINED_WINDOW)
            crop = cfg.preprocess.crop
            per_batch = {**(fb_expected(len(_level_sizes(crop, crop,
                                                         cfg.farneback)),
                                        cfg.farneback.iterations)
                            if algo == "farneback"
                            else {"tvl1_scale": len(SIZES)}),
                         **norm_expected(1)}
            want = {**nothing, **{k: v * len(batches)
                                  for k, v in per_batch.items()}}
            torch.cuda.reset_peak_memory_stats(dev)
            zero()
            probs, feed = one_pass(cfg)
            launches = read()
            check(launches == want, f"sustained ({algo}{suffix}) launched "
                  f"{launches}, expected {want}")
            for k, n in launches.items():
                total[k] += n
            peak = torch.cuda.max_memory_allocated(dev)
            pinned = [[tuple(b.shape) for b in slot.buffers]
                      for slot in feed._slots]
            check(sum(map(len, pinned)) == len(batches)
                  and all(shapes in ([], [batches[0].shape])
                          for shapes in pinned),
                  f"prefetcher's pinned buffers {pinned}")
            put_s = feed.stats["put_s"]
            del feed        # its pinned buffers go back to the host cache
            fps = []
            for _ in range(SUSTAINED_PASSES):
                t0 = time.perf_counter()
                one_pass(cfg)
                fps.append(n_frames / (time.perf_counter() - t0))
            prof, ok = device_profile_until(
                torch, lambda: one_pass(cfg),
                lambda p: p["port_kernels_device_ms"])
            errs = []
            with torch.no_grad():
                for b, p in zip(batches, probs):
                    plain = classify_batch(torch.from_numpy(b).to(dev), model,
                                           cfg, plain=True)
                    errs.append(float((plain - p).abs().max()))
                check(max(errs) <= TOL_PROBS,
                      f"sustained ({algo}{suffix}) batches vs the plain "
                      f"path: {errs} > {TOL_PROBS}")
                streamed = sum(p.sum(0) for p in probs) / len(wins)
                per_window = torch.stack([classify_window(
                    torch.from_numpy(w).to(dev), model, cfg)
                    for w in wins]).mean(0)
            e_clip = float((streamed - per_window).abs().max())
            check(e_clip <= TOL_PROBS and abs(float(streamed.sum()) - 1) < 1e-4,
                  f"sustained ({algo}{suffix}) clip mean vs per-window mean: "
                  f"{e_clip}")
            fps_median = float(np.median(fps))
            busy = (prof["device_busy_ms"] / prof["profiled_wall_ms"]
                    if ok else None)       # not measured
            emitted.append(writer.emit(
                "sustained_1080p_two_stream_fps", fps_median, "frames/s",
                algo=algo, cnn_dtype=str(dtype), passes=fps,
                card=CARD.get("card")))
            emitted.append(writer.emit(
                "sustained_1080p_device_busy_share", busy, "", algo=algo,
                cnn_dtype=str(dtype)))
            report[algo + suffix] = {
                "frames_per_s_median": fps_median, "frames_per_s_passes": fps,
                "device_busy_share": busy,
                "profiled_pass_ms": prof["profiled_wall_ms"],
                "device_busy_ms": prof["device_busy_ms"],
                "port_kernels_device_ms": prof["port_kernels_device_ms"],
                "launches_per_batch": {k: v // len(batches)
                                       for k, v in launches.items() if v},
                "max_abs_vs_plain": errs, "clip_mean_vs_windows": e_clip,
                "max_memory_allocated_bytes": peak,
                "pinned_buffers": pinned,
                "prefetcher_put_s": put_s}
        with open(writer.path) as f:
            back = [json.loads(line) for line in f]
    check(back == emitted and [r["metric"] for r in back] == [
        "sustained_1080p_two_stream_fps",
        "sustained_1080p_device_busy_share"] * 4,
          f"metrics read back {back}, emitted {emitted}")
    emit({"phase": "sustained", "card": CARD.get("card"), **report,
          "metrics_records": len(back)})
    return total


ASYNC_STEPS = 6
ASYNC_SAVE_AFTER = (2, 4)


def async_checkpoint_phase(torch, np, dev):
    """``AsyncCheckpointer`` at full width: 6 two-stream ``train`` steps
    (batch 32 of 11-frame 240x320 windows, ``TVL1Config()``, SGD with
    momentum) with ``save`` of ``two_stream_variables`` (~90 MB) after
    steps 2 and 4; the ms of each step, of building the tree (its copy off
    the card) and of ``save`` (the staging; the write runs meanwhile on
    the writer thread), then the same 6 steps with the blocking
    ``save_variables``.  Then: ``save`` of the model's ``state_dict``
    (CUDA leaves: pinned buffers, one event) timed, and restored into a
    fresh model's on the card, bit for bit; the step-4 checkpoint
    restored into a template of CUDA tensors, bit for bit; with the
    primary deleted, the step-2 one from ``.prev`` with a
    ``RuntimeWarning``; a write that cannot be made raises at ``wait()``.
    Returns the launches per kernel of the 12 steps."""
    import shutil
    import tempfile
    import warnings

    from video_analytics_tpu_torch.config import PipelineConfig
    from video_analytics_tpu_torch.models.two_stream import TwoStreamModel
    from video_analytics_tpu_torch.runtime import train_two_stream as tts
    from video_analytics_tpu_torch.runtime.checkpoint import (
        AsyncCheckpointer, save_variables)

    cfg = PipelineConfig()
    L = cfg.preprocess.flow_stack
    tcfg = train_config()

    def fresh():
        return TwoStreamModel.create(num_classes=cfg.num_classes,
                                     flow_stack=L, width=64).init(
            torch.Generator().manual_seed(0)).to(dev)

    model = fresh()
    steps = tts.make_two_stream_train_steps(
        tts.create_two_stream_states(model, 1e-3, "both"))
    windows = torch.from_numpy(train_windows(np, TRAIN_BATCH, L + 1,
                                             seed=40)).to(dev)
    y = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.num_classes, TRAIN_BATCH)).to(dev)
    gen = torch.Generator().manual_seed(0)

    def step():
        ex = tts.build_examples(windows, tcfg, "both",
                                tts.draw_crops(gen, windows, tcfg))
        return {k: float(fn(ex[k], y)["loss"]) for k, fn in steps.items()}

    def leaves(tree, path=""):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from leaves(tree[k], f"{path}/{k}")
        else:
            yield path, tree

    zero, read = flow_counters()
    report, saved = {}, {}
    with tempfile.TemporaryDirectory() as work, AsyncCheckpointer() as ck:
        primary = os.path.join(work, "ck")
        zero()
        for mode in ("async", "blocking"):
            rows = []
            for i in range(1, ASYNC_STEPS + 1):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses = step()
                torch.cuda.synchronize()
                row = {"step": i, "step_ms": 1e3 * (time.perf_counter() - t0),
                       "losses": losses}
                if i in ASYNC_SAVE_AFTER:
                    t0 = time.perf_counter()
                    tree = tts.two_stream_variables(model)
                    t1 = time.perf_counter()
                    if mode == "async":
                        ck.save(primary, tree)
                        saved[i] = tree
                    else:
                        save_variables(os.path.join(work, "ck.msgpack"), tree)
                    row.update(tree_ms=1e3 * (t1 - t0),
                               save_ms=1e3 * (time.perf_counter() - t1))
                rows.append(row)
            t0 = time.perf_counter()
            ck.wait()
            report[mode] = {"steps": rows,
                            "wait_after_last_step_ms":
                                1e3 * (time.perf_counter() - t0)}
        launches = read()
        want = {**dict.fromkeys(launches, 0),
                "tvl1_scale": 2 * ASYNC_STEPS * len(SIZES)}
        check(launches == want, f"the train steps launched {launches}, "
              f"expected {want}")
        nbytes = sum(a.nbytes for _, a in leaves(saved[4]))

        # CUDA leaves: the pinned staging alone, then restored on the card.
        sd = model.state_dict()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ck.save(os.path.join(work, "sd"), sd)
        stage_ms = 1e3 * (time.perf_counter() - t0)
        other = fresh()
        other.load_state_dict(ck.restore(os.path.join(work, "sd"),
                                         other.state_dict()))
        check(all(torch.equal(a, b) for a, b in zip(
            model.state_dict().values(), other.state_dict().values())),
            "the state_dict restored on the card differs")

        def on_card(tree):
            return {k: on_card(v) if isinstance(v, dict)
                    else torch.from_numpy(v).to(dev) for k, v in tree.items()}

        def equal(tree, ref):
            got, want_ = dict(leaves(tree)), dict(leaves(ref))
            return sorted(got) == sorted(want_) and all(
                got[k].is_cuda and torch.equal(got[k].cpu(),
                                               torch.from_numpy(want_[k]))
                for k in got)

        template = on_card(fresh().flax_variables())
        check(equal(ck.restore(primary, template), saved[4]),
              "the step-4 checkpoint restored on the card differs")
        shutil.rmtree(primary)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            back = ck.restore(primary, template)
        check(equal(back, saved[2]) and any(
            issubclass(w.category, RuntimeWarning) for w in caught),
            "no fallback to the step-2 checkpoint in .prev")
        # A write that cannot be made is raised at wait().  Root ignores a
        # directory's mode bits, so there the parent is a regular file.
        ro = os.path.join(work, "read_only")
        os.makedirs(ro)
        os.chmod(ro, 0o555)
        target = os.path.join(ro, "ck")
        if os.access(ro, os.W_OK):
            blocker = os.path.join(work, "a_file")
            open(blocker, "w").close()
            target = os.path.join(blocker, "ck")
        ck.save(target, saved[2])
        try:
            ck.wait()
            failure = None
        except OSError as e:
            failure = repr(e)
        check(failure is not None, f"the write to {target} did not raise")
    blocking = [r["save_ms"] for r in report["blocking"]["steps"]
                if "save_ms" in r]
    staged = [r["save_ms"] for r in report["async"]["steps"]
              if "save_ms" in r]
    emit({"phase": "async_checkpoint", "card": CARD.get("card"),
          "tree_bytes": nbytes, **report,
          "save_block_ms_async": staged, "save_ms_blocking": blocking,
          "state_dict_cuda_stage_ms": stage_ms,
          "restored_on_card_bit_equal": True, "prev_fallback": True,
          "failed_write": {"target": os.path.relpath(target, work),
                           "raised_at_wait": failure},
          "launches": {k: v for k, v in launches.items() if v}})
    return launches


BF16_TRAIN_BATCH = 4
# Card against the CPU's bfloat16 CNN, each bound set from what the card
# gave (NVIDIA H100 80GB HBM3, 700.00 W): logits of the largest, measured
# 4.1e-3-7.5e-3 (the CPU tests' bound against the JAX package);
# probabilities absolute, measured 5.8e-6-1.0e-5, ten times that (the
# float32 model is 2.3e-5-5.1e-5 away, which the phase holds apart on
# its own); a train step's loss relative, measured 5.5e-5-1.6e-4.
TOL_BF16_LOGITS = 2e-2
TOL_BF16_PROBS = 1e-4
TOL_BF16_LOSS = 2e-3
MMA_MARKS = ("xmma", "gmma", "cutlass", "16816", "tensorop", "hmma")


def cnn_kernels(torch, fn, tries: int = 5):
    """The device kernels of one call of fn() under torch.profiler (taken
    again, up to `tries` times, while it records none): name (its first
    160 characters), launches and device ms, by device time; ``bf16_mma``
    marks a name that is a bfloat16 tensor-core kernel's."""
    from torch.profiler import ProfilerActivity, profile

    per = {}
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        for ev in prof.events():
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue
            ms, n = per.get(ev.name, (0.0, 0))
            per[ev.name] = (ms + (ev.time_range.end
                                  - ev.time_range.start) / 1e3, n + 1)
        if per:
            break
        PROFILER["retaken_sessions"] += 1
    check(bool(per), "torch.profiler recorded no kernel of the CNN")
    low = {name: name.lower() for name in per}
    return [{"name": name[:160], "launches": n, "ms": ms,
             "bf16_mma": "bf16" in low[name]
             and any(m in low[name] for m in MMA_MARKS)}
            for name, (ms, n) in sorted(per.items(), key=lambda kv: -kv[1][0])]


def bf16_phase(torch, np, dev):
    """Phase 18: the reference's reduced-precision CNN (``dtype``: bfloat16
    activations, float32 parameters) at full width: two ResNet-18s, width
    64, 101 classes, crop 224, ``flow_stack`` 10, seed-0 weights, built by
    ``TwoStreamModel.create(dtype=torch.bfloat16)``.  For TV-L1
    (``TVL1Config()``) and Farneback, on the serve phases' scenes:
    three ``ClipServer`` requests with every launch count set to 0 just
    before and held to the float32 requests' numbers just after (5
    ``tvl1_scale``; 3 ``fb_prologue`` and 9 ``fb_iteration``); the answer
    against the plain versions of the kernels (TOL_PROBS: the flow is the
    same float32); the request's two CNNs against the same bfloat16 model
    on the CPU on the same inputs (logits TOL_BF16_LOGITS of the largest,
    probabilities TOL_BF16_PROBS); the float32 model with the same weights
    on the same request (probabilities' max abs difference, farther than
    the CPU's bfloat16, top-1 equal);
    the request's host ms and each stream's CNN ms in bfloat16 and float32
    (CUDA events); cuDNN's kernels for each stream and for the flow
    stem's 20-channel convolution alone, from torch.profiler.  Then the
    ``fc`` with cuBLAS's reduced-precision bfloat16 reductions on and off
    against a float32 sum of the same bfloat16 products, and one
    two-stream train step at batch 4 on the card against the CPU (loss
    TOL_BF16_LOSS).  Returns the requests' launches per kernel."""
    import copy

    from video_analytics_tpu_torch.config import PipelineConfig
    from video_analytics_tpu_torch.flow.farneback import _level_sizes
    from video_analytics_tpu_torch.ingest.windows import apply_transport_crop
    from video_analytics_tpu_torch.models.two_stream import TwoStreamModel
    from video_analytics_tpu_torch.ops import preprocess as pp
    from video_analytics_tpu_torch.runtime import pipeline
    from video_analytics_tpu_torch.runtime import train_two_stream as tts
    from video_analytics_tpu_torch.runtime.serve import ClipServer

    bf16 = torch.bfloat16
    pcfg = PipelineConfig()
    L = pcfg.preprocess.flow_stack

    def build(dtype):
        return TwoStreamModel.create(num_classes=pcfg.num_classes,
                                     flow_stack=L, dtype=dtype,
                                     width=64).init(
            torch.Generator().manual_seed(0))

    bf, f32 = build(bf16), build(torch.float32)
    check(bf.spatial.dtype == bf.temporal.dtype == bf16
          and all(v.dtype != bf16 for v in bf.state_dict().values()),
          "the bfloat16 model's parameters are not float32")
    check(all(torch.equal(a, b) for a, b in zip(
        bf.state_dict().values(), f32.state_dict().values())),
          "the bfloat16 and float32 models' seed-0 weights differ")
    cpu = copy.deepcopy(bf).eval()
    zero, read = main_path_counters()
    nothing = dict.fromkeys(read(), 0)
    total = dict(nothing)
    report = {"card": CARD.get("card"), "width": 64,
              "num_classes": pcfg.num_classes, "crop": pcfg.preprocess.crop,
              "flow_stack": L}
    for algo in ("tvl1", "farneback"):
        fmax = 0.12 if algo == "tvl1" else FB_FMAX
        frames = np.stack([np.stack([scene(np, t, 256, 256, seed=c,
                                           fmax=fmax)
                                     for c in range(3)], axis=-1)
                           for t in range(16)]).round().astype(np.uint8)
        cfg = PipelineConfig(flow_algo=algo)
        per_request = {
            **({"tvl1_scale": len(SIZES)} if algo == "tvl1" else fb_expected(
                len(_level_sizes(224, 224, cfg.farneback)),
                cfg.farneback.iterations)),
            **norm_expected(1)}
        server = ClipServer(bf, cfg, dev)
        warm_s = server.warmup()
        request_ms, outs, launches = serve_requests(
            server, frames, zero, read, {**nothing, **per_request})
        for k, n in launches.items():
            total[k] += n
        probs = outs[0]
        e_plain = check_probs(torch, np, server, frames, probs)

        # The request's CNN inputs, and both CNNs on the card and the CPU.
        wins, wcfg = apply_transport_crop(server._windows_from_frames(frames),
                                          server.cfg)
        with torch.no_grad():
            x = pipeline._crop(server._to_device(wins), wcfg)
            rgb = pp.normalize(x, wcfg.preprocess.mean, wcfg.preprocess.std)
            rgb = rgb.reshape(-1, *rgb.shape[2:])
            stacks = pipeline._flow_stacks(x, wcfg, False, None, bf16)[0]
            stacks32 = pipeline._flow_stacks(x, wcfg, False)[0]
            check(stacks.dtype == bf16 and torch.equal(
                stacks, stacks32.to(bf16)), "bfloat16 stacks")
            card = {"spatial": bf.spatial(rgb),
                    "temporal": bf.temporal(stacks)}
            host = {"spatial": cpu.spatial(rgb.cpu()),
                    "temporal": cpu.temporal(stacks.cpu())}
            fused = bf.fuse(card["spatial"].mean(0), card["temporal"].mean(0))
            host_fused = cpu.fuse(host["spatial"].mean(0),
                                  host["temporal"].mean(0))
        e_request = float(np.abs(fused.cpu().numpy() - probs).max())
        check(e_request <= TOL_PROBS,
              f"bf16 ({algo}): the CNNs rerun vs the request: {e_request}")
        logit_err = {}
        for k in card:
            c, h = card[k].cpu(), host[k]
            check(c.dtype == torch.float32
                  and torch.equal(c, c.bfloat16().float()),
                  f"bf16 ({algo}) {k} logits are not bfloat16 values")
            logit_err[k] = float((c - h).abs().max() / h.abs().max())
        e_cpu = float((fused.cpu() - host_fused).abs().max())
        check(max(logit_err.values()) <= TOL_BF16_LOGITS
              and e_cpu <= TOL_BF16_PROBS,
              f"bf16 ({algo}) card vs CPU: logits {logit_err}, "
              f"probabilities {e_cpu}")

        # The float32 model on the same request.
        p32 = ClipServer(f32, cfg, dev)._classify(
            server._windows_from_frames(frames))
        e_f32 = float(np.abs(p32 - probs).max())
        check(e_cpu < e_f32,
              f"bf16 ({algo}): the float32 model ({e_f32}) is no farther "
              f"than the CPU's bfloat16 ({e_cpu}) from the card's answer")
        check(int(p32.argmax()) == int(probs.argmax()),
              f"bf16 ({algo}): top-1 {int(probs.argmax())}, float32 "
              f"{int(p32.argmax())}")

        with torch.no_grad():
            cnn_ms = {
                "spatial_bf16": cuda_ms(torch, lambda: bf.spatial(rgb)),
                "spatial_f32": cuda_ms(torch, lambda: f32.spatial(rgb)),
                "temporal_bf16": cuda_ms(torch, lambda: bf.temporal(stacks)),
                "temporal_f32": cuda_ms(torch,
                                        lambda: f32.temporal(stacks32))}
            kernels = None
            if algo == "tvl1":
                stem_in = stacks.permute(0, 3, 1, 2).contiguous(
                    memory_format=torch.channels_last)
                kernels = {
                    "spatial_bf16": cnn_kernels(torch,
                                                lambda: bf.spatial(rgb)),
                    "temporal_bf16": cnn_kernels(
                        torch, lambda: bf.temporal(stacks)),
                    "temporal_stem_bf16": cnn_kernels(
                        torch, lambda: bf.temporal.conv1(stem_in)),
                    "temporal_stem_f32": cnn_kernels(
                        torch, lambda: f32.temporal.conv1(stem_in.float()))}
        flops = {"spatial": ROOFLINE.cnn_work(bf.spatial, rgb).flops,
                 "temporal": ROOFLINE.cnn_work(bf.temporal, stacks).flops}
        report[algo] = {
            "warmup_s": warm_s, "request_ms": request_ms,
            "launches_per_request": {k: v // SERVE_REQUESTS
                                     for k, v in launches.items() if v},
            "top1": int(probs.argmax()), "top1_f32": int(p32.argmax()),
            "probs_max_abs_vs_plain": e_plain,
            "probs_max_abs_vs_f32_model": e_f32,
            "card_vs_cpu_logits_rel": logit_err,
            "card_vs_cpu_probs_max_abs": e_cpu,
            "cnn_ms_cuda_events": cnn_ms,
            "cnn_images": {"spatial": rgb.shape[0],
                           "temporal": stacks.shape[0]},
            "cnn_gflop": {k: v / 1e9 for k, v in flops.items()},
            "cnn_bound_ms_bf16": {k: 1e3 * v / ROOFLINE.BF16_FLOP_PER_S
                                  for k, v in flops.items()},
            "cnn_bound_ms_f32": {k: 1e3 * v / ROOFLINE.F32_FLOP_PER_S
                                 for k, v in flops.items()},
            **({"cudnn_kernels": kernels} if kernels else {})}

    # cuBLAS's reduced-precision bfloat16 reductions, on the fc.
    with torch.no_grad():
        pooled = bf.spatial(rgb, return_features=True).to(bf16)
        w = bf.spatial.fc.weight.to(bf16)
        matmul = torch.backends.cuda.matmul
        flag = matmul.allow_bf16_reduced_precision_reduction
        outs = {}
        for on in (True, False):
            matmul.allow_bf16_reduced_precision_reduction = on
            outs[on] = torch.nn.functional.linear(pooled, w)
        matmul.allow_bf16_reduced_precision_reduction = flag
        exact = (pooled.double() @ w.double().t()).to(bf16)
        report["fc_bf16_reduction"] = {
            "shape": [list(pooled.shape), list(w.shape)],
            "setting": flag,
            "reduced_vs_full_max_abs": float(
                (outs[True].float() - outs[False].float()).abs().max()),
            "reduced_vs_float64_rounded_max_abs": float(
                (outs[True].float() - exact.float()).abs().max()),
            "full_vs_float64_rounded_max_abs": float(
                (outs[False].float() - exact.float()).abs().max())}

    # One two-stream train step at batch 4, on the card and on the CPU.
    model = build(bf16)
    host_model = copy.deepcopy(model)
    model.to(dev)
    g = torch.Generator().manual_seed(4)
    crop = pcfg.preprocess.crop
    ex = {"rgb": torch.randn((BF16_TRAIN_BATCH, crop, crop, 3), generator=g),
          "flow": torch.rand((BF16_TRAIN_BATCH, crop, crop, 2 * L),
                             generator=g) * 2 - 1}
    y = torch.randint(0, pcfg.num_classes, (BF16_TRAIN_BATCH,), generator=g)
    card_steps = tts.make_two_stream_train_steps(
        tts.create_two_stream_states(model, 1e-3, "both"))
    host_steps = tts.make_two_stream_train_steps(
        tts.create_two_stream_states(host_model, 1e-3, "both"))
    steps = {}
    for k in ("rgb", "flow"):
        got = float(card_steps[k](ex[k].to(dev), y.to(dev))["loss"])
        want = float(host_steps[k](ex[k], y)["loss"])
        rel = abs(got - want) / abs(want)
        check(rel <= TOL_BF16_LOSS and np.isfinite(got),
              f"bf16 train step ({k}): card {got}, CPU {want}")
        steps[k] = {"card_loss": got, "cpu_loss": want, "rel": rel}
    check(all(p.dtype == torch.float32 for p in model.parameters()),
          "a bfloat16 train step left non-float32 parameters")
    report["train_step_batch4"] = steps
    report["tolerances"] = {"probs_vs_plain": TOL_PROBS,
                            "logits_vs_cpu_rel": TOL_BF16_LOGITS,
                            "probs_vs_cpu": TOL_BF16_PROBS,
                            "loss_vs_cpu_rel": TOL_BF16_LOSS}
    emit({"phase": "bf16", **report})
    return total


def expected_flow_launches(algo: str, h: int, w: int):
    """Launches per kernel of one flow call at (h, w) with the default
    config, derived from the flow modules' routes: TV-L1 by
    ``level_solver``, per "warp" level one ``tvl1_scale``, per "chunked"
    level `warps` K-A, ``ceil(inner / chunk)`` K-G a round (a round's last
    but a warp's last with the bands' test) and the scale-end K-C;
    Farneback by
    ``fb_expected`` over its levels, prologue forms and window route;
    SpyNet none."""
    from video_analytics_tpu_torch.config import FarnebackConfig, TVL1Config
    from video_analytics_tpu_torch.flow import farneback as fb
    from video_analytics_tpu_torch.flow import tvl1 as tl
    from video_analytics_tpu_torch.ops.cuda import farneback as fk
    from video_analytics_tpu_torch.ops.cuda import tvl1_solve as ts

    want = dict.fromkeys(flow_counters()[1](), 0)
    if algo == "tvl1":
        cfg = TVL1Config()
        for lh, lw in tl._level_sizes(h, w, cfg):
            route = tl.level_solver(lh, lw, cfg.median_filtering)
            check(route != "chain", f"a level {lh}x{lw} of {h}x{w} takes the "
                                    f"per-iteration kernels")
            if route == "warp":
                want["tvl1_scale"] += 1
                continue
            want["tvl1_pd_chunk"] += cfg.warps * cfg.outer_iterations * -(
                -cfg.inner_iterations // ts.chunk_params(lh, lw, cfg)[1])
            want["tvl1_pd_chunk_flags"] += cfg.warps * (
                cfg.outer_iterations - 1)
            want["warp_prep"] += cfg.warps
            want["median5"] += 1
    elif algo == "farneback":
        cfg = FarnebackConfig()
        levels = fb._level_sizes(h, w, cfg)
        forms = [fk.prologue_form(h, w, lh, lw, sc, cfg.poly_n)[0]
                 for lh, lw, sc in levels]
        want.update(fb_expected(len(levels), cfg.iterations,
                                split=forms.count("split"),
                                route=fk.window_route(cfg.winsize)))
    return want


# compute-flow with its default bucketing: (algorithm, frame size, frames).
BUCKETED = (("farneback", NATIVE, 3), ("tvl1", NATIVE, 3),
            ("tvl1", (280, 300), 3), ("tvl1", FULL_HD, 3))


def compute_flow_bucketed_phase(torch, np, dev):
    """``compute-flow`` with its default flags, which pad each pair at its
    edges to the next multiple of 64 on both axes, compute there and crop
    back (``ops/bucketing``): Farneback and TV-L1 on 3 frames of 240x320
    (bucket 256x320), TV-L1 on 3 frames of 280x300 (320x320: its finest
    level is above the size rule, so K-G there and ``tvl1_scale`` below)
    and of 1080x1920 (1088x1920).  Each default command's launches,
    counted from 0 just before it, against ``expected_flow_launches`` at
    the bucket; its ``.flo`` files against the plain path's
    bucketed-then-cropped flow on the same decoded frames (Farneback
    equal; TV-L1 within 10·ε, the reference's bound for a skipped round,
    since an ε test summed in another order can flip at its threshold;
    bit-equality reported); the same command with ``--no-bucket`` beside
    it, and one flow call of each form timed in turns.  Returns the
    default commands' launches per kernel, summed."""
    import tempfile

    from video_analytics_tpu_torch.cli.main import _load_frames
    from video_analytics_tpu_torch.config import FarnebackConfig, TVL1Config
    from video_analytics_tpu_torch.flow.farneback import farneback
    from video_analytics_tpu_torch.flow.tvl1 import tvl1
    from video_analytics_tpu_torch.io.flowio import read_flo
    from video_analytics_tpu_torch.io.video import write_frames
    from video_analytics_tpu_torch.ops.bucketing import (
        bucket_hw, bucketed_flow)
    from video_analytics_tpu_torch.ops.preprocess import rgb_to_gray

    tv, fbc = TVL1Config(), FarnebackConfig()
    zero, read = flow_counters()
    total, report = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for algo, (h, w), n in BUCKETED:
            fmax = FB_FMAX if algo == "farneback" else 0.12
            planes = [scene(np, t, h, w, seed=13, fmax=fmax)
                      for t in range(n)]
            frames = np.stack([np.stack([g * img for g in (1.0, 0.85, 0.7)],
                                        axis=-1)
                               for img in planes]).round().astype(np.uint8)
            src = os.path.join(tmp, f"frames_{algo}_{h}x{w}")
            write_frames(frames, src)
            flows, seconds, counts = {}, {}, {}
            for form, extra in (("bucketed", []), ("native", ["--no-bucket"])):
                out = os.path.join(tmp, f"flow_{algo}_{h}x{w}_{form}")
                zero()
                t0 = time.perf_counter()
                rc, res = run_cli(["compute-flow", src, out, "--algo", algo,
                                   "--format", "flo", "--batch",
                                   str(CF_BATCH), *extra, "--device", "cuda"])
                torch.cuda.synchronize()
                seconds[form] = time.perf_counter() - t0
                check(rc == 0 and res["flows"] == n - 1,
                      f"compute-flow --algo {algo} at {h}x{w} {extra}: "
                      f"{rc} {res}")
                counts[form] = read()
                flows[form] = np.stack([read_flo(os.path.join(out, f))
                                        for f in sorted(os.listdir(out))])
            launches = counts["bucketed"]
            bh, bw = bucket_hw(h, w)
            calls = -(-(n - 1) // CF_BATCH)
            want = {k: calls * v
                    for k, v in expected_flow_launches(algo, bh, bw).items()}
            check(launches == want,
                  f"compute-flow --algo {algo} at {h}x{w} (bucket {bh}x{bw}) "
                  f"launched {launches}, expected {want}")
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v

            def flow_fn(a, b, plain=False):
                if algo == "tvl1":
                    return tvl1(a, b, tv, plain=plain)
                return farneback(a, b, fbc, plain=plain)

            gray = rgb_to_gray(torch.from_numpy(_load_frames(src, None)).to(
                dev))
            prev, nxt = gray[:-1], gray[1:]
            with torch.no_grad():
                plain = bucketed_flow(lambda a, b: flow_fn(a, b, True), prev,
                                      nxt).cpu().numpy()
                got = flows["bucketed"]
                dev_abs = float(np.abs(got - plain).max())
                tol = 10 * tv.epsilon if algo == "tvl1" else TOL_FB
                check(got.shape == (n - 1, h, w, 2) and dev_abs <= tol,
                      f"compute-flow --algo {algo} at {h}x{w}: {got.shape}, "
                      f"max abs {dev_abs} against the plain path's "
                      f"bucketed flow")
                mean = got[0, 32:-32, 32:-32].reshape(-1, 2).mean(0).tolist()
                check(abs(mean[0] - VEL[0]) < TOL_MEAN_FLOW
                      and abs(mean[1] - VEL[1]) < TOL_MEAN_FLOW,
                      f"bucketed {algo} at {h}x{w}: mean flow {mean}")
                t = [cuda_ms(torch, f, 3) for f in (
                    lambda: bucketed_flow(flow_fn, prev, nxt),
                    lambda: flow_fn(prev, nxt), lambda: flow_fn(prev, nxt),
                    lambda: bucketed_flow(flow_fn, prev, nxt))]
            report[f"{algo} {h}x{w}"] = {
                "bucket": [bh, bw], "pairs": n - 1,
                "launches": {k: v for k, v in launches.items() if v},
                "launches_native": {k: v for k, v in counts["native"].items()
                                    if v},
                "max_abs_vs_plain_path": dev_abs,
                "bit_equal_to_plain_path": bool(np.array_equal(got, plain)),
                "tolerance": tol, "mean_flow": mean,
                "max_abs_bucketed_vs_native": float(
                    np.abs(got - flows["native"]).max()),
                "command_seconds": seconds["bucketed"],
                "command_seconds_native": seconds["native"],
                "flow_call_ms": [t[0], t[3]],
                "flow_call_ms_native": [t[1], t[2]],
                "pixels_ratio": bh * bw / (h * w)}
    emit({"phase": "compute_flow_bucketed", "by_command": report, **CARD})
    return total


# tools/torch_flow_quality.py at its defaults but --val-batches (4 there).
FQ_HW, FQ_BATCH, FQ_VAL_BATCHES, FQ_REPS = 224, 16, 2, 4
TOL_FQ = 1e-6          # EPE, kernels against their plain versions


def flow_quality_phase(torch, np, dev):
    """``tools/torch_flow_quality.py``'s shoot-out on the card at 224², 16
    pairs a call, ``TVL1Config()``, ``FarnebackConfig()`` and the bundled
    SpyNet, 2 validation batches (the tool's default is 4): each
    algorithm's EPE per family with the launch counts set to 0 just before
    and held just after to ``expected_flow_launches`` at 224² times the
    calls (5 ``tvl1_scale``; 3 ``fb_prologue`` + 9 ``fb_iteration``;
    SpyNet none), the same EPEs through the kernels' plain versions (TV-L1
    and Farneback) within 1e-6, pairs/s and the launches of one call; the
    tool's table.  Returns the launches per kernel of the EPE passes."""
    from video_analytics_tpu_torch.models.spynet import synthetic_pair

    tool = load_tool("torch_flow_quality")
    fams = tool.families(FQ_HW, FQ_BATCH, FQ_VAL_BATCHES)
    calls = sum(len(batches) for _, batches in fams.values())
    fns, ckpt = tool.flow_functions(dev)
    plain_fns, _ = tool.flow_functions(dev, plain=True)
    prev, nxt, _ = synthetic_pair(torch.Generator().manual_seed(5), FQ_BATCH,
                                  FQ_HW, FQ_HW, local_blobs=2)
    prev, nxt = prev.to(dev), nxt.to(dev)
    zero, read = flow_counters()
    results, total, report = {}, {}, {}
    for name, fn in fns.items():
        zero()
        t0 = time.perf_counter()
        res = tool.measure_epe(fn, fams, dev)
        epe_s = time.perf_counter() - t0
        launches = read()
        want = {k: calls * v for k, v in
                expected_flow_launches(name, FQ_HW, FQ_HW).items()}
        check(launches == want,
              f"flow quality {name}: {launches} over {calls} calls, "
              f"expected {want}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        err = None
        if name != "spynet":
            plain = tool.measure_epe(plain_fns[name], fams, dev)
            err = max(abs(res[k] - plain[k]) for k in res)
            check(err <= TOL_FQ,
                  f"flow quality {name}: EPE kernels vs plain {err}: {res} "
                  f"{plain}")
        res["pairs_per_sec"] = tool.pairs_per_sec(fn, prev, nxt, FQ_REPS)
        results[name] = res
        report[name] = {**res, "epe_seconds": epe_s, "calls": calls,
                        "max_abs_epe_vs_plain": err,
                        "launches_per_call": tool.launches_of_one_call(
                            fn, prev, nxt)}
    emit({"phase": "flow_quality", "hw": FQ_HW, "batch": FQ_BATCH,
          "val_batches": FQ_VAL_BATCHES, "reps": FQ_REPS,
          "by_algo": report, **CARD})
    tool.print_results(results, FQ_HW, FQ_BATCH,
                       os.path.relpath(ckpt, HERE))
    return total


# The keys of tools/eval_breakdown.py's JSON line and of its ledger.
EB_KEYS = ("decode_ms_per_clip", "hostprep_ms_per_batch",
           "deviceput_ms_per_batch", "batch_mb", "implied_transfer_mbps",
           "device_ms_per_batch_deep", "device_ms_per_batch_single",
           "dispatch_rtt_ms", "clips_per_sec_e2e")
EB_LEDGER = ("wall_ms_per_clip", "decode_per_clip_2workers",
             "deviceput_per_clip", "device_compute_per_clip",
             "dispatch_rtt_per_clip", "hostprep_per_clip",
             "decode_not_hidden", "unattributed")
# wall_ms_per_clip, decode_not_hidden and unattributed are each rounded to
# 0.01, so the ledger's sum may miss the wall by three half-hundredths.
TOL_EB_LEDGER = 0.015 + 1e-9


def eval_breakdown_phase(torch, np, dev):
    """``tools/torch_eval_breakdown.py``'s ``breakdown`` on the card at its
    full protocol: the synthetic UCF101's 32 test clips (8 classes x 4, 48
    frames at 240x320), ``PipelineConfig(flow_algo="farneback",
    window=16)``, the bfloat16 model from seed 0, batches of 8, 2 decode
    workers, 3 timed passes.  Each key of the reference's line must be
    finite, every pass must evaluate the 32 clips with no failure (the tool
    raises otherwise), the ledger must add up to the wall time per clip,
    and each timed pass, its launch counts set to 0 just before and read
    just after, must launch 4 batch calls' worth of
    ``expected_flow_launches("farneback", 224, 224)`` (3 ``fb_prologue``
    and 9 ``fb_iteration`` a call) and nothing else.  Returns the launches
    per kernel summed over the timed passes."""
    import tempfile

    from video_analytics_tpu_torch.config import PipelineConfig
    from video_analytics_tpu_torch.io.synthetic import build_synthetic_ucf101
    from video_analytics_tpu_torch.models.two_stream import TwoStreamModel

    tool = load_tool("torch_eval_breakdown")
    t0 = time.perf_counter()
    cfg = PipelineConfig(flow_algo="farneback", window=16)
    model = TwoStreamModel.create(num_classes=101, flow_stack=tool.FLOW_STACK,
                                  dtype=torch.bfloat16)
    model.init(torch.Generator().manual_seed(0))
    model = model.to(dev).eval()
    zero, read = flow_counters()
    with tempfile.TemporaryDirectory() as root:
        records = build_synthetic_ucf101(
            root, num_classes=tool.NUM_CLASSES,
            clips_per_class=tool.CLIPS_PER_CLASS,
            num_frames=tool.NUM_FRAMES, h=tool.SRC_H, w=tool.SRC_W,
            train_fraction=0.0).test_records()
        dataset_s = time.perf_counter() - t0
        res = tool.breakdown(records, model, cfg, dev, counters=(zero, read))
    check(len(records) == 32, f"eval breakdown: {len(records)} test clips")
    bad = [k for k in EB_KEYS if not np.isfinite(res.get(k, np.nan))]
    bad += [k for k in EB_LEDGER
            if not np.isfinite(res["ledger"].get(k, np.nan))]
    check(not bad and len(res["e2e_passes"]) == tool.PASSES
          and all(np.isfinite(res["e2e_passes"])),
          f"eval breakdown: keys missing or not finite {bad}: {res}")
    led = res["ledger"]
    parts = sum(led[k] for k in EB_LEDGER[2:])
    check(abs(led["wall_ms_per_clip"] - parts) <= TOL_EB_LEDGER,
          f"eval breakdown: the ledger's terms sum to {parts}, the wall "
          f"{led['wall_ms_per_clip']}: {led}")
    calls = len(records) // tool.BATCH_CLIPS
    want = {k: calls * v for k, v in
            expected_flow_launches("farneback", 224, 224).items()}
    for launches in res["launches_per_pass"]:
        check(launches == want, f"eval breakdown: a pass launched "
                                f"{launches}, expected {want}")
    emit({"phase": "eval_breakdown", "seconds": time.perf_counter() - t0,
          "dataset_seconds": dataset_s, "clips": len(records),
          "batch_clips": tool.BATCH_CLIPS, "workers": tool.NUM_WORKERS,
          "launches_per_pass_want": want, **res, **CARD})
    tool.print_ledger(res, tool.NUM_WORKERS)
    return {k: sum(p[k] for p in res["launches_per_pass"]) for k in want}


# The one flow call of each roofline program that makes one: (algorithm,
# frame size).
ROOFLINE_FLOW = {"headline_64f": ("farneback", (224, 224)),
                 "farneback_seq_64p": ("farneback", (224, 224)),
                 "tvl1_64p_224": ("tvl1", (224, 224)),
                 "eval_batch_8clips": ("farneback", (224, 224)),
                 "sustained_1080p_b4x16": ("farneback", (224, 224)),
                 "tvl1_1080p_b4": ("tvl1", FULL_HD)}
# The count from the kernels' rounds against the plain versions' on the
# same pairs: a round may flip at the ε threshold on the order of the
# test's sum (ROADMAP's watch list), which moves the count by one image's
# (one band's) round of one warp, ~0.05 % (~0.3 % at 1080p) of it.
TOL_ROUNDS = 0.01


def roofline_phase(torch, np, dev):
    """Phase 22: ``tools/torch_roofline.py``'s nine programs on the card
    at the reference's sizes (1080p included), through the tool's
    ``roofline`` with the bfloat16 model from seed 0.  Every key of every
    row finite and every share at most 100 % (the tool raises before);
    each program's warm call, its launch counts set to 0 just before and
    read just after, launching ``expected_flow_launches`` for its flow
    calls and nothing else; ``tvl1_64p_224``'s operation count equal to
    the sum of ``scale_work`` (``scale_bound``'s count) over the 5
    ``tvl1_scale`` launches it made, for the rounds they reported: one
    count, read two ways; and the count of the same 64 pairs' rounds, and
    of the first 1080p pair's, through the plain versions within
    ``TOL_ROUNDS`` of the kernels'; each program's device-busy share
    from one call under torch.profiler.  Returns the warm calls' launches
    per kernel, summed."""
    from video_analytics_tpu_torch.config import TVL1Config
    from video_analytics_tpu_torch.flow.tvl1 import tvl1

    t0 = time.perf_counter()
    proto = ROOFLINE.Protocol()
    model = ROOFLINE.build_model(proto, dev)
    rows, extras = ROOFLINE.roofline(proto, dev, model,
                                     counters=flow_counters())
    check([r["name"] for r in rows] == list(ROOFLINE.NAMES),
          f"roofline programs {[r['name'] for r in rows]}")
    for r in rows:
        bad = [k for k, v in r.items() if k not in ("name", "count")
               and not np.isfinite(v)]
        check(not bad, f"roofline {r['name']}: not finite {bad}: {r}")
        over = [k for k in ("mfu_mxu_pct", "mfu_vpu_pct", "hbm_pct")
                if r[k] > 100.0]
        check(not over, f"roofline {r['name']}: over 100 % {over}: {r}")
        check(r["count"] == ("rounds" if r["name"].startswith("tvl1")
                             else "shapes"), f"roofline count {r}")
    total = {}
    for name, launches in extras["launches"].items():
        want = dict.fromkeys(launches, 0)
        if name in ROOFLINE_FLOW:
            algo, (h, w) = ROOFLINE_FLOW[name]
            want.update(expected_flow_launches(algo, h, w))
        check(launches == want, f"roofline {name} launched {launches}, "
                                f"expected {want}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    # One count, read two ways: the program's, and scale_work by launch.
    cfg = TVL1Config()
    name = "tvl1_64p_224"
    levels = extras["rounds"][name]
    check(len(levels) == extras["launches"][name]["tvl1_scale"]
          and all(lv.solver == "warp" for lv in levels),
          f"{name}: levels {[(lv.hw, lv.solver) for lv in levels]}")
    by_launch = sum((ROOFLINE.scale_work(lv.rounds.tolist(), *lv.hw,
                                         cfg.inner_iterations,
                                         cfg.median_filtering)
                     for lv in levels), ROOFLINE.Work())
    program = extras["work"][name]
    check(by_launch == program, f"{name}: the launches' scale_work "
                                f"{by_launch}, the program's {program}")
    # The kernels' rounds against the plain versions' on the same pairs:
    # the 64 at 224² (tvl1_scale) and the first at 1080p (K-G's bands).
    rounds = {}
    for name, pairs in (("tvl1_64p_224", None), ("tvl1_1080p_b4", 1)):
        args = [a[:pairs] for a in extras["args"][name]]
        kern = ROOFLINE.tvl1_work(ROOFLINE.rounds_of(
            lambda a, b: tvl1(a, b, cfg), args), cfg)
        plain = ROOFLINE.tvl1_work(ROOFLINE.rounds_of(
            lambda a, b: tvl1(a, b, cfg, plain=True), args), cfg)
        rel = abs(kern.f32 - plain.f32) / plain.f32
        check(rel <= TOL_ROUNDS, f"{name}: the kernels' count {kern.f32}, "
                                 f"the plain versions' {plain.f32}")
        rounds[name] = {"pairs": args[0].shape[0], "kernels_gflop":
                        kern.f32 / 1e9, "plain_gflop": plain.f32 / 1e9,
                        "rel": rel}
    # Where each program's time goes: one call under torch.profiler, its
    # device-busy union against the row's ms a call.
    busy = {}
    with torch.no_grad():
        for r in rows:
            fn, args = extras["fn"][r["name"]], extras["args"][r["name"]]
            prof, _ = device_profile_until(
                torch, lambda: ROOFLINE.fence([fn(*args)]),
                lambda p: p["device_events"] > 0)
            busy[r["name"]] = {
                "busy_share_of_ms": prof["device_busy_ms"] / r["ms"],
                **{k: prof[k] for k in (
                    "profiled_wall_ms", "device_busy_ms", "device_sum_ms",
                    "device_events")},
                "top_device_ms": prof["top_device_ms"][:4]}
    budget = {k: w.flops for k, w in extras["budget"].items()}
    emit({"phase": "roofline", "seconds": time.perf_counter() - t0,
          "rows": rows, "peaks": ROOFLINE.peaks(),
          "tvl1_rounds_of_budget": {
              k: extras["work"][k].flops / v for k, v in budget.items()},
          "rounds_kernels_against_plain": rounds,
          "tvl1_64p_224_rounds_by_level": {
              f"{lv.hw[0]}x{lv.hw[1]}": int(lv.rounds.sum())
              for lv in levels},
          "launches_per_program": extras["launches"],
          "profile_per_program": busy, **CARD})
    ROOFLINE.print_table(rows)
    return total


# R(2+1)D-34's largest activation: stage 1's 144 midplanes over 16 clips
# of 32 × 56² (the benchmark's batch), bfloat16.
BN_STAGE1 = (16, 144, 32, 56, 56)
# (launches, with a residual) of the fused norm pass in one eval forward
# of a stream: every BatchNorm, and those that end a block.
BN_LAUNCHES = {"r2plus1d_34": (69, 16), "resnet18": (20, 8)}
# The full-width stream forwards of phase 23: (arch, dtype, input), 16
# clips of 32 × 112² or 16 images of 224², seed-0 weights, 101 classes.
BN_STREAMS = (("r2plus1d_34", "bfloat16", (16, 32, 112, 112, 3)),
              ("resnet18", "bfloat16", (16, 224, 224, 3)),
              ("resnet18", "float32", (16, 224, 224, 3)))
# Each norm site of those forwards against the module path it replaces
# (eval BatchNorm, ATen's add and ReLU) on the same input, per element in
# ulps of the dtype (its mantissa bits, for the ulp) of the largest of the
# operands (x's normalised value, bias, residual) and the two results.
# bfloat16: the two float32 affine values differ by a few float32 ulps
# (ATen fuses a multiply-add and takes rsqrtf), so their bfloat16
# roundings are equal or neighbours (1 ulp); a residual add rounds again
# after adding that difference (1 + 2 ulps).  float32: those few ulps,
# with room.
BN_SITE_ULPS = {"bfloat16": {"bits": 8, "norm": 1, "residual": 3},
                "float32": {"bits": 24, "norm": 16, "residual": 16}}
# The stream's logits with the fused norm pass against the module path, as
# a share of the largest: bfloat16 the card-against-CPU bound of phase 18
# (its streams differ in more roundings than these); float32 a hundred
# times the float32 differences of 20 sites, with TF32 off.
TOL_BN_LOGITS = {"bfloat16": TOL_BF16_LOGITS, "float32": 1e-4}


def norm_site_ulps(torch, norm, x, residual, got, want, bits: int):
    """The largest distance between `got` (the fused norm pass) and `want`
    (the module path) on input `x`, in ulps (`bits` of mantissa) of the
    largest of each element's operands and results, and the share of
    elements equal."""
    per = (1, -1) + (1,) * (x.dim() - 2)
    largest = ((x.float() - norm.running_mean.view(per))
               * torch.rsqrt(norm.running_var + norm.eps).view(per)
               * norm.weight.view(per)).abs_()
    largest = torch.maximum(largest, norm.bias.view(per).abs())
    if residual is not None:
        largest = torch.maximum(largest, residual.float().abs())
    largest = torch.maximum(largest, torch.maximum(got.float().abs(),
                                                   want.float().abs()))
    ulp = torch.ldexp(torch.ones_like(largest),
                      torch.frexp(largest)[1] - bits)
    diff = (got.float() - want.float()).abs_()
    return (float((diff / ulp).max()),
            1 - int((diff != 0).sum()) / diff.numel())


def bn_act_phase(torch, np, dev):
    """Phase 23: the fused norm pass at ``BN_STAGE1``, with and without a
    residual (ReLU on): bit for bit against ``bn_act_plain`` (its largest
    absolute difference measured); its time paced by the host
    (``cuda_ms``, in place over one activation), its device time, its
    plain version's, the module path's (``nn.BatchNorm3d`` then ATen's
    add and ReLU) and its byte bound.  Then the ``BN_STREAMS`` forwards
    with every ``norm_act`` call held to the module path on its own input
    (``BN_SITE_ULPS``), their counters to ``BN_LAUNCHES``, and their
    logits to the same forward on the module path (``TOL_BN_LOGITS``).
    Returns (the two kernel rows, the launches of each forward)."""
    import torch.nn as nn

    from video_analytics_tpu_torch.models import resnet, video_resnet
    from video_analytics_tpu_torch.ops.cuda.bn_act import (
        bn_act, bn_act_plain)

    t0 = time.perf_counter()
    g = torch.Generator(dev).manual_seed(23)
    C = BN_STAGE1[1]

    def act():
        return (3 * torch.randn(BN_STAGE1, device=dev, generator=g)).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last_3d)

    x, r = act(), act()
    y = torch.empty_like(x)
    norm = nn.BatchNorm3d(C).to(dev).eval()
    with torch.no_grad():
        norm.running_mean.uniform_(-1, 1, generator=g)
        norm.running_var.uniform_(0.5, 2, generator=g)
        norm.weight.uniform_(-1.5, 1.5, generator=g)
        norm.bias.uniform_(-1, 1, generator=g)
    params = (norm.running_mean, norm.running_var, norm.weight, norm.bias,
              norm.eps)
    rows = {}
    with torch.no_grad():
        for name, res in (("bn_act", None), ("bn_act_residual", r)):
            want = bn_act_plain(x, *params, res, True)
            got = bn_act(y.copy_(x), *params, res, True)
            err = float((got.float() - want.float()).abs().max())
            check(err == 0.0 and torch.equal(got, want),
                  f"{name} at {BN_STAGE1} is not bit-exact ({err})")
            del want, got

            def kernel():
                bn_act(y, *params, res, True)

            def module():
                z = norm(x)
                return torch.relu(z if res is None else z + res)

            y.copy_(x)
            nbytes = (x.numel() * x.element_size() * (3 if res is not None
                                                      else 2)
                      + 4 * C * 4)
            rows[name] = {
                "max_abs_err": err,
                "ms": cuda_ms(torch, kernel),
                "device_ms": device_ms(torch, kernel, "bn_act_kernel"),
                "plain_ms": cuda_ms(
                    torch, lambda: bn_act_plain(x, *params, res, True), 5),
                "library_ms": cuda_ms(torch, module, 5),
                "bound_ms": 1e3 * nbytes / ROOFLINE.HBM_BYTES_PER_S,
                "bytes": nbytes}
            rows[name]["device_over_bound"] = (rows[name]["device_ms"]
                                               / rows[name]["bound_ms"])
    del x, r, y

    fused = resnet.norm_act
    check(video_resnet.norm_act is fused, "video_resnet's norm_act is not "
          "resnet's")

    def module_path(norm, y, residual=None, relu=True):
        y = norm(y)
        if residual is not None:
            y = y + residual
        return torch.relu(y) if relu else y

    def route(fn):
        resnet.norm_act = video_resnet.norm_act = fn

    streams, launches = {}, {}
    for arch, dtype_name, shape in BN_STREAMS:
        key = f"{arch}_{dtype_name}"
        ulps = BN_SITE_ULPS[dtype_name]
        make = resnet.resnet18 if arch == "resnet18" else \
            video_resnet.r2plus1d_34
        model = make(101, dtype=getattr(torch, dtype_name))
        model.init(torch.Generator().manual_seed(0))
        model = model.to(dev).eval()
        clips = torch.randn(shape, device=dev, generator=g)
        sites = []

        def checked(norm, y, residual=None, relu=True):
            x = y.clone()
            want = module_path(norm, x, residual, relu)
            got = fused(norm, y, residual, relu)
            worst, equal = norm_site_ulps(torch, norm, x, residual, got,
                                          want, ulps["bits"])
            sites.append({"channels": x.shape[1], "residual":
                          residual is not None, "ulps": worst,
                          "equal_share": equal})
            check(worst <= ulps["norm" if residual is None else "residual"],
                  f"{key}: a norm site of {tuple(x.shape)} is {worst} ulps "
                  f"from the module path")
            return got

        with torch.no_grad():
            model(clips)                # cuDNN's first calls at the shapes
            n, nr = bn_act.launches, bn_act.launches_residual
            try:
                route(checked)
                got = model(clips).float()
                counts = (bn_act.launches - n,
                          bn_act.launches_residual - nr)
                route(module_path)
                want = model(clips).float()
            finally:
                route(fused)
            torch.cuda.synchronize()
        launches[key] = counts
        check(counts == BN_LAUNCHES[arch] and len(sites) == counts[0]
              and bn_act.launches - n == counts[0],
              f"{key}: bn_act launches {counts} over {len(sites)} sites "
              f"({bn_act.launches - n} with the module path), expected "
              f"{BN_LAUNCHES[arch]}")
        scale = float(want.abs().max())
        rel = float((got - want).abs().max()) / scale
        check(scale > 0 and rel <= TOL_BN_LOGITS[dtype_name],
              f"{key}: logits {rel} of the largest from the module path")
        streams[key] = {
            "input": list(shape), "launches": counts[0],
            "launches_residual": counts[1],
            "logits_rel_vs_module_path": rel,
            "site_ulps_max": max(s["ulps"] for s in sites),
            "site_ulps_max_residual": max(
                (s["ulps"] for s in sites if s["residual"]), default=None),
            "site_equal_share_min": min(s["equal_share"] for s in sites)}
        del model, clips, got, want
    emit({"phase": "bn_act", "seconds": time.perf_counter() - t0,
          "shape": list(BN_STAGE1), "dtype": "bfloat16", "rows": rows,
          "streams": streams,
          "tolerances": {"site_ulps": BN_SITE_ULPS,
                         "logits_rel": TOL_BN_LOGITS},
          "counters": {"bn_act.launches": bn_act.launches,
                       "bn_act.launches_residual":
                           bn_act.launches_residual}, **CARD})
    return rows, launches


# A stream's bfloat16 logits against the float32 reference, as a share of
# the largest: the CPU tests' bound (tests/test_torch_timesformer.py,
# ``BF16_REL``), whose small network reads 0.8 %.
TOL_TSF_LOGITS = 0.03
SDPA_MARKS = ("sdpa", "flash", "fmha", "attention", "attn", "softmax")


def sdpa_like(name: str) -> bool:
    return any(m in name.lower() for m in SDPA_MARKS)


def call_kernels(torch, fn, tries: int = 5) -> list:
    """The device kernels of one call of `fn` (after a warm call), with
    their device ms, longest first; the call profiled again, a little
    later each time, while torch.profiler records no kernel (at most
    `tries` times: ``device_profile_until``'s rule).  Empty where no
    session recorded one."""
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad():
        fn()
        torch.cuda.synchronize()
        for i in range(tries):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            out = {}
            for e in prof.events():
                if e.device_type == torch.autograd.DeviceType.CUDA:
                    out[e.name] = (out.get(e.name, 0.0)
                                   + e.device_time_total / 1e3)
            if out:
                return sorted(out.items(), key=lambda kv: -kv[1])
            PROFILER["retaken_sessions"] += 1
            time.sleep(0.2 * (i + 1))
    return []


def short_attn_row(torch, dev, g, seqs: int, T: int, D: int, heads: int):
    """The short-sequence kernel at the time half's shape: within one
    bfloat16 ulp of the float64 attention (the card tests' rule), its
    largest difference from its plain version and SDPA's from the float64
    attention; its paced and device ms beside its byte bound (the product
    read and the output written once, the float32 bias), its plain
    version's, SDPA's alone on the biased q, k, v (``library_ms``) and
    the path it replaced (the bias add, SDPA, the output's reshape)."""
    import torch.nn.functional as F

    from video_analytics_tpu_torch.ops.cuda.short_attn import (
        short_attn, short_attn_plain)

    W = 3 * D
    y = torch.randn((seqs, T, W), device=dev, generator=g).to(torch.bfloat16)
    bias = 0.3 * torch.randn(W, device=dev, generator=g)
    with torch.no_grad():
        got = short_attn(y, bias, heads)
        plain = short_attn_plain(y, bias, heads)
        qkv = y + bias.to(torch.bfloat16)
        q, k, v = qkv.view(seqs, T, 3, heads, D // heads).permute(
            2, 0, 3, 1, 4).unbind(0)
        w = torch.softmax(q.double() @ k.double().transpose(-1, -2)
                          * (D // heads) ** -0.5, -1)
        want = (w @ v.double()).transpose(1, 2).reshape(seqs, T, D)
        terms = (w @ v.double().abs()).transpose(1, 2).reshape(seqs, T, D)
        sdpa = F.scaled_dot_product_attention(q, k, v).transpose(
            1, 2).reshape(seqs, T, D)
    at = torch.maximum(want.abs(), terms * 2.0 ** -12)
    ulp = torch.ldexp(torch.ones_like(at), torch.frexp(at)[1] - 8)
    err = (got.double() - want).abs()
    kernel_err = float(err.max())
    sdpa_err = float((sdpa.double() - want).abs().max())
    check(bool((err <= ulp).all()) and kernel_err <= sdpa_err,
          f"short_attn at {(seqs, T, D)}: {kernel_err} from the float64 "
          f"attention (SDPA {sdpa_err})")
    del w, want, terms, at, ulp, err

    def replaced():
        qkv = y + bias.to(torch.bfloat16)
        q, k, v = qkv.view(seqs, T, 3, heads, D // heads).permute(
            2, 0, 3, 1, 4).unbind(0)
        o = F.scaled_dot_product_attention(q, k, v)
        return o.transpose(1, 2).reshape(seqs, T, D)

    nbytes = (y.numel() + seqs * T * D) * 2 + W * 4
    with torch.no_grad():
        row = {"shape": [seqs, T, D, heads],
               "max_abs_err_vs_float64": kernel_err,
               "max_abs_diff_vs_plain": float(
                   (got.float() - plain.float()).abs().max()),
               "sdpa_max_abs_err_vs_float64": sdpa_err,
               "ms": cuda_ms(torch, lambda: short_attn(y, bias, heads)),
               "device_ms": device_ms(
                   torch, lambda: short_attn(y, bias, heads),
                   "short_mha_kernel"),
               "plain_ms": cuda_ms(
                   torch, lambda: short_attn_plain(y, bias, heads), 5),
               "library_ms": cuda_ms(
                   torch, lambda: F.scaled_dot_product_attention(q, k, v)),
               "replaced_path_ms": cuda_ms(torch, replaced),
               "bound_ms": 1e3 * nbytes / ROOFLINE.HBM_BYTES_PER_S,
               "bytes": nbytes}
    row["device_over_bound"] = row["device_ms"] / row["bound_ms"]
    return row


def timesformer_phase(torch, np, dev):
    """Phase 24: both full-width TimeSformer-Base streams in bfloat16 on
    one clip (RGB frames, and flow fields in [-1, 1]) against the float32
    plain reference on the card, with the attention calls and the
    short-sequence kernel's launches (``short_attn.launches``: the time
    half, 12 a stream); the kernel's row at a batch's time-half shape (16
    clips); the kernels each half launches there."""
    import importlib.util

    from video_analytics_tpu_torch.models.timesformer import TimeSformer
    from video_analytics_tpu_torch.models.two_stream import TwoStreamModel
    from video_analytics_tpu_torch.ops.cuda.short_attn import short_attn

    # By path: an installed package named ``tests`` may shadow the repo's.
    spec = importlib.util.spec_from_file_location(
        "torch_timesformer", os.path.join(HERE, "tests",
                                          "torch_timesformer.py"))
    plain = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(plain)
    t0 = time.perf_counter()
    model = TwoStreamModel.create(arch="timesformer_base",
                                  dtype=torch.bfloat16)
    model.init(torch.Generator().manual_seed(0))
    model = model.to(dev).eval()
    g = torch.Generator(dev).manual_seed(24)
    clips = {"spatial": torch.randn((1, 8, 224, 224, 3), device=dev,
                                    generator=g),
             "temporal": 2 * torch.rand((1, 8, 224, 224, 2), device=dev,
                                        generator=g) - 1}
    streams = {}
    for name, x in clips.items():
        net = getattr(model, name)
        before = dict(TimeSformer.attn_calls)
        n = short_attn.launches
        with torch.no_grad():
            got = net(x).float()
        calls = {k: v - before[k] for k, v in TimeSformer.attn_calls.items()}
        launches = short_attn.launches - n
        want = plain.TimeSformer(net.state_dict(), heads=net.heads)(x)
        scale = float(want.abs().max())
        rel = float((got - want).abs().max()) / scale
        check(calls == {"time": 12, "space": 12} and launches == 12,
              f"timesformer {name}: attention calls {calls}, short_attn "
              f"launches {launches}")
        check(scale > 0 and rel <= TOL_TSF_LOGITS,
              f"timesformer {name}: logits {rel} of the largest from the "
              f"float32 reference")
        streams[name] = {"logits_rel_vs_reference": rel,
                         "logit_sd": float(want.std()),
                         "attn_calls": calls,
                         "short_attn_launches": launches}
    blk, D = model.spatial.blocks[0], model.spatial.width
    B, T, P = 16, 8, model.spatial.num_patches
    time_row = short_attn_row(torch, dev, g, B * P, T, D, blk.attn.heads)
    h = torch.randn((B * P, T, D), device=dev, generator=g).to(
        torch.bfloat16)
    s = torch.randn((B * T, P + 1, D), device=dev, generator=g).to(
        torch.bfloat16)
    n = short_attn.launches
    halves = {"time": call_kernels(torch, lambda: blk.temporal_attn(h))}
    time_launches = short_attn.launches - n
    halves["space"] = call_kernels(torch, lambda: blk.attn(s))
    check(time_launches >= 2 and short_attn.launches - n == time_launches,
          f"timesformer: the time half launched short_attn "
          f"{time_launches} times, the space half "
          f"{short_attn.launches - n - time_launches}")
    sdpa = {half: [kv for kv in ks if sdpa_like(kv[0])]
            for half, ks in halves.items()}
    ours = {half: [kv for kv in ks if "short_mha_kernel" in kv[0]]
            for half, ks in halves.items()}
    if all(halves.values()):
        check(len(ours["time"]) == 1 and not sdpa["time"] and sdpa["space"]
              and not ours["space"],
              f"timesformer: the time half launched {halves['time']}, the "
              f"space half {halves['space']}")
    else:
        print("torch.profiler recorded no kernel of a TimeSformer half: "
              "its launches are held by the counter alone",
              file=sys.stderr, flush=True)
        PROFILER["kernel_names_unrecorded"].append("timesformer halves")
    emit({"phase": "timesformer", "seconds": time.perf_counter() - t0,
          "streams": streams, "tolerance": TOL_TSF_LOGITS,
          "short_attn": time_row,
          "half_kernels_ms": {half: [(short_kernel_name(k), ms)
                                     for k, ms in ks]
                              for half, ks in halves.items()},
          "sdpa_kernels_ms": sdpa,
          "shapes": {"time": [B * P, 12, T, D // 12],
                     "space": [B * T, 12, P + 1, D // 12]},
          "attn_calls_total": dict(TimeSformer.attn_calls),
          "short_attn_launches_total": short_attn.launches, **CARD})
    del model, clips, h, s
    torch.cuda.empty_cache()
    return streams, sdpa


def native_phases(torch, np, dev, chain: bool = True):
    """The native-resolution flow command and, with `chain`, the stage
    commands that read what it wrote, in one temporary directory.  Returns
    the flow command's launches per kernel."""
    import tempfile

    with tempfile.TemporaryDirectory() as work:
        launches, frames_dir, flow_dir = tvl1_1080p_phase(torch, np, dev,
                                                          work)
        if chain:
            stage_chain_phase(torch, np, dev, work, frames_dir, flow_dir)
    return launches


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def main(argv=None) -> int:
    import argparse

    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default=None,
                    choices=["tvl1_warp_kernel", "farneback_kernels",
                             "farneback_1080p", "tvl1_midsize",
                             "tvl1_chunk_kernels", "tvl1_1080p",
                             "stage_chain", "eval_ucf101", "train",
                             "spynet", "distributed", "model_axis", "warmup",
                             "sustained", "async_checkpoint", "bf16",
                             "compute_flow_bucketed", "flow_quality",
                             "eval_breakdown", "roofline", "bn_act",
                             "timesformer"],
                    help="run the build and this phase alone (stage_chain "
                         "with tvl1_1080p, whose directories it reads; "
                         "model_axis is the last part of distributed), for "
                         "work on it; prints no result line")
    ap.add_argument("--sweep-chunk", action="store_true",
                    help="with the tvl1_chunk_kernels phase: also time one "
                         "1080x1920 warp at several iterations per launch")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    if not os.path.isdir(os.path.join(HERE, "video_analytics_tpu_torch")):
        raise SystemExit("chip_smoke: video_analytics_tpu_torch/ is not "
                         "beside this script; run it from the repo")
    sys.path.insert(0, HERE)

    from video_analytics_tpu_torch.config import PipelineConfig, TVL1Config
    from video_analytics_tpu_torch.flow.tvl1 import tvl1
    from video_analytics_tpu_torch.models.two_stream import TwoStreamModel
    from video_analytics_tpu_torch.ops.cuda import _build
    from video_analytics_tpu_torch.ops.cuda import tvl1_solve as ts
    from video_analytics_tpu_torch.ops.cuda.warp import (
        warp_prep, warp_prep_plain)
    from video_analytics_tpu_torch.runtime.serve import ClipServer
    from video_analytics_tpu_torch.utils.device import require_cuda

    dev = require_cuda("cuda")
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    CARD["card"] = gpu
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": gpu, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    # -- 1. build -----------------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    ptxas = [ln.strip() for ln in _build.build_info.get("log", "").splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": _build.build_info.get("seconds"),
          "library": os.path.relpath(_build.build_info["path"], HERE),
          "ptxas": ptxas})

    if args.only == "tvl1_warp_kernel":
        tvl1_warp_kernel_phase(torch, np, dev)
    elif args.only == "farneback_kernels":
        farneback_kernels_phase(torch, np, dev)
    elif args.only == "farneback_1080p":
        farneback_1080p_phase(torch, np, dev)
    elif args.only == "tvl1_midsize":
        tvl1_midsize_phase(torch, np, dev)
    elif args.only == "tvl1_chunk_kernels":
        tvl1_chunk_kernels_phase(torch, np, dev, args.sweep_chunk)
    elif args.only == "eval_ucf101":
        eval_ucf101_phase(torch, np, dev)
    elif args.only == "train":
        train_phase(torch, np, dev)
    elif args.only == "spynet":
        spynet_phase(torch, np, dev)
    elif args.only == "distributed":
        distributed_phase(torch, np, dev)
    elif args.only == "model_axis":
        model_axis_phase(torch, np, dev)
    elif args.only == "warmup":
        warmup_phase(torch, np)
    elif args.only == "sustained":
        sustained_phase(torch, np, dev)
    elif args.only == "async_checkpoint":
        async_checkpoint_phase(torch, np, dev)
    elif args.only == "bf16":
        bf16_phase(torch, np, dev)
    elif args.only == "compute_flow_bucketed":
        compute_flow_bucketed_phase(torch, np, dev)
    elif args.only == "flow_quality":
        flow_quality_phase(torch, np, dev)
    elif args.only == "eval_breakdown":
        eval_breakdown_phase(torch, np, dev)
    elif args.only == "roofline":
        roofline_phase(torch, np, dev)
    elif args.only == "bn_act":
        bn_act_phase(torch, np, dev)
    elif args.only == "timesformer":
        timesformer_phase(torch, np, dev)
    elif args.only:
        native_phases(torch, np, dev, args.only == "stage_chain")
    if args.only:
        print(gpu, flush=True)
        return 0

    # -- 2. kernels against their plain versions ----------------------------
    cfg = TVL1Config()
    one_round = dataclasses.replace(cfg, outer_iterations=1)
    errs = {"warp_prep": 0.0, "tvl1_pd_step": 0.0, "median5": 0.0,
            "tvl1_pd_step_eps": 0.0}
    times = {}
    for size in SIZES:
        i0, i13, uv = tvl1_level_inputs(torch, np, dev, size, size, PAIRS)

        prep = warp_prep(i13, i0, uv)
        prep_ref = warp_prep_plain(i13, i0, uv)
        e = (prep - prep_ref).abs().max().item()
        check(e <= TOL_WARP, f"warp_prep at {size}: max abs {e} > {TOL_WARP}")
        errs["warp_prep"] = max(errs["warp_prep"], e)

        active = torch.tensor([b % 2 for b in range(PAIRS)],
                              dtype=torch.int32, device=dev)
        noisy = uv + torch.randn(uv.shape, device=dev,
                                 generator=torch.Generator(dev).manual_seed(
                                     size))
        for k in (3, 5):
            for mask in (None, active):
                got = ts.median5(noisy, k, mask)
                want = ts.median5_plain(noisy, k, mask)
                check(torch.equal(got, want),
                      f"median5 k={k} at {size} is not bit-exact")

        got = ts.pd_solve(prep_ref, uv, one_round)
        want = ts.pd_solve_plain(prep_ref, uv, one_round)
        e = (got - want).abs().max().item()
        check(e <= TOL_ROUND,
              f"one outer round at {size}: max abs {e} > {TOL_ROUND}")
        errs["tvl1_pd_step"] = max(errs["tvl1_pd_step"], e)

        errs["tvl1_pd_step_eps"] = max(errs["tvl1_pd_step_eps"],
                                       eps_test_check(torch, ts, prep_ref, uv,
                                                      cfg, size == SIZES[0]))

        p = torch.zeros((PAIRS, 4, size, size), device=dev)
        uv_out, p_out = torch.empty_like(uv), torch.empty_like(p)
        on = torch.ones(PAIRS, dtype=torch.int32, device=dev)
        # A round's last step with the ε test, timed at ε = 0 (no flag
        # clears), beside the same step and the test's plain versions.
        never = dataclasses.replace(cfg, epsilon=0.0)
        partial = torch.empty((PAIRS, ts.pd_blocks(size, size)), device=dev)
        count = torch.zeros(PAIRS, dtype=torch.int32, device=dev)
        errv = torch.full((PAIRS,), float("inf"), device=dev)

        def step_eps():
            ts.pd_step(prep, uv, p, on, never, uv_out, p_out, partial, count,
                       errv)

        def step_eps_plain():
            ts.eps_reduce_plain(
                ts.pd_step_plain(prep, uv, p, never, True)[2][:, None]
                * (size * size), on.clone(), errv.clone(), size * size, 0.0)

        times[size] = {
            "warp_prep": (
                cuda_ms(torch, lambda: warp_prep(i13, i0, uv)),
                cuda_ms(torch, lambda: warp_prep_plain(i13, i0, uv))),
            "median5": (
                cuda_ms(torch, lambda: ts.median5(uv, 5, on, out=uv_out)),
                cuda_ms(torch, lambda: ts.median5_plain(uv, 5, on))),
            "tvl1_pd_step": (
                cuda_ms(torch, lambda: ts.pd_step(prep, uv, p, on, cfg,
                                                  uv_out, p_out)),
                cuda_ms(torch, lambda: ts.pd_step_plain(prep, uv, p, cfg))),
            "tvl1_pd_step_eps": (cuda_ms(torch, step_eps),
                                 cuda_ms(torch, step_eps_plain))}
        if size == SIZES[0]:
            times[size]["pd_solve_one_warp"] = (
                cuda_ms(torch, lambda: ts.pd_solve(prep, uv, cfg), 3),
                cuda_ms(torch, lambda: ts.pd_solve_plain(prep, uv, cfg), 3))
            dev_times = {
                "warp_prep": device_ms(
                    torch, lambda: warp_prep(i13, i0, uv),
                    "warp_prep_kernel"),
                "median5": device_ms(
                    torch, lambda: ts.median5(uv, 5, on, out=uv_out),
                    "median_kernel"),
                "tvl1_pd_step": device_ms(
                    torch, lambda: ts.pd_step(prep, uv, p, on, cfg, uv_out,
                                              p_out), "pd_step_kernel"),
                "tvl1_pd_step_eps": device_ms(torch, step_eps,
                                              "pd_step_kernel")}
    emit({"phase": "kernels", "sizes": list(SIZES), "pairs": PAIRS,
          "max_abs_err": errs, "median5_bit_exact": True,
          "ms_kernel_vs_plain": times,
          f"device_ms_at_{SIZES[0]}": dev_times})

    kh = tvl1_warp_kernel_phase(torch, np, dev)

    # Per-image ε stop: an easy pair's flow must not depend on its batch.
    size = SIZES[0]
    easy = (scene(np, 0, size, size, 99, vel=(0.3, 0.1)),
            scene(np, 1, size, size, 99, vel=(0.3, 0.1)))
    hard = (scene(np, 0, size, size, 98, vel=(3.5, -2.4)),
            scene(np, 1, size, size, 98, vel=(3.5, -2.4)))
    prev = torch.from_numpy(np.stack([easy[0], hard[0]])).to(dev)
    nxt = torch.from_numpy(np.stack([easy[1], hard[1]])).to(dev)
    both = tvl1(prev, nxt, cfg)
    alone = tvl1(prev[:1], nxt[:1], cfg)
    hard_alone = tvl1(prev[1:], nxt[1:], cfg)
    check(torch.equal(both[0], alone[0]),
          "easy pair's flow changed when batched with a hard pair")
    check(torch.equal(both[1], hard_alone[0]),
          "hard pair's flow changed when batched with an easy pair")
    mean_easy = alone[0, 16:-16, 16:-16].reshape(-1, 2).mean(0).tolist()
    mean_hard = hard_alone[0, 16:-16, 16:-16].reshape(-1, 2).mean(0).tolist()
    check(abs(mean_easy[0] - 0.3) < 0.1 and abs(mean_easy[1] - 0.1) < 0.1,
          f"easy pair's mean flow {mean_easy}, expected (0.3, 0.1)")
    emit({"phase": "gating", "easy_equal_alone": True,
          "hard_equal_alone": True, "easy_mean_flow": mean_easy,
          "hard_mean_flow": mean_hard})

    # -- 3. serving at full width --------------------------------------------
    frames = np.stack([np.stack([scene(np, t, 256, 256, seed=c)
                                 for c in range(3)], axis=-1)
                       for t in range(16)]).round().astype(np.uint8)
    pcfg = PipelineConfig()
    model = TwoStreamModel.create(num_classes=pcfg.num_classes,
                                  flow_stack=pcfg.preprocess.flow_stack,
                                  width=64)
    model.init(torch.Generator().manual_seed(0))
    server = ClipServer(model, pcfg, dev)
    warm_s = server.warmup()
    pong = server.handle_request({"cmd": "ping", "id": 1})
    check(pong.get("ok") is True and pong.get("id") == 1, f"ping: {pong}")

    # Every level of a 224² crop fits a cluster: per request and level one
    # launch of tvl1_scale (its 5 warps and the scale-end median inside);
    # K-A, K-C and the per-iteration kernels not at all.  The request's
    # one classify call runs each BatchNorm of both CNNs as the fused
    # norm pass (BN_PER_CLASSIFY).
    kernels = {"tvl1_scale": ts.pd_solve_scale, "warp_prep": warp_prep,
               "median5": ts.median5, "tvl1_pd_step": ts.pd_step,
               "tvl1_pd_step_eps": TestLaunches(ts.pd_step),
               **norm_kernels()}
    request_ms, outs, launches = serve_requests(
        server, frames, lambda: zero_counts(kernels),
        lambda: read_counts(kernels),
        {**dict.fromkeys(kernels, 0), "tvl1_scale": len(SIZES),
         **norm_expected(1)})
    probs = outs[0]
    e = check_probs(torch, np, server, frames, probs)
    emit({"phase": "serve", "warmup_s": warm_s, "request_ms": request_ms,
          "launches_per_request": {k: v // SERVE_REQUESTS
                                   for k, v in launches.items()},
          "top1": int(probs.argmax()),
          "probs_max_abs_vs_plain": e,
          "repeat_max_abs": max(float(np.abs(o - probs).max())
                                for o in outs)})

    # -- 4. profile ---------------------------------------------------------
    emit({"phase": "profile",
          **profile_request(torch, np, server, frames, request_ms)})

    # -- 5-7. the Farneback path ----------------------------------------------
    from video_analytics_tpu_torch.ops.cuda import farneback as fk
    zero_fb_counts(fk)
    fb_errs, fb_times, fb_bounds, fb_dev = farneback_kernels_phase(
        torch, np, dev)
    own_check = read_fb_counts(fk)
    fb_launches = farneback_serve_phase(torch, np, dev, model)
    cf_launches = compute_flow_phase(np)
    fhd_launches, fhd = farneback_1080p_phase(torch, np, dev)

    # -- 8-10. native-resolution TV-L1 and the stage chain -------------------
    kg = tvl1_chunk_kernels_phase(torch, np, dev, args.sweep_chunk)
    mid_launches, chain_launches = tvl1_midsize_phase(torch, np, dev)
    # K-B, with and without the ε test, is on no command's path since the
    # levels between take 16-block clusters: its launches are those of the
    # level that fits no cluster.
    own_check.update({name: chain_launches[name]
                      for name in ("tvl1_pd_step", "tvl1_pd_step_eps")})
    hd_launches = native_phases(torch, np, dev)

    # -- 11. eval-ucf101 ----------------------------------------------------
    eval_launches = eval_ucf101_phase(torch, np, dev)

    # -- 12. train ----------------------------------------------------------
    train_launches = train_phase(torch, np, dev)

    # -- 13. SpyNet: no port kernel on its path ------------------------------
    spynet_phase(torch, np, dev)

    # -- 14-15. processes and collectives (the model axis too); warmup -------
    dist_launches = distributed_phase(torch, np, dev)
    warmup_launches = warmup_phase(torch, np)

    # -- 16-17. the sustained 1080p stream; asynchronous checkpoints --------
    sustained_launches = sustained_phase(torch, np, dev)
    async_launches = async_checkpoint_phase(torch, np, dev)

    # -- 18. the reference's bfloat16 CNN -------------------------------------
    bf16_launches = bf16_phase(torch, np, dev)

    # -- 19-20. compute-flow's bucket ladder; the flow-quality shoot-out ------
    bucket_launches = compute_flow_bucketed_phase(torch, np, dev)
    fq_launches = flow_quality_phase(torch, np, dev)

    # -- 21. the split of batched evaluation's clips/s ------------------------
    eb_launches = eval_breakdown_phase(torch, np, dev)

    # -- 22. the roofline of the hot programs ---------------------------------
    rl_launches = roofline_phase(torch, np, dev)

    # -- 23. the fused norm pass of the CNNs' eval forward --------------------
    bn_rows, bn_launches = bn_act_phase(torch, np, dev)

    # -- 24. the TimeSformer streams against their reference --------------
    timesformer_phase(torch, np, dev)

    # -- the kernel table -----------------------------------------------------
    # TV-L1 bounds at 224², 15 pairs.  Planes moved: warp_prep reads I1 and
    # its gradients, I0 and the flow and writes 4; pd_step reads prep, the
    # flow and the dual (10) and writes 6; median5 reads and writes u, v;
    # a round's last pd_step also writes and reads back the per-block sums
    # and reads and writes the flags and errors.  Operations per pixel: 3
    # bilinear samples and the prep (~45); one primal-dual step (~70); the
    # min/max of K-C's generated tile schedule per plane (median_ops).
    # tvl1_scale's are those of the rounds its images took (scale_bound).
    # Launches are those of the serve
    # requests where the serve path runs the kernel; tvl1_scale's also on
    # the mid-size commands' path (launches_tvl1_midsize); K-A, K-C, K-G and
    # its launches with the bands' test on the 1080p TV-L1 command's; K-D's
    # blur pass on the 1080p Farneback command's (--fb-levels 4), K-E and
    # sep_corr on its --fb-winsize 201 command's; K-B (with and without
    # the ε test) and fb_window_solve are on no command's path (tvl1_scale
    # and fb_iteration hold their arithmetic; K-B takes only a level too
    # wide for a cluster; fb_window_solve only windows of 75-193 taps):
    # their launches are 0, and check_launches counts those of the phase
    # that holds them against their plain versions.
    px = PAIRS * SIZES[0] * SIZES[0]
    blocks = ts.pd_blocks(SIZES[0], SIZES[0])
    bounds = {"warp_prep": bound(10 * 4 * px, ROOFLINE.TVL1_WARP_OPS * px),
              "tvl1_pd_step": bound(16 * 4 * px, ROOFLINE.TVL1_PD_OPS * px),
              "median5": bound(4 * 4 * px, 2 * median_ops(5) * px),
              "tvl1_pd_step_eps": bound(
                  16 * 4 * px + 8 * PAIRS * blocks + 12 * PAIRS,
                  ROOFLINE.TVL1_PD_OPS * px + PAIRS * blocks),
              **fb_bounds,
              **{name: v[2] for name, v in {**kh, **kg, **fhd}.items()}}
    errs.update(fb_errs)
    errs.update({name: v[0] for name, v in {**kh, **kg, **fhd}.items()})
    launches.update(fb_launches)
    launches_from = {name: "serve" for name, n in launches.items() if n > 0}
    for source, counts in (("tvl1_midsize", mid_launches),
                           ("tvl1_1080p", hd_launches),
                           ("farneback_1080p", fhd_launches)):
        for name, n in counts.items():
            if launches.get(name, 0) == 0 and n > 0:
                launches[name], launches_from[name] = n, source
    table_ms = {**{name: (*t, None) for name, t in times[SIZES[0]].items()},
                **fb_times,
                **{name: v[1] for name, v in {**kh, **kg, **fhd}.items()}}
    dev_times.update(fb_dev)
    dev_times.update({name: v[3] for name, v in {**kh, **kg, **fhd}.items()})
    src = "video_analytics_tpu_torch/csrc/"
    pallas = "video_analytics_tpu/ops/pallas/"
    fbk = pallas + "farneback_kernels.py:"
    rows = [("warp_prep", "warp_prep.cu", pallas + "warp.py:157",
             [pallas + "warp.py:130", pallas + "tvl1_solve.py:584"]),
            ("tvl1_pd_step", "tvl1_pd.cu", pallas + "tvl1_solve.py:191",
             [pallas + "tvl1_solve.py:415", pallas + "tvl1_solve.py:584"]),
            ("median5", "median.cu", pallas + "tvl1_solve.py:75",
             [pallas + "tvl1_solve.py:191", pallas + "tvl1_solve.py:584"]),
            ("tvl1_pd_step_eps", "tvl1_pd.cu", pallas + "tvl1_solve.py:191",
             [pallas + "tvl1_solve.py:165", pallas + "tvl1_solve.py:415"]),
            ("tvl1_scale", "tvl1_pd_warp.cu", pallas + "tvl1_solve.py:584",
             [pallas + "tvl1_solve.py:500", pallas + "tvl1_solve.py:191",
              pallas + "tvl1_solve.py:415"]),
            ("tvl1_pd_chunk", "tvl1_pd_chunk.cu", pallas + "tvl1_solve.py:890",
             [pallas + "tvl1_solve.py:720", pallas + "tvl1_solve.py:1001"]),
            ("tvl1_pd_chunk_flags", "tvl1_pd_chunk.cu",
             pallas + "tvl1_solve.py:890",
             [pallas + "tvl1_solve.py:1001", pallas + "tvl1_solve.py:1054"]),
            ("fb_prologue", "fb_prologue.cu", fbk + "1191", [fbk + "990"]),
            ("fb_prologue_blur", "fb_prologue.cu", fbk + "1191",
             [fbk + "990"]),
            ("fb_warp_neq", "fb_warp_neq.cu", fbk + "471",
             [fbk + "263", fbk + "697", fbk + "772", fbk + "946",
              pallas + "warp.py:157", pallas + "warp.py:130"]),
            ("sep_corr", "sep_corr.cu", fbk + "139",
             [fbk + "263", fbk + "471", fbk + "946"]),
            ("sep_corr_x_solve", "sep_corr.cu", fbk + "697",
             [fbk + "139", fbk + "574", fbk + "946"]),
            ("fb_window_solve", "fb_window_solve.cu", fbk + "574",
             [fbk + "263", fbk + "471", fbk + "697", fbk + "946"]),
            ("fb_iteration", "fb_window_solve.cu", fbk + "946",
             [fbk + "826"])]
    off_path = ("tvl1_pd_step", "tvl1_pd_step_eps", "fb_window_solve")
    for name, *_ in rows:
        if name in off_path:
            check(launches.get(name, 0) == 0 and own_check[name] > 0,
                  f"kernel {name}: {launches.get(name)} launches on a path, "
                  f"{own_check[name]} against its plain version")
            launches[name] = 0
        else:
            check(launches.get(name, 0) > 0,
                  f"kernel {name} was launched on no path")
    emit({"kernels": [{"name": name, "route": "cuda", "source": src + source,
                       "replaces": replaces, "replaces_also": also,
                       "launches": launches[name],
                       "launches_from": launches_from.get(name),
                       **({"check_launches": own_check[name]}
                          if name in off_path else {}),
                       "max_abs_err": errs[name],
                       "ms": table_ms[name][0],
                       "device_ms": dev_times[name],
                       "plain_ms": table_ms[name][1],
                       "bound_ms": bounds[name][0],
                       "bound_by": bounds[name][1],
                       "library_ms": table_ms[name][2],
                       **({"launches_compute_flow": cf_launches[name]}
                          if name in cf_launches else {}),
                       **({"launches_tvl1_1080p": hd_launches[name]}
                          if name in hd_launches else {}),
                       **({"launches_tvl1_midsize": mid_launches[name]}
                          if name in mid_launches else {}),
                       **({"launches_farneback_1080p": fhd_launches[name]}
                          if name in fhd_launches else {}),
                       "launches_eval_ucf101": eval_launches.get(name, 0),
                       "launches_train": train_launches.get(name, 0),
                       "launches_distributed": dist_launches.get(name, 0),
                       "launches_warmup": warmup_launches.get(name, 0),
                       "launches_sustained": sustained_launches.get(name, 0),
                       "launches_async_checkpoint":
                           async_launches.get(name, 0),
                       "launches_bf16": bf16_launches.get(name, 0),
                       "launches_compute_flow_bucketed":
                           bucket_launches.get(name, 0),
                       "launches_flow_quality": fq_launches.get(name, 0),
                       "launches_eval_breakdown": eb_launches.get(name, 0),
                       "launches_roofline": rl_launches.get(name, 0)}
                      for name, source, replaces, also in rows]
                     + [{"name": name, "route": "cuda",
                         "source": src + "bn_act.cu", "replaces": None,
                         "launches": launches[name],
                         "launches_from": launches_from.get(name),
                         **{key: row[key] for key in (
                             "max_abs_err", "ms", "device_ms", "plain_ms",
                             "bound_ms", "library_ms")},
                         "bound_by": "bytes",
                         "launches_eval_ucf101": eval_launches[name],
                         "launches_sustained": sustained_launches[name],
                         "launches_bf16": bf16_launches[name],
                         **{"launches_" + stream: n[k]
                            for stream, n in bn_launches.items()}}
                        for k, (name, row) in enumerate(bn_rows.items())]})
    emit({"phase": "profiler", **PROFILER})
    print(gpu, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
