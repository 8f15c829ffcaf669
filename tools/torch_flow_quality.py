"""Flow quality and throughput shoot-out of the PyTorch port: SpyNet, TV-L1
and Farneback on shared synthetic content with analytic ground truth, the
twin of tools/flow_quality.py (the same flags, families, end-point errors,
JSON keys and table), on the first CUDA device unless --device says
otherwise.

    python3 tools/torch_flow_quality.py [--spynet-checkpoint P]
    python3 tools/torch_flow_quality.py --hw 96 --batch 2 --device cpu

Per algorithm (SpyNet with --spynet-checkpoint or the bundled weights,
``TVL1Config()``, ``FarnebackConfig()``), on the same pairs:
  - EPE on pure-affine motion (global translation + linear term) and on
    moving-object motion (``local_blobs=2``), --val-batches batches each;
  - EPE on four families that SpyNet's training generator does not draw
    as such, max(1, --val-batches // 2) batches each: rotzoom (rotation
    and zoom, 12 px border cropped), squares (a textured square
    translating over another texture: occlusion), largedisp (8-16 px
    translations, 18 px cropped) and brightness (a small translation and
    a gain/offset change, 6 px cropped);
  - pairs/s at --hw², --batch pairs a call: two warm calls, then the best
    of two rounds of --reps calls, each on a perturbed input, with the
    device synchronised before every clock read.

The four numpy families are the reference's own arrays (the same code
from ``np.random.default_rng(123)`` per family).  The affine and blobs
pairs come from the port's ``synthetic_pair`` with a ``torch.Generator``
seeded 777 + local_blobs, drawing the batches in turn: the reference
draws them from JAX's PRNG, so these two rows are the same distribution,
not the same arrays.  The EPE is ``sqrt(|flow - gt|² + 1e-12)``, the mean
over pixels and then over batches, taken in float64 on the host.

TV-L1 here is the port's, whose warp is always the exact bilinear gather.
The reference's table for TV-L1 was taken on the TPU through the Pallas
path's default separable warp (``exact_warp=False``, a row-then-column
resample), so its TV-L1 EPEs are not this tool's: on the same numpy
arrays the JAX package's Pallas path with ``exact_warp=True`` gives this
tool's rotzoom, squares and brightness EPEs, and with the separable warp
the reference's higher ones.

Prints one line per algorithm, a line with the device (the card's name
and power limit as nvidia-smi reports them), the rates and each
algorithm's hand-kernel launches for one call, the reference's JSON line
and its markdown table.  With --device cuda and no card it fails.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def smooth_image(rng, h: int, w: int, blur: int = 15, pad: int = 16):
    """Band-limited random gray image in [0, 255] float32, padded region
    included so shifted crops stay in-bounds."""
    import cv2
    import numpy as np

    img = rng.uniform(0, 255, (h + 2 * pad, w + 2 * pad)).astype(np.float32)
    img = cv2.GaussianBlur(img, (blur, blur), 0)
    return (img - img.min()) / max(np.ptp(img), 1e-6) * 255.0


def rotzoom_batch(rng, batch: int, h: int, w: int):
    """Rotation+zoom pairs with analytic GT: next(q) = prev(M q), so
    flow(p) = M⁻¹p − p.  Border pixels rotate out of frame (EPE is taken
    12 px inside)."""
    import cv2
    import numpy as np

    prevs, nxts, gts = [], [], []
    xs, ys = np.meshgrid(np.arange(w), np.arange(h))
    for _ in range(batch):
        img = smooth_image(rng, h, w, pad=0)
        theta = np.deg2rad(rng.uniform(-2.5, 2.5))
        s = rng.uniform(0.96, 1.06)
        cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
        R = s * np.array([[np.cos(theta), -np.sin(theta)],
                          [np.sin(theta), np.cos(theta)]])
        t = np.array([cx, cy]) - R @ np.array([cx, cy])
        M = np.float32(np.hstack([R, t[:, None]]))
        nxt = cv2.warpAffine(img, M, (w, h), flags=cv2.INTER_CUBIC
                             | cv2.WARP_INVERSE_MAP)
        Minv = np.linalg.inv(np.vstack([M, [0, 0, 1]]))
        gt_x = Minv[0, 0] * xs + Minv[0, 1] * ys + Minv[0, 2] - xs
        gt_y = Minv[1, 0] * xs + Minv[1, 1] * ys + Minv[1, 2] - ys
        prevs.append(img)
        nxts.append(nxt)
        gts.append(np.stack([gt_x, gt_y], -1).astype(np.float32))
    return np.stack(prevs), np.stack(nxts), np.stack(gts)


def squares_batch(rng, batch: int, h: int, w: int, size: int = 40):
    """Occlusion-heavy pairs: a textured square translating (dx, dy) over
    a differently-textured static background.  GT is (dx, dy) inside the
    first frame's square and 0 elsewhere, the occluded and disoccluded
    strips included.  Needs h and w of at least 71."""
    import numpy as np

    prevs, nxts, gts = [], [], []
    for _ in range(batch):
        bg = smooth_image(rng, h, w, pad=0) * 0.55
        tex = smooth_image(rng, size, size, blur=7, pad=0) * 0.5 + 120
        dx = int(rng.choice([-6, -4, -3, 3, 4, 6]))
        dy = int(rng.choice([-6, -4, -3, 3, 4, 6]))
        x = int(rng.integers(12, w - size - 12 - abs(dx)))
        y = int(rng.integers(12, h - size - 12 - abs(dy)))
        prev = bg.copy()
        prev[y:y + size, x:x + size] = tex
        nxt = bg.copy()
        nxt[y + dy:y + dy + size, x + dx:x + dx + size] = tex
        gt = np.zeros((h, w, 2), np.float32)
        gt[y:y + size, x:x + size] = (dx, dy)
        prevs.append(prev.astype(np.float32))
        nxts.append(nxt.astype(np.float32))
        gts.append(gt)
    return np.stack(prevs), np.stack(nxts), np.stack(gts)


def largedisp_batch(rng, batch: int, h: int, w: int):
    """Large-displacement pairs: global translations of 8-16 px, beyond
    the training generator's ±3 px.  GT analytic."""
    import numpy as np

    prevs, nxts, gts = [], [], []
    for _ in range(batch):
        pad = 20
        big = smooth_image(rng, h + 2 * pad, w + 2 * pad, pad=0)
        dx = int(rng.choice([-16, -12, -9, 9, 12, 16]))
        dy = int(rng.choice([-14, -10, -8, 8, 10, 14]))
        prev = big[pad:pad + h, pad:pad + w]
        # prev(p) = nxt(p + d), so nxt(q) = prev(q - d).
        nxt = big[pad - dy:pad - dy + h, pad - dx:pad - dx + w]
        prevs.append(prev.astype(np.float32))
        nxts.append(nxt.astype(np.float32))
        gts.append(np.full((h, w, 2), (dx, dy), np.float32))
    return np.stack(prevs), np.stack(nxts), np.stack(gts)


def brightness_batch(rng, batch: int, h: int, w: int):
    """Brightness-change pairs: a small global translation and a
    gain/offset change between the frames, against the brightness
    constancy every method here assumes."""
    import numpy as np

    prevs, nxts, gts = [], [], []
    for _ in range(batch):
        pad = 8
        big = smooth_image(rng, h + 2 * pad, w + 2 * pad, pad=0)
        dx = int(rng.choice([-3, -2, 2, 3]))
        dy = int(rng.choice([-3, -2, 2, 3]))
        gain = float(rng.uniform(0.8, 1.2))
        off = float(rng.uniform(-15, 15))
        prev = big[pad:pad + h, pad:pad + w]
        nxt = big[pad - dy:pad - dy + h, pad - dx:pad - dx + w]
        nxt = np.clip(nxt * gain + off, 0, 255)
        gts.append(np.full((h, w, 2), (dx, dy), np.float32))
        prevs.append(prev.astype(np.float32))
        nxts.append(nxt.astype(np.float32))
    return np.stack(prevs), np.stack(nxts), np.stack(gts)


# (family, generator, border cropped from the EPE) of the numpy families.
HELD_OUT = (("rotzoom", rotzoom_batch, 12), ("squares", squares_batch, 0),
            ("largedisp", largedisp_batch, 18),
            ("brightness", brightness_batch, 6))


def families(hw: int, batch: int, val_batches: int):
    """{family: (border crop, [(prev, nxt, gt) numpy batches])}, built on
    the host: affine and blobs from the port's ``synthetic_pair``, the
    others from the numpy generators above."""
    import numpy as np
    import torch
    from video_analytics_tpu_torch.models.spynet import synthetic_pair

    out = {}
    for regime, blobs in (("affine", 0), ("blobs", 2)):
        g = torch.Generator().manual_seed(777 + blobs)
        out[regime] = (0, [tuple(t.numpy() for t in synthetic_pair(
            g, batch, hw, hw, local_blobs=blobs))
            for _ in range(val_batches)])
    for regime, gen, crop in HELD_OUT:
        rng = np.random.default_rng(123)
        out[regime] = (crop, [gen(rng, batch, hw, hw)
                              for _ in range(max(1, val_batches // 2))])
    return out


def flow_functions(device, spynet_checkpoint=None, tvl1_cfg=None,
                   fb_cfg=None, plain: bool = False):
    """({algorithm: fn(prev, nxt) -> flow}, the SpyNet checkpoint's path)
    on `device`: SpyNet (4 levels) on `spynet_checkpoint` or the bundled
    weights, ``flow/tvl1.tvl1`` at `tvl1_cfg` (default ``TVL1Config()``)
    and ``flow/farneback.farneback`` at `fb_cfg` (``FarnebackConfig()``);
    with `plain`, TV-L1 and Farneback run their kernels' plain versions
    (SpyNet has no hand kernel)."""
    import torch
    from video_analytics_tpu_torch.config import FarnebackConfig, TVL1Config
    from video_analytics_tpu_torch.flow.farneback import farneback
    from video_analytics_tpu_torch.flow.tvl1 import tvl1
    from video_analytics_tpu_torch.models.spynet import (
        SpyNet, default_spynet_checkpoint)
    from video_analytics_tpu_torch.runtime.checkpoint import load_variables

    tvl1_cfg = TVL1Config() if tvl1_cfg is None else tvl1_cfg
    fb_cfg = FarnebackConfig() if fb_cfg is None else fb_cfg
    ckpt = spynet_checkpoint or default_spynet_checkpoint()
    net = SpyNet(levels=4)
    net.load_flax_variables(load_variables(ckpt, net.flax_variables()))
    net = net.to(device).eval()

    def no_grad(fn):
        def run(prev, nxt):
            with torch.no_grad():
                return fn(prev, nxt)
        return run

    return {"spynet": no_grad(net),
            "tvl1": no_grad(lambda a, b: tvl1(a, b, tvl1_cfg, plain=plain)),
            "farneback": no_grad(lambda a, b: farneback(a, b, fb_cfg,
                                                        plain=plain))}, ckpt


def endpoint_error(flow, gt, crop: int = 0) -> float:
    """Mean of sqrt(|flow - gt|² + 1e-12) over the pixels `crop` px or more
    inside the border, in float64."""
    import numpy as np

    e = np.sqrt(((flow.astype(np.float64) - gt) ** 2).sum(-1) + 1e-12)
    if crop:
        e = e[:, crop:-crop, crop:-crop]
    return float(e.mean())


def measure_epe(fn, fams, device):
    """{"epe_<family>": mean over the family's batches of the batch's EPE},
    each batch one call of `fn` on `device`."""
    import numpy as np
    import torch

    res = {}
    for regime, (crop, batches) in fams.items():
        res[f"epe_{regime}"] = float(np.mean([
            endpoint_error(fn(torch.from_numpy(p).to(device),
                              torch.from_numpy(n).to(device)).cpu().numpy(),
                           g, crop) for p, n, g in batches]))
    return res


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def pairs_per_sec(fn, prev, nxt, reps: int) -> float:
    """Pairs per second of `fn` on (prev, nxt): two warm calls, then the
    best of two rounds of `reps` calls, call i on prev with 1·i added to
    its first pixel, the device synchronised before each clock read."""
    def perturbed(i):
        p = prev.clone()
        p[0, 0, 0] += float(i)
        return p

    fn(prev, nxt)
    fn(perturbed(1), nxt)
    best = float("inf")
    for _ in range(2):
        _sync(prev.device)
        t0 = time.perf_counter()
        for i in range(reps):
            fn(perturbed(i), nxt)
        _sync(prev.device)
        best = min(best, (time.perf_counter() - t0) / reps)
    return prev.shape[0] / best


def kernel_counts():
    """Launches so far of every hand-written kernel wrapper, by name."""
    from video_analytics_tpu_torch.ops.cuda import farneback as fk
    from video_analytics_tpu_torch.ops.cuda import tvl1_solve as ts
    from video_analytics_tpu_torch.ops.cuda.warp import warp_prep

    wrappers = {"tvl1_scale": ts.pd_solve_scale, "warp_prep": warp_prep,
                "median5": ts.median5, "tvl1_pd_step": ts.pd_step,
                "tvl1_pd_chunk": ts.pd_chunk,
                "fb_prologue": fk.fb_prologue, "fb_warp_neq": fk.fb_warp_neq,
                "sep_corr": fk.sep_corr,
                "fb_window_solve": fk.fb_window_solve,
                "fb_iteration": fk.fb_iteration}
    return {name: fn.launches for name, fn in wrappers.items()}


def launches_of_one_call(fn, prev, nxt):
    """{kernel: launches} of one call of `fn`, those it launched at all."""
    before = kernel_counts()
    fn(prev, nxt)
    _sync(prev.device)
    return {k: n - before[k] for k, n in kernel_counts().items()
            if n > before[k]}


def rounded(res):
    """One algorithm's results as the reference prints them: EPEs to 4
    places, pairs/s to 1."""
    return {k: round(v, 1 if k == "pairs_per_sec" else 4)
            for k, v in res.items()}


def print_results(results, hw: int, batch: int, ckpt: str) -> None:
    """The reference's JSON line and its markdown table."""
    rounded_ = {name: rounded(r) for name, r in results.items()}
    print(json.dumps({"hw": hw, "batch": batch, "spynet_checkpoint": ckpt,
                      **rounded_}))
    print("\n| algo | EPE affine | EPE blobs | EPE rotzoom | "
          "EPE squares | EPE largedisp† | EPE brightness† | "
          "pairs/s @224² |")
    print("|---|---|---|---|---|---|---|---|")
    for name, r in rounded_.items():
        print(f"| {name} | {r['epe_affine']} | {r['epe_blobs']} | "
              f"{r['epe_rotzoom']} | {r['epe_squares']} | "
              f"{r['epe_largedisp']} | {r['epe_brightness']} | "
              f"{r['pairs_per_sec']} |")
    print("\n† held out from SpyNet's training generator (rotzoom and "
          "squares are in its distribution through synthetic_pair's "
          "full_affine and hard_objects; large displacements and "
          "brightness changes are families it cannot produce).")


def main(argv=None, tvl1_cfg=None, fb_cfg=None) -> int:
    """The shoot-out; `tvl1_cfg` and `fb_cfg` replace the default configs
    (for small runs)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--spynet-checkpoint", default=None)
    ap.add_argument("--hw", type=int, default=224)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--val-batches", type=int, default=4)
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' fails without a GPU")
    args = ap.parse_args(argv)

    import torch
    from video_analytics_tpu_torch.models.spynet import synthetic_pair
    from video_analytics_tpu_torch.utils.device import card_name, require_cuda

    device = require_cuda(args.device)
    fns, ckpt = flow_functions(device, args.spynet_checkpoint, tvl1_cfg,
                               fb_cfg)
    fams = families(args.hw, args.batch, args.val_batches)
    prev, nxt, _ = synthetic_pair(torch.Generator().manual_seed(5),
                                  args.batch, args.hw, args.hw, local_blobs=2)
    prev, nxt = prev.to(device), nxt.to(device)
    results, launches = {}, {}
    for name, fn in fns.items():
        res = measure_epe(fn, fams, device)
        res["pairs_per_sec"] = pairs_per_sec(fn, prev, nxt, args.reps)
        launches[name] = launches_of_one_call(fn, prev, nxt)
        results[name] = res
        print(f"{name}: {rounded(res)}", flush=True)
    print(json.dumps({"device": str(device), "card": card_name(device),
                      "pairs_per_sec": {n: r["pairs_per_sec"]
                                        for n, r in results.items()},
                      "launches_per_call": launches}), flush=True)
    print_results(results, args.hw, args.batch, ckpt)
    return 0


if __name__ == "__main__":
    sys.exit(main())
