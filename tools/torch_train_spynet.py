"""Train the PyTorch port's SpyNet on synthetic motion: the twin of
tools/train_spynet.py (the same flags, Adam, the same step schedule),
on the first CUDA device unless --device says otherwise.

    python tools/torch_train_spynet.py --steps 4000 --local-blobs 2 \
        --out spynet_blobs.msgpack
    python tools/torch_train_spynet.py --steps 2 --hw 32 --device cpu \
        --out /tmp/s.msgpack             # a quick run without a GPU

Steps round-robin over --hw and the --hw-mix sizes (the batch scaled to
hold pixels per step); within each size, the first --mix-affine fraction
of every 100 steps trains on global (affine) motion, the rest on local
blobs and, with --hard-objects, every other step on occluding squares.
It prints the validation EPE of the trained weights and of the bundled
checkpoint (the incumbent) on the same held-out draws, and saves a
msgpack that both packages' ``load_variables`` read (the reference with
``init_spynet``'s template).  Draws come from a ``torch.Generator``
seeded with --seed, so they differ from the JAX tool's.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def val_epe(model, seed: int, batches: int = 8, batch: int = 8,
            hw=(64, 64), local_blobs: int = 0) -> float:
    """Mean EPE over held-out synthetic pairs of one regime: batch i is
    drawn from a generator seeded with seed + i, so two models see the
    same pairs."""
    import torch
    from video_analytics_tpu_torch.models.spynet import synthetic_pair

    device = next(model.parameters()).device
    total = 0.0
    with torch.no_grad():
        for i in range(batches):
            g = torch.Generator(device).manual_seed(seed + i)
            prev, nxt, gt = synthetic_pair(g, batch, *hw,
                                           local_blobs=local_blobs)
            flow = model(prev, nxt)
            total += float(torch.sqrt(((flow - gt) ** 2).sum(-1)
                                      + 1e-8).mean())
    return total / batches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--hw", type=int, default=64)
    ap.add_argument("--hw-mix", default=None,
                    help="comma list of extra square sizes to round-robin"
                         " (e.g. 128,224); the batch is scaled down to hold "
                         "pixels per step roughly constant")
    ap.add_argument("--local-blobs", type=int, default=2,
                    help="moving-object translations per synthetic pair")
    ap.add_argument("--mix-affine", type=float, default=0.5,
                    help="fraction of steps trained on pure-affine pairs")
    ap.add_argument("--full-affine", action="store_true",
                    help="rotation+zoom similarity fields instead of the "
                         "diagonal linear term")
    ap.add_argument("--hard-objects", type=int, default=0,
                    help="sharp-edged occluding squares per pair on every "
                         "other non-affine step")
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--levels", type=int, default=4)
    ap.add_argument("--out", required=True)
    ap.add_argument("--init", default=None,
                    help="warm-start checkpoint (e.g. the bundled one)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' fails without a GPU")
    args = ap.parse_args(argv)

    import torch
    from video_analytics_tpu_torch.models.spynet import (
        SpyNet, default_spynet_checkpoint, init_spynet,
        make_spynet_train_step)
    from video_analytics_tpu_torch.runtime.checkpoint import (
        load_variables, save_variables)
    from video_analytics_tpu_torch.utils.device import require_cuda

    device = require_cuda(args.device)
    gen = torch.Generator(device).manual_seed(args.seed)
    model = init_spynet(SpyNet(levels=args.levels).to(device), gen)
    if args.init:
        model.load_flax_variables(load_variables(args.init,
                                                 model.flax_variables()))
        model.to(device)
    opt = torch.optim.Adam(model.parameters(), lr=args.lr)
    sizes = [args.hw] + ([int(s) for s in args.hw_mix.split(",")]
                         if args.hw_mix else [])
    steps_by_size = {}
    for s in sizes:
        b = max(2, int(round(args.batch * (args.hw / s) ** 2)))
        fa = args.full_affine

        def make(blobs, full, hard=0):
            return make_spynet_train_step(model, opt, batch=b, hw=(s, s),
                                          local_blobs=blobs,
                                          full_affine=full,
                                          hard_objects=hard)

        # Affine steps alternate similarity and diagonal fields when
        # --full-affine is set, so neither global regime is forgotten.
        steps_by_size[s] = (make(args.local_blobs, fa), make(0, fa),
                            make(0, False),
                            make(1, fa, args.hard_objects)
                            if args.hard_objects else None)

    t0 = time.time()
    for i in range(args.steps):
        step_blobs, step_affine, step_diag, step_hard = \
            steps_by_size[sizes[i % len(sizes)]]
        if (i % 100) < args.mix_affine * 100:
            step = step_diag if (args.full_affine and i % 2) \
                else step_affine
        elif step_hard is not None and i % 2:
            step = step_hard
        else:
            step = step_blobs
        loss, epe = step(gen)
        if (i + 1) % 200 == 0:
            print(f"step {i + 1}: loss {float(loss):.4f} "
                  f"epe {float(epe):.4f} "
                  f"({(time.time() - t0) / (i + 1):.3f}s/step)", flush=True)

    vseed = args.seed + 1234

    def report(tag, m):
        for s in sizes:
            vb = max(2, int(round(8 * (64 / s) ** 2)))
            aff = val_epe(m, vseed, hw=(s, s), batch=vb, local_blobs=0)
            blb = val_epe(m, vseed, hw=(s, s), batch=vb,
                          local_blobs=max(1, args.local_blobs))
            print(f"{tag} EPE @{s}: affine {aff:.4f}  blobs {blb:.4f}",
                  flush=True)

    report("val", model)
    save_variables(args.out, model.flax_variables())
    print(f"saved {args.out}")

    try:
        incumbent = SpyNet(levels=args.levels)
        incumbent.load_flax_variables(load_variables(
            default_spynet_checkpoint(), incumbent.flax_variables()))
        report("incumbent", incumbent.to(device))
    except (FileNotFoundError, ValueError) as e:
        print(f"no incumbent checkpoint to compare ({e})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
