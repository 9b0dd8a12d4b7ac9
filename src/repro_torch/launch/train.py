"""Training launcher: --arch <id> [--smoke] [--steps N] [--resume].  The
port's counterpart of ``python -m repro.launch.train``, on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
        --steps 20                       # on the card
    PYTHONPATH=src python -m repro_torch.launch.train --arch egnn \
        --steps 20 --device cpu          # the plain path on the CPU

The flags and the printout are the reference's, plus ``--device`` (the card
unless ``cpu`` is given).  As in the reference, ``--smoke`` defaults to true
and no flag turns it off, so the launcher always trains the reduced config
(ROADMAP Queue 3, R11); a full-width run goes through the library API
(``arch.make_step(arch.config(), "train")``, as ``chip_smoke.py`` phase 18
does).  There is no mesh: the port trains on one device (the mesh rules
come with the dry-run slice, ROADMAP Queue 1 item 6).

Fault tolerance is on by default: async checkpoints every --ckpt-every
steps under ``--ckpt-dir/<arch>``, restore-on-start with --resume, and a
deterministic counter -> batch pipeline (``data.pipeline``), so a resumed
run continues exactly where the checkpoint left it.
"""
from __future__ import annotations

import argparse
import time

from repro_torch.checkpoint import ckpt as ckpt_lib
from repro_torch.configs import registry
from repro_torch.data import pipeline
from repro_torch.kernels.backend import resolve_device
from repro_torch.optim import adamw
from repro_torch.runtime.fault_tolerance import StragglerWatchdog


def make_batch_fn(arch, cfg, batch: int, seq: int, seed: int, device):
    fam = arch.family
    if fam == "lm":
        return lambda step: pipeline.lm_batch(seed, step, batch, seq,
                                              cfg.vocab, device=device)
    if fam == "recsys":
        return lambda step: pipeline.recsys_batch(seed, step, batch, cfg,
                                                  device=device)
    if fam == "gnn":
        g = pipeline.random_graph(seed, n_nodes=512, n_edges=2048,
                                  d_feat=cfg.d_feat, n_classes=cfg.n_classes,
                                  device=device)
        return lambda step: g
    raise ValueError(fam)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--ckpt-dir", default="artifacts/ckpt")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu for the plain PyTorch path")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    arch = registry.get(args.arch)
    cfg = arch.config(smoke=args.smoke)
    step_fn = arch.make_step(cfg, "train")

    params = arch.init_params(cfg, seed=args.seed, device=dev)
    opt = adamw.init_state(params)
    start = 0
    ckpt_dir = f"{args.ckpt_dir}/{args.arch}"
    if args.resume and ckpt_lib.list_steps(ckpt_dir):
        state, start = ckpt_lib.restore(ckpt_dir, {"params": params,
                                                   "opt": opt}, device=dev)
        params, opt = state["params"], state["opt"]
        print(f"resumed from step {start}")

    batch_fn = make_batch_fn(arch, cfg, args.batch, args.seq, args.seed, dev)
    saver = ckpt_lib.AsyncCheckpointer(ckpt_dir)
    wd = StragglerWatchdog()
    for step in range(start, args.steps):
        t0 = time.time()
        params, opt, metrics = step_fn(params, opt, batch_fn(step))
        loss = float(metrics["loss"])          # waits for the step's work
        dt = time.time() - t0
        slow = wd.observe(step, dt)
        if step % 5 == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss={loss:.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"dt={dt*1e3:.1f}ms{'  [straggler]' if slow else ''}",
                  flush=True)
        if (step + 1) % args.ckpt_every == 0:
            saver.save_async(step + 1, {"params": params, "opt": opt})
    saver.wait()
    ckpt_lib.save(ckpt_dir, args.steps, {"params": params, "opt": opt})
    print("done")


if __name__ == "__main__":
    main()
