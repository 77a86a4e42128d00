"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch \
        h2o-danube-1.8b --smoke --steps 50 --batch 8 --seq 128 \
        [--ckpt-dir ckpts/h2o] [--fail-at 30] [--device cpu]

``--smoke`` selects the reduced config (CPU-runnable); without it the full
published config trains.  ``--fail-at N`` injects a failure to demonstrate
checkpoint-restart (it needs ``--ckpt-dir``).  Without ``--device`` the
run trains on the card (and raises without one); ``--device cpu`` runs the
kernels' plain versions on the CPU.
"""
import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--fail-at", type=int, action="append", default=[])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.training.train_loop import TrainConfig, train

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    tc = TrainConfig(steps=args.steps, global_batch=args.batch,
                     seq_len=args.seq, ckpt_dir=args.ckpt_dir,
                     ckpt_every=args.ckpt_every)
    _, history = train(cfg, tc, fail_at=set(args.fail_at),
                       device=args.device)
    if history:
        print(f"final loss: {history[-1]['loss']:.4f}")
    return history


if __name__ == "__main__":
    main()
