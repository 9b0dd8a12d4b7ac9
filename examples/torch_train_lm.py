"""Train a reduced-config LM (same family as the assigned archs) with
checkpoint/restart enabled, on the PyTorch port: the counterpart of
``examples/train_lm.py``.  On the card unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/torch_train_lm.py --arch qwen3-1.7b --steps 200
    PYTHONPATH=src python examples/torch_train_lm.py --steps 20 --device cpu
"""
import argparse

from repro_torch.launch import train


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default="cuda")
    args, _ = ap.parse_known_args()
    train.main(["--arch", args.arch, "--smoke", "--steps", str(args.steps),
                "--batch", "8", "--seq", "64", "--ckpt-every", "50",
                "--device", args.device])


if __name__ == "__main__":
    main()
