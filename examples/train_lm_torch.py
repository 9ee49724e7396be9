"""Train a small LM end to end with the PyTorch port's stack.

    python examples/train_lm_torch.py                        # on the card
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu

The counterpart of ``examples/train_lm.py``: the same qwen-style
overrides (a ~20M-parameter float32 model by default) through
``repro_torch.launch.train.train``, its train step, AdamW and
checkpoints.  At head dim 64 the attention runs the flash kernel on the
card.  Checkpoints go under ``build/`` of the checkout; kill and rerun to
resume from the latest.
"""
import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.launch.train import train  # noqa: E402


def overrides(d_model: int, layers: int) -> dict:
    return {
        "num_layers": layers,
        "d_model": d_model,
        "num_heads": max(4, d_model // 64),
        "num_kv_heads": max(4, d_model // 64),
        "head_dim": 64,
        "d_ff": d_model * 3,
        "vocab_size": 8192,
        "dtype": "float32",
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--ckpt-dir",
                    default=str(ROOT / "build" / "train_lm_torch_ckpt"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    history = train(
        "qwen1_5_0_5b", steps=args.steps, seq_len=args.seq_len,
        global_batch=args.global_batch, smoke=True,
        overrides=overrides(args.d_model, args.layers), lr=1e-3,
        ckpt_dir=args.ckpt_dir, ckpt_every=max(50, args.steps // 4),
        device=args.device)
    first, last = history[0], history[-1]
    print(f"\nloss: {first['loss']:.3f} -> {last['loss']:.3f} over "
          f"{args.steps} steps ({last['tokens_per_s']:.0f} tok/s); "
          f"checkpoints in {args.ckpt_dir} (kill and rerun to resume)")
    if not last["loss"] < first["loss"]:
        raise AssertionError("loss must decrease")
    return history


if __name__ == "__main__":
    main()
