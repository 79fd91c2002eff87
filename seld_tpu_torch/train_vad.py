"""VAD baseline training (scripts/train_vad.py; reference
train_vad_baseline.py).

Expects VAD data as an .npz with `pairs` = array of (features [T, 80, 1],
labels [T]) from `python -m seld_tpu_torch.prepare_vad`:

    python -m seld_tpu_torch.train_vad --train train.npz --val val.npz \\
        [--model vad_architecture|spectro_temporal_attention_based_VAD] \\
        [--epochs 100] [--batch 256] [--lr 1e-4] [--device cuda|cpu]

Prints each epoch's record, the best val AUC and the full-sequence
metrics. Runs on the card unless --device cpu.
"""
from __future__ import annotations

import argparse

import numpy as np


def load_pairs(path):
    data = np.load(path, allow_pickle=True)
    return list(data["pairs"])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--train", required=True)
    ap.add_argument("--val", default="")
    ap.add_argument("--model", default="vad_architecture")
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--n_repeat", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--patience", type=int, default=16)
    ap.add_argument("--units", type=int, default=512)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from seld_tpu_torch.make_answer import require_device
    require_device(args.device, "seld_tpu_torch.train_vad")
    from seld_tpu_torch.data.vad import DEFAULT_WINDOW, VadDataset
    from seld_tpu_torch.train.vad import VADTrainer

    window = DEFAULT_WINDOW
    train_pairs = load_pairs(args.train)
    trainset = VadDataset(train_pairs, window=window, batch_size=args.batch,
                          n_repeat=args.n_repeat)
    val_pairs = load_pairs(args.val) if args.val else train_pairs
    valset = VadDataset(val_pairs, window=window, batch_size=args.batch,
                        train=False)

    n_mels = train_pairs[0][0].shape[1]
    input_shape = (len(window), n_mels, 1)
    if args.model == "vad_architecture":
        # bDNN-style baseline: 2 dense layers, window-sized output
        cfg = {"flatten": True, "last_unit": len(window),
               "BLOCK0": "simple_dense_block",
               "BLOCK0_ARGS": {"units": [args.units, args.units],
                               "dense_activation": "relu",
                               "dropout_rate": 0.5}}
    else:
        cfg = {}

    trainer = VADTrainer(cfg, input_shape, model_name=args.model, lr=args.lr,
                         device=args.device)
    result = trainer.fit(trainset, valset, epochs=args.epochs,
                         patience=args.patience)
    print(f"best val AUC: {result['best_val_auc']:.5f}")

    seq = trainer.evaluate_sequences(val_pairs, window)
    print("full-sequence:", {k: round(v, 5) for k, v in seq.items()})
    return {"best_val_auc": result["best_val_auc"], "sequence": seq,
            "epochs": len(result["history"])}


if __name__ == "__main__":
    main()
