"""Random-search NAS driver (scripts/nas_search.py; reference
nas_seldnet.py, nas_vad.py).

SELD search:
    python -m seld_tpu_torch.nas_search --task seld --name 2021_1 \\
        --dataset_path <feat_label dir> --n_samples 256 \\
        --min_flops 400000000 --max_flops 480000000 [--proxy trainer] \\
        [--device_data] [--parallel N]

VAD search (pairs from `python -m seld_tpu_torch.vad_rehearsal` or
`python -m seld_tpu_torch.prepare_vad`):
    python -m seld_tpu_torch.nas_search --task vad --name vad_1 \\
        --vad_pairs pairs.npz --n_samples 256 \\
        --min_flops 500000 --max_flops 600000

Resumable: re-running with the same --name continues from the last
completed sample (the results JSON is the source of truth). Candidates run
on the card (--device, default cuda) unless --eval_device names another
device; --device cpu runs everything on the CPU. --device_data stages the
SELD splits on the card once and every candidate gathers its batches there
(one card; not with --eval_device cpu or --parallel). --parallel N runs N
candidates at once in worker threads over the visible cards, which may
share one card. The sampler draws from the stdlib `random` module,
unseeded, as the JAX CLI's; a caller that runs `main` in its process may
seed it first.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def _devices(name: str):
    """Every visible device of `name`'s kind: the cards for cuda, else the
    one named device."""
    dev = torch.device(name)
    if dev.type == "cuda" and dev.index is None:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--task", default="seld", choices=["seld", "vad"])
    ap.add_argument("--name", required=True)
    ap.add_argument("--results_dir", default=".")
    ap.add_argument("--n_samples", type=int, default=256)
    ap.add_argument("--n_blocks", type=int, default=4)
    ap.add_argument("--min_flops", type=int, default=400_000_000)
    ap.add_argument("--max_flops", type=int, default=480_000_000)
    ap.add_argument("--batch_size", type=int, default=256)
    ap.add_argument("--n_repeat", type=int, default=50)
    ap.add_argument("--proxy", default="reference",
                    choices=["reference", "trainer"],
                    help="candidate training recipe: 'reference' = the "
                         "reference's NAS proxy (adam, plain BCE+MSE "
                         "1:1000); 'trainer' = the challenge trainer "
                         "recipe (AdaBelief+AGC, class-weighted losses, "
                         "L2)")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--n_classes", type=int, default=12)
    ap.add_argument("--dataset_path", default="")
    ap.add_argument("--vad_pairs", default="")
    ap.add_argument("--device", default="cuda",
                    help="where data is staged and candidates run")
    ap.add_argument("--eval_device", default="",
                    help="run the candidates on this device instead "
                         "(e.g. 'cpu')")
    ap.add_argument("--device_data", action="store_true",
                    help="seld task: stage the train/test splits on the "
                         "card once; candidates gather batches there "
                         "(one card; excludes --eval_device cpu / "
                         "--parallel)")
    ap.add_argument("--parallel", type=int, default=0,
                    help="evaluate N candidates concurrently in worker "
                         "threads over the visible devices (0 = serial)")
    args = ap.parse_args(argv)

    from seld_tpu_torch.make_answer import require_device
    require_device(args.device, "seld_tpu_torch.nas_search")
    eval_device = args.eval_device or args.device
    require_device(eval_device, "seld_tpu_torch.nas_search")

    from seld_tpu_torch.nas.search import (SELD_SEARCH_SPACE_2D,
                                           RandomSearch,
                                           train_and_eval_candidate)

    train_config = {
        "n_blocks": args.n_blocks, "min_flops": args.min_flops,
        "max_flops": args.max_flops, "batch_size": args.batch_size,
        "n_repeat": args.n_repeat, "lr": args.lr,
        "first_pool_size": [5, 2], "n_classes": args.n_classes,
        "proxy": args.proxy,
    }

    if args.task == "seld":
        from seld_tpu_torch.data.loader import SeldDataset, load_seldnet_data
        x, y = load_seldnet_data(
            os.path.join(args.dataset_path, "foa_dev_norm"),
            os.path.join(args.dataset_path, "foa_dev_label"), mode="train")
        trainset = SeldDataset.from_clips(x, y, batch_size=args.batch_size,
                                          loop_time=args.n_repeat)
        x, y = load_seldnet_data(
            os.path.join(args.dataset_path, "foa_dev_norm"),
            os.path.join(args.dataset_path, "foa_dev_label"), mode="test")
        testset = SeldDataset.from_clips(x, y, batch_size=args.batch_size,
                                         train=False)
        input_shape = (300, 64, 7)

        if args.device_data:
            # stage the splits on the card once: every sampled candidate
            # then trains from the resident arrays
            if torch.device(eval_device).type == "cpu" or args.parallel:
                raise SystemExit("--device_data stages on one card; it "
                                 "cannot combine with --eval_device cpu "
                                 "or --parallel")
            from seld_tpu_torch.data.device_dataset import DeviceDataset
            trainset = DeviceDataset(trainset.x, trainset.y,
                                     args.batch_size, eval_device,
                                     loop_time=args.n_repeat)
            testset = DeviceDataset(testset.x, testset.y,
                                    testset.batch_size, eval_device,
                                    train=False)

        search = RandomSearch(
            args.name, train_config, results_dir=args.results_dir,
            n_blocks=args.n_blocks, input_shape=input_shape,
            min_flops=args.min_flops, max_flops=args.max_flops,
            n_classes=args.n_classes)

        def evaluate(model_config, device=eval_device):
            return train_and_eval_candidate(
                model_config, input_shape, trainset, testset,
                n_classes=args.n_classes, lr=args.lr, proxy=args.proxy,
                device=device)

    elif args.proxy != "reference":
        raise SystemExit("--proxy is a seld-task knob (the VAD candidate "
                         "trainer is VADTrainer); drop it for --task vad")

    if args.task != "seld":  # vad
        from seld_tpu_torch.data.vad import DEFAULT_WINDOW, VadDataset
        from seld_tpu_torch.nas.complexity import vad_architecture_complexity
        from seld_tpu_torch.nas.sampler import vad_architecture_sampler
        from seld_tpu_torch.train.vad import VADTrainer

        data = np.load(args.vad_pairs, allow_pickle=True)
        pairs = list(data["pairs"]) if "pairs" in data else list(data)
        split = max(1, int(len(pairs) * 0.8))
        trainset = VadDataset(pairs[:split], batch_size=args.batch_size,
                              n_repeat=args.n_repeat)
        valset = VadDataset(pairs[split:] or pairs[:1],
                            batch_size=args.batch_size, train=False)
        input_shape = (len(DEFAULT_WINDOW), 80, 1)

        space_2d = dict(SELD_SEARCH_SPACE_2D)
        space_1d = {"simple_dense_block": {
            "units": [[16], [24], [32], [48], [64], [96], [128]],
            "dense_activation": [None, "relu"]}}
        search = RandomSearch(
            args.name, train_config, results_dir=args.results_dir,
            sampler=vad_architecture_sampler,
            search_space_2d=space_2d, search_space_1d=space_1d,
            n_blocks=args.n_blocks, input_shape=input_shape,
            min_flops=args.min_flops, max_flops=args.max_flops)

        def evaluate(model_config, device=eval_device):
            # flatten False + last_unit 1 (nas_vad.py:203-204): the conv
            # body keeps the 7-frame context axis and Dense(1) squeezes to
            # per-frame probabilities [B, 7]
            cfg = {"flatten": False, "last_unit": 1, **model_config}
            trainer = VADTrainer(cfg, input_shape, lr=args.lr,
                                 device=device)
            result = trainer.fit(trainset, valset, epochs=1, verbose=False)
            cx = vad_architecture_complexity(cfg, list(input_shape))[0]
            return {"val_auc": result["best_val_auc"], **cx}

    if args.parallel:
        search.run_parallel(args.n_samples, evaluate,
                            workers=args.parallel,
                            devices=_devices(eval_device))
    else:
        search.run(args.n_samples, evaluate)
    print(f"done: {search.n_done} samples in {search.path}")
    return search


if __name__ == "__main__":
    main()
