"""Full-schedule training dress rehearsal (scripts/dress_rehearsal.py).

Exercises every branch of the challenge loop's lifecycle (the reference's
trainv2.py:240-369) in ONE command, end to end, through the port's CLIs
(`python -m seld_tpu_torch....` subprocesses), at synthetic-data scale:

  1. synthesize the offline DCASE2021 feat_label layout (+ dev-val/dev-test
     ground-truth CSVs), unless --data points at the real dataset root
  2. phase 1: training to an epoch INSIDE the SWA window (plateau decay
     active pre-SWA, lr halving + SWA accumulation at swa_start, the
     --eval_every official-ensemble cadence)
  3. phase 2: --resume to the full schedule (the resume lands mid-SWA and
     must carry optimizer + SWA state), final SWA eval + save
  4. verify the schedule from the run's scalars.jsonl: lr == 0.5 * base at
     swa_start, swa_count grows across the resume boundary, ENS_T scores at
     the eval cadence, SWA_best checkpoint on disk
  5. per-class threshold search on the val split (search_best)
  6. make_answer on dev-test with the searched thresholds

The model is `--model` (seldnet) on `--model_config`; 'tiny' writes
TINY_CONFIG, the JAX rehearsal's built-in config (one 16-filter conv
block, one 16-unit biGRU, 16-unit heads), to ./model_config/tiny.json.

    python -m seld_tpu_torch.dress_rehearsal --workdir ./rehearsal \\
        [--clips 24] [--batch 32] [--epoch 14] [--swa_start 6] \\
        [--model seldnet] [--model_config tiny] [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# the JAX rehearsal's built-in model config (scripts/dress_rehearsal.py)
TINY_CONFIG = {
    "FIRST": "simple_conv_block",
    "FIRST_ARGS": {"filters": [16], "pool_size": [[5, 4]]},
    "SECOND": "bidirectional_GRU_block", "SECOND_ARGS": {"units": [16]},
    "SED": "simple_dense_block", "SED_ARGS": {"units": [16]},
    "DOA": "simple_dense_block", "DOA_ARGS": {"units": [16]},
}


def synthesize_dataset(root, n_train, n_eval, label_frames, n_classes,
                       signal_gain=1.0, seed=0):
    """Offline-layout synthetic SELD data with learnable structure:
    class-dependent spectral patterns + DOA-dependent IV channels, so the
    loss actually falls and scores are non-degenerate."""
    import numpy as np

    from seld_tpu_torch.utils import io

    rng = np.random.RandomState(seed)
    feat_dir = os.path.join(root, "DCASE2021/feat_label/foa_dev_norm")
    lab_dir = os.path.join(root, "DCASE2021/feat_label/foa_dev_label")
    val_gt = os.path.join(root, "metadata_dev/dev-val")
    test_gt = os.path.join(root, "metadata_dev/dev-test")
    for d in (feat_dir, lab_dir, val_gt, test_gt):
        os.makedirs(d, exist_ok=True)

    mult = 5
    class_pattern = rng.randn(n_classes, 64).astype(np.float32)

    def one_clip(fold, idx):
        name = f"fold{fold}_room1_mix{idx:03d}"
        sed = np.zeros((label_frames, n_classes), np.float32)
        doa = np.zeros((label_frames, 3, n_classes), np.float32)
        for _ in range(rng.randint(2, 5)):  # a few events per clip
            cls = rng.randint(n_classes)
            start = rng.randint(0, label_frames - 12)
            length = rng.randint(10, 40)
            vec = rng.randn(3)
            vec /= np.linalg.norm(vec)
            sed[start:start + length, cls] = 1.0
            doa[start:start + length, :, cls] = vec
        x = rng.randn(label_frames * mult, 64, 7).astype(np.float32) * 0.3
        # class signature on the mel channels, DOA signature on IV channels;
        # signal_gain scales the class signature (at ~3 discrimination is
        # easier for a small net than memorising the train set)
        up_sed = np.repeat(sed, mult, axis=0)
        up_doa = np.repeat(doa.sum(-1), mult, axis=0)  # [T*mult, 3]
        x[..., :4] += signal_gain * (up_sed @ class_pattern)[:, :, None]
        x[..., 4:] += up_doa[:, None, :]
        y = np.concatenate([sed, doa.reshape(label_frames, -1)], axis=-1)
        np.save(os.path.join(feat_dir, name + ".npy"), x)
        np.save(os.path.join(lab_dir, name + ".npy"), y)
        return name, sed, doa.reshape(label_frames, -1)

    for i in range(n_train):
        one_clip(1, i)
    for i in range(n_eval):
        name, sed, doa = one_clip(5, i)
        io.write_answer(val_gt, name + ".csv", sed, doa)
    for i in range(n_eval):
        name, sed, doa = one_clip(6, i)
        io.write_answer(test_gt, name + ".csv", sed, doa)


def read_scalars(path):
    out = {}
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            out.setdefault(rec["tag"], {})[rec["step"]] = rec["value"]
    return out


def _check(ok, what):
    if not ok:
        raise SystemExit(f"dress rehearsal check failed: {what}")


def check_schedule(scalars, args, phase1_epoch):
    """The lifecycle's boundaries, read from the run's logged scalars."""
    lr = scalars["train/lr"]
    swa_count = scalars["train/swa_count"]
    ens = scalars.get("ENS_T/seldScore", {})

    # lr halves to 0.5 * base at swa_start (trainv2.py:325-326), whatever
    # plateau decay came before it
    _check(abs(lr[args.swa_start] - 0.5 * args.lr) < 1e-9,
           f"lr {lr.get(args.swa_start)} at swa_start, base {args.lr}")
    # plateau decay against the trainer's patience rule: simulate phase
    # 1's val history; a decay forced at epoch e shows in the logged lr of
    # epoch e+1, and only if e+1 < swa_start
    pre = [lr[e] for e in sorted(lr) if e < args.swa_start]
    val = scalars["val/val_seldScore"]
    best, wait, forced = float("inf"), 0, False
    for e in range(min(phase1_epoch, args.swa_start - 1)):
        if e not in val:
            continue
        if val[e] < best:
            best, wait = val[e], 0
        else:
            if wait >= args.lr_patience:
                forced = True
                break
            wait += 1
    drops = any(b < a for a, b in zip(pre, pre[1:]))
    _check(drops or not forced, f"patience rule forced a decay: {pre}")
    # pre-SWA lr only ever steps by the decay factor
    _check(all(b == a or abs(b - 0.5 * a) < 1e-12
               for a, b in zip(pre, pre[1:])), f"pre-SWA lr steps {pre}")
    # SWA accumulates from swa_start on the freq grid, across the resume
    _check(swa_count[args.swa_start] == 1.0, "SWA starts at swa_start")
    _check(swa_count[args.epoch - 1] > swa_count[phase1_epoch - 1],
           "SWA state survives the resume boundary")
    # no decay once SWA is engaged
    post = [lr[e] for e in sorted(lr) if e >= args.swa_start]
    _check(all(abs(v - 0.5 * args.lr) < 1e-9 for v in post),
           f"no decay once SWA is engaged: {post}")
    # official-ensemble eval cadence
    want_evals = set(range(0, args.epoch, args.eval_every))
    _check(want_evals <= set(ens),
           f"ENS_T at {sorted(ens)}, want {sorted(want_evals)}")
    return ens


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n")[0])
    ap.add_argument("--workdir", default="./rehearsal")
    ap.add_argument("--data", default=None,
                    help="real dataset root (skips synthesis)")
    ap.add_argument("--clips", type=int, default=24)
    ap.add_argument("--eval_clips", type=int, default=3)
    ap.add_argument("--label_frames", type=int, default=120,
                    help="600 = full 60 s DCASE clips")
    ap.add_argument("--signal_gain", type=float, default=3.0)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--model", default="seldnet")
    ap.add_argument("--model_config", default="tiny",
                    help="'tiny' writes TINY_CONFIG; anything else must "
                         "resolve from ./model_config or the zoo")
    ap.add_argument("--epoch", type=int, default=14)
    ap.add_argument("--swa_start", type=int, default=6)
    ap.add_argument("--swa_freq", type=int, default=2)
    ap.add_argument("--lr_patience", type=int, default=0)
    ap.add_argument("--patience", type=int, default=1000)
    ap.add_argument("--eval_every", type=int, default=4)
    ap.add_argument("--loop_time", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--augs", default="on", choices=["on", "off"],
                    help="'on' = the challenge --use_tfm --use_acs recipe")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from seld_tpu_torch.make_answer import require_device
    require_device(args.device, "seld_tpu_torch.dress_rehearsal")

    os.makedirs(args.workdir, exist_ok=True)
    workdir = os.path.abspath(args.workdir)

    data_root = os.path.abspath(args.data or os.path.join(workdir, "data"))
    if args.data is None:
        print(f"[rehearsal] synthesizing {args.clips} train / "
              f"{args.eval_clips}+{args.eval_clips} eval clips ...")
        synthesize_dataset(data_root, args.clips, args.eval_clips,
                           args.label_frames, n_classes=12,
                           signal_gain=args.signal_gain)
    if args.model_config == "tiny":
        os.makedirs(os.path.join(workdir, "model_config"), exist_ok=True)
        with open(os.path.join(workdir, "model_config/tiny.json"), "w") as f:
            json.dump(TINY_CONFIG, f)

    model = args.model
    ans_path = os.path.join(data_root, "metadata_dev/")
    feat_label = os.path.join(data_root, "DCASE2021/feat_label")
    phase1_epoch = args.swa_start + args.swa_freq + 1  # inside SWA
    common = ["-m", "seld_tpu_torch.train",
              "--name", "rehearsal", "--model", model,
              "--model_config", args.model_config,
              "--abspath", data_root, "--ans_path", ans_path,
              "--batch", str(args.batch), "--lr", str(args.lr),
              "--loop_time", str(args.loop_time),
              "--swa_start", str(args.swa_start),
              "--swa_freq", str(args.swa_freq),
              "--lr_patience", str(args.lr_patience),
              "--patience", str(args.patience),
              "--eval_every", str(args.eval_every),
              "--label_smoothing", "0",
              "--agc", "true", "--doa_loss", "MMSE",
              "--device", args.device]
    if args.augs == "on":
        common += ["--use_tfm", "--use_acs"]

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])

    def run(cmd, what):
        print(f"[rehearsal] {what}: python {' '.join(cmd[:2])} ...",
              flush=True)
        r = subprocess.run([sys.executable] + cmd, cwd=workdir,
                           capture_output=True, text=True, env=env)
        sys.stdout.write(r.stdout[-4000:])
        if r.returncode != 0:
            sys.stderr.write(r.stderr[-4000:])
            raise SystemExit(f"{what} FAILED (exit {r.returncode})")
        return r

    r1 = run(common + ["--epoch", str(phase1_epoch)],
             f"phase 1 (0 -> {phase1_epoch}, lands mid-SWA)")
    if "best val seld score" not in r1.stdout or \
            "SWA seld score" not in r1.stdout:
        raise SystemExit("phase 1 must train and finish inside SWA")
    r2 = run(common + ["--epoch", str(args.epoch), "--resume"],
             f"phase 2 (--resume -> {args.epoch})")
    if "resumed from epoch" not in r2.stdout or \
            "SWA seld score" not in r2.stdout:
        raise SystemExit("phase 2 must resume and save the SWA average")

    # ---- verify the schedule from the logged scalars ---------------------
    logdir = os.path.join(workdir, "tensorboard_log")
    run_name = None
    for d in sorted(os.listdir(logdir)):
        if d.startswith(f"{model}_{args.model_config}"):
            run_name = d
    if run_name is None:
        raise SystemExit(f"no run under {logdir}: {os.listdir(logdir)}")
    scalars = read_scalars(os.path.join(logdir, run_name, "scalars.jsonl"))
    ens = check_schedule(scalars, args, phase1_epoch)
    print(f"[rehearsal] schedule ok; ENS_T seld at epochs {sorted(ens)}: "
          + ", ".join(f"{ens[e]:.4f}" for e in sorted(ens)))

    model_dir = os.path.join(workdir, "saved_model", run_name)
    swa_ckpts = [d for d in os.listdir(model_dir)
                 if d.startswith("SWA_best_") and not d.endswith(".json")]
    if not swa_ckpts:
        raise SystemExit(f"no SWA_best_* under {model_dir}")
    swa_ckpt = os.path.join(model_dir, sorted(swa_ckpts)[-1])

    # ---- per-class threshold search on the val split ---------------------
    rs = run(["-m", "seld_tpu_torch.search_best", "--data", feat_label,
              "--models", f"{args.model_config}:{swa_ckpt}",
              "--model", model, "--ans_path", ans_path,
              "--output_path", os.path.join(workdir, "threshold_search"),
              "--batch", str(args.batch), "--device", args.device],
             "threshold search on val")
    line = [ln for ln in rs.stdout.splitlines()
            if ln.startswith("THRESHOLDS_JSON:")][-1]
    thresholds = json.loads(line[len("THRESHOLDS_JSON:"):])["thresholds"]

    # ---- submission generation with the searched thresholds --------------
    answer = os.path.join(workdir, "answer")
    ra = run(["-m", "seld_tpu_torch.make_answer", "--data", feat_label,
              "--mode", "test",
              "--models", f"{args.model_config}:{swa_ckpt}",
              "--model", model, "--ans_path", ans_path,
              "--output_path", answer,
              "--thresholds", ",".join(f"{t:.2f}" for t in thresholds),
              "--batch", str(args.batch), "--device", args.device],
             "make_answer (dev-test scoring, searched thresholds)")
    csvs = [f for f in os.listdir(answer) if f.endswith(".csv")]
    _check("SELD:" in ra.stdout and csvs,
           f"make_answer scored and wrote {len(csvs)} CSVs")
    print("[rehearsal] DRESS REHEARSAL PASS: plateau decay, SWA engage "
          "(lr halving), mid-SWA resume, eval cadence, final SWA save, "
          "threshold search, make_answer — all exercised.")


if __name__ == "__main__":
    main()
