#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (seld_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, one line each:
  1. device   the card's name and power limit (nvidia-smi)
  2. build    compile every CUDA kernel of the port from csrc/ (seconds)
  3. kernels  each kernel against its plain PyTorch version on the card, in
              f32 and bf16 at its path's shapes, with its time, the plain
              version's time, its bound and one PyTorch library call's time
              (none for stem_dy); batch_norm's four passes at SELDnet's
              first BatchNorm, SS5's mother stage, the SS5 stem's
              statistics and odd and mixed cases (the sums bit for bit),
              each pass's device ms beside its bytes bound, the composed
              chain's and cuDNN's forward + backward; the fused BatchNorm
              -> ReLU -> max pool at SELDnet's three blocks in bf16
              against the composed chain, bit for bit (pooled output,
              batch mean and var, dx, dscale, dbias, the tie counts) on
              inputs with tied maxima and windows all <= 0, 1 batch_norm
              and 3 batch_norm_pool launches, each pass's device ms beside
              its bytes bound and both chains' forward + backward
  4. routes   the shapes the kernels do not take, on the card against the
              CPU through the composed routes, with no kernel launched: a
              biGRU at U=6 (B=8) and U=390 (B=3), FOA features at 40
              mels and n_fft 512, microphone-array features (log-mel +
              GCC-PHAT, mode "mic", never the front-end kernel) of two
              10-s clips, one with a second of digital silence; a
              Conv2DBN stem with pool [5, 4] (one
              train step), whose backward runs stem_dy's generic path
              once; a biGRU at U=384 and U=512, B=8, through the
              resident GRU kernels (the JAX package runs its kernel
              there), forward and gradients against the CPU;
              GRU dropout's routes on a biGRU U=128 (the same numpy masks
              on the card and the CPU): input dropout keeps gru_scan,
              recurrent dropout takes the masked route with no GRU
              launch; the equality max-pool backward
              (SELD_EQ_MAXPOOL_BWD=1) on a tied [5, 2] pool
  5. model    full-width SS5 (seeded weights), B=32, on the card against the
              same model on the CPU with the plain kernels, TF32 off
  6. serve    export a window artifact, serve it with micro-batching on an
              ephemeral port, send concurrent /v1/score requests (f32 and
              one bf16) through the port's client, check every reply against
              a direct forward and that every dispatch launched the GRU
              kernel once per GRU layer
  7. train    the SS5 training step at full width: (a) one f32 step at B=8,
              dropouts zeroed, on the card against the same step on the CPU
              (losses, every gradient, the updated parameters, the running
              statistics); (b) 20 bf16 steps at B=256 with dropout through
              seld_tpu_torch.bench's step: finite losses and exactly 2
              gru_scan, 2 gru_scan_bwd, 1 stem_dy and 29 batch_norm
              launches per step (4 passes for each of 7 BatchNorms, the
              stem's statistics) and no batch_norm_pool (SS5 feeds no
              BatchNorm to a pool; [graph] holds the same); the other
              phases check the first five kernels' launches and leave
              batch_norm's, which follow each model's BatchNorms;
              (c) the fused single step (make_train_step(fuse_metrics=
              True): the update and the metric as one CUDA graph), 3 calls
              against 3 unfused steps from the same seed (losses, state,
              metric, the dropout generator, equal launches), then ms a
              step of each in turns
  8. graph    the k-step call (make_train_multistep, k=8: a CUDA graph of
              one step replayed k times) at SS5 full width, B=256, bf16,
              dropout on: (a) one call against 8 eager steps from the same
              seed on the same batches (losses, parameters, running
              statistics, the metric, the dropout generator's state, one
              further eager step; exact launch counts); (b) ms/step and
              windows/s eager and graphed in turns, and the launch counts
              of graph replays alone, exactly 8 x the eager step's per call
  9. feed     the wav-native training path at full width through its CLI
              (python -m seld_tpu_torch.train's main): 20 numpy-seeded
              60-s 24 kHz FOA wavs with label CSVs (16 train, 2 val, 2
              test) -> the front-end kernel -> train-split normalizer ->
              windows staged on the card -> 2 epochs of SS5 bf16 training at
              B=64 with --use_tfm --use_acs, each batch gathered on the card
              by the row-gather kernel, val and test epochs, a best-score
              checkpoint; then --resume from that checkpoint. Three times:
              eagerly, with --epoch_scan (the epoch step: gather, augments
              and update a step as a CUDA graph replayed once a step) and
              with --epoch_scan --fuse_metrics. Exact launch counts of all
              five kernels, finite losses, the resumed epochs, the
              feature-build time, each epoch's time and windows/s through
              the feed
 10. tdm      TDM and the microphone-array inputs through the same CLI
              at full width: 20 seeded 60-s clips under foa_dev and
              mic_dev (the same stems, independent noise) with labels in
              runs of events. --use_tdm --tdm_epoch 1 --epoch_scan: each
              epoch rebuilds the train split (events pasted on the host,
              features through the front-end kernel, normalization and
              windows on the host) and restages it, and the epoch step is
              captured anew; the first batch each replayed epoch gathers
              equals the host's gather from the new split; each rebuild's
              seconds by part, the front-end's device ms and the capture's
              seconds beside the epoch's. --from_wav --wav_mode mic (10
              channels, no front-end launch) and --use_both --use_acs
              --epoch_scan (17 channels, acs_aug inside the epoch graph).
              Each with its --resume: exact launch counts of all five
              kernels (the rebuilds' included), finite losses, the resumed
              epochs, the normalizer's width, windows/s
 11. clip     clip scoring at SS5 full width (seeded weights) on four
              seeded 60-s clips [3000, 64, 7], f32, TF32 off: gru_scan
              against gru_scan_ref at the clip path's batch shapes (B=512
              chunks of the exact path, B=544 of the fast path, B=2168 of
              four clips stacked); the exact path (chunks of 512 windows)
              and the fast path (the trunk once a clip, all 541 windows in
              one head chunk of 544) on the card, against the same paths
              on the CPU (the exact path on one clip, the fast on two);
              the fast path against the exact one where they must
              agree (a one-window clip, the trunk's interior frames);
              clip_batch=4 against clip-at-a-time; a clip artifact and a
              two-member clip-ensemble artifact, reloaded, against the
              direct call; int8 weights and bf16 against f32 within stated
              tolerances; a served clip artifact's reply against the direct
              call; exact gru_scan launch counts (2 per head forward)
 12. answer   the dress rehearsal (python -m seld_tpu_torch.dress_rehearsal)
              on the card, its default seldnet on the JAX rehearsal's tiny
              config: train into the SWA window with the periodic
              official evaluation, resume to the end, the final SWA
              evaluation and its save, the schedule checks from the run's
              scalars, search_best on dev-val, make_answer on dev-test with
              the searched thresholds
 13. stream   real-time streaming at SS5 full width (seeded weights), f32
              with TF32 off: gru_scan at the stream head's batches (B=10,
              14, 40, 56; f32 and bf16) and foa_frontend at a push's
              segment, the right-aligned tail and a short clip, each
              against its plain version with its times and bound; the
              halo measured on the card; one seeded 60-s feature clip
              pushed 1 s at a time through StreamingSELD (600 of 600
              frames, equal to the fast path on the card; exactly 2
              gru_scan launches a head call), a 15-s clip's stream on the
              card against the CPU's, 4 lockstep streams against 4 single
              ones, a bf16 engine against f32; StreamingSELDWav on a
              seeded 60-s wav against offline extraction + the fast path
              (one foa_frontend launch an extraction); f32 and int8 stream
              bundles, served: two concurrent /v1/stream sessions equal to
              the live engine, a short stream's finalize refused (400), a
              /v1/reload under a live session, the session gauge back to
              0; push latency p50/p99, device ms and idle share a push at
              1 and 4 streams, finalize ms and the real-time factor
 14. nas      the architecture search at its full input (300, 64, 7), f32,
              TF32 off: (a) gru_scan and gru_scan_bwd at D=2, T=60, B=256
              at every unit count of the search space the kernels take
              (4, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256; U=6 runs
              the plain recurrence), each against its plain version, with
              its time, bound, the plain version's time and (forward)
              cuDNN's torch.nn.GRU time; stem_dy in f32 at [256, 300, 64,
              32], pool [5, 2], dpooled as the candidate's step hands it
              over; (b) one candidate of the 400-480 MFLOP window with
              biGRU stages (dropout 0) trained 2 steps at B=16 and scored
              through train_and_eval_candidate on the card and on the CPU
              from the same weights, both proxies: losses, the four
              scores, the 12 swept seld values; (c) python -m
              seld_tpu_torch.nas_search --task seld --device_data --proxy
              trainer on a synthesized feat_label tree (32 train clips, 2
              test clips, B=256, --n_repeat 4: 5 train steps and 2 eval
              batches a candidate), 3 samples, then resumed to 4: exactly
              one more candidate trains and the earlier entries stay;
              each candidate's exact launches: stem_dy 1 a train step,
              gru_scan 1 a GRU layer with U != 6 a train step and an eval
              batch, gru_scan_bwd 1 such layer a train step, gather_rows 1
              a batch; its seconds and the fit's windows/s; (d)
              run_parallel, 2 worker threads on the one card, against the
              serial run from the same random.seed (cuDNN deterministic):
              the same configs in order, equal losses; (e) python -m
              seld_tpu_torch.analyze_nas on the results (no --plots:
              nothing on the card's path imports matplotlib)
 15. vad      voice activity detection: the VAD rehearsal (python -m
              seld_tpu_torch.vad_rehearsal: 64 + 8 synthesized 8-s clips,
              prepare_vad's 80-mel features on the card, the bDNN
              baseline 16 epochs, window and full-sequence AUC); both VAD
              models' forwards at B=256 and one attention-model train
              step, card against CPU; nas_search --task vad for two
              samples on the rehearsal's npz. No kernel of the port runs
              on this path (checked: no launch)
 16. zoo      the model zoo's nine configs (seldnet, seldnet_v1, SS5,
              dense_gru, resnet_gru, resnet50_gru, xception_gru,
              Condseldnet, conv_temp) at full width, seeded weights: (a)
              the eval forward at B=4, f32, card against CPU (sed, doa and
              the conv body's output; exactly 2 gru_scan launches); (b)
              one f32 train step at B=2 card against CPU (losses,
              gradients, updated parameters, running statistics; the null
              leaves found from the forward's structure); (c) 10 bf16
              steps at B=256 eagerly, then make_train_multistep(10)'s
              capture and a timed call of replays: finite losses, exactly
              gru_scan 2, gru_scan_bwd 2 and stem_dy 1 (conv_temporal) or
              0 a step, batch_norm_pool 9 a step in seldnet, seldnet_v1
              and Condseldnet (3 a conv layer) and 0 elsewhere, ms/step,
              windows/s and peak memory; (d) stem_dy at
              conv_temp's [256, 300, 64, 32] bf16, pool [5, 1], the
              cotangent as its first res_bottleneck_stage hands it over,
              against stem_dy_ref on data with ties, its time, bound and
              path; (e) seldnet and xception_gru as window artifacts
              behind the server: replies equal the direct call, 2
              gru_scan launches a dispatch
 17. blocks   path A, accdoa on SS5's config, and path B, SS5 with BLOCK2
              swapped for each 1-D block (transformer, attention with RFF
              and GLU, the relative scanned conformer, RNN_stage LSTM,
              GRU and GRU with dropout 0.2, tcn_stage, identity_block) at
              full width, seeded weights: (a) the eval forward at B=4, f32,
              card against CPU (sed, doa and BLOCK2's output; exact
              gru_scan launches); (b) one f32 train step at B=2 card
              against CPU by [zoo] (b)'s rule; (c) 10 bf16 steps at B=256
              eagerly, then make_train_multistep(10)'s capture and a timed
              call of replays: finite losses, exactly stem_dy 1, gru_scan
              and gru_scan_bwd 2 (+2 for the GRU RNN_stage; none from the
              masked route; accdoa 0) a step, ms/step, windows/s and peak
              memory; (d) --model accdoa through the training CLI on
              [feed]'s wav tree with --epoch_scan and a resume: sedLoss 0.0
              throughout, exact launches of all five kernels
 18. dp       data-parallel training: (a) 2 ranks sharing the card over
              gloo, full-width SS5 bf16, 128 of a global batch of 256
              windows each, 3 steps through make_train_step fed from
              each rank's shard of a sharded DeviceDataset, against one
              process's 3 steps at B=256 on the same global batches
              (losses, running statistics, parameter updates; the ranks
              equal bit for bit; exactly gru_scan 2, gru_scan_bwd 2,
              stem_dy 1 and gather_rows 1 a step on each rank); (b) the
              training CLI on [feed]'s wavs under torch.distributed.run
              as an NCCL group of one rank, --mesh data:-1 --epoch_scan
              (the all-reduces captured in the epoch graph), against the
              CLI without a group, then its checkpoint resumed without a
              group; (c) (a) over NCCL with a card a rank, and the CLI
              started plainly over two cards (it spawns the ranks)
              against the CLI on one card, where the machine has two
              cards (else one line says it did not run). The second
              shard's windows are scaled and offset, so local and global
              BatchNorm statistics differ; every CLI run is bounded in
              time. --dp faults runs (a) alone and then with each planted
              fault (local BatchNorm statistics; the stem's backward on
              the local count), each of which (a) must catch. (d) clip
              scoring and serving over ranks: (d1) two gloo ranks sharing
              the card run ensemble_outputs(mesh=...) on four seeded 60-s
              clips at full width (exact at batch 512, fast, fast at
              clip_batch 4; f32) against one process on the card, with
              exact gru_scan launches a rank; (d2) a data-parallel window
              artifact for one card more than the machine has is
              exported and its load must refuse; (d3) where there are two
              cards, NCCL ranks on cards 0,1 score the same clips against
              one card, a two-card artifact is served against the live
              model for requests of 1, 3 and 4 windows, and ms a 60-s clip
              and served windows/s are printed at one card and two (else
              one line says (d3) did not run). --dp cards runs (c), (d3)
              and [tp] (b) alone. Neither prints a result line.
 19. tp       tensor parallelism over a model axis (parallel/
              partitioning.py): SS5 full width bf16, dropout off, the
              bench's batch of 256 windows, 3 steps on a data:1,model:2
              mesh, each rank holding half of every sharded kernel (the
              stem's 32 filters, the attention heads, the dense and conv
              outputs), against one process's steps by [dp] (a)'s rule
              (the shards put back together); exactly gru_scan 2,
              gru_scan_bwd 2 and stem_dy 1 a step on each rank. (a) two
              gloo ranks sharing the card; (b) two NCCL ranks on two cards
              with ms a step, where there are two cards
 20. tools    the tooling twins on the card: (a) python -m
              seld_tpu_torch.smoke, exact launches; (b) extract_features on
              10 seeded 60-s wavs (two front-end launches) against the
              kernel's plain version; (c) bench_frontend on 16 clips;
              (d) profile_train --trace (SS5 B=256 bf16), the trace's card
              kernels grouped by utils/trace_analysis.py; (e) a seeded
              SS5's weights as Keras-named layers through the h5 import's
              mapping onto other weights, saved, loaded and served as a
              window artifact against the seeded model
Phase 3 holds gru_scan at B in {1, 3, 17, 32, 256} (U=128, f32 and bf16),
at U=64, at U in {192, 256} (B in {3, 32, 256}, f32 and bf16) and U=152,
both GRU kernels past U = 256 (gru_wide): the resident variants at
U=260, 384, 388, 512 (ragged tiles, uneven CTA shares), the streamed
ones at U=1024, 2056 and the grid-resident ones (Rk in bf16) at U=544,
640, 1024, each call twice and bit-equal, all timed at B=256, U in {384,
512, 1024}, with Rk in bf16 and f32, beside the streamed recurrences
where the plan is another, in turns, and cuDNN and the f32 and
tensor-core bounds, each plan printed with its register/shared split and
residency, the backward by pass, the grid-resident kernels at U=1024
also replayed from a CUDA graph, then SS5 with a 384-unit DOA biGRU
graphed at B=256 (ms a step, windows/s, the GRU kernels' share;
--gru-wide all runs gru_wide alone,
--gru-wide step its SS5 step alone, neither with a result line)
(phase 14 adds f32 B=256 at every NAS unit count, 4 to 256, both GRU
kernels, and stem_dy in f32),
printing each call's tile plan, and times every plan at the serving and
training shapes and U=256 at B=256 bf16, and at the stream head's batches
B in {10, 14, 40, 56} (f32 and bf16, beside cuDNN's f32 GRU); gru_scan_bwd
the same way at B in
{1, 3, 32, 256} (U=128, f32 and bf16), U=64, U=144, U in {192, 256} and
U in {100, 152, 208} (blocks with padding lanes), with its device time by
kernel (torch.profiler) and every plan at B=256 and B=64. stem_dy: the
layout of the cotangent the training step hands it (a tensor hook on the
stem's pooled output), every pool of STEM_CASES on data with ties against
stem_dy_ref, and at the training shape its time beside a bytes yardstick.
It also holds
the two feed kernels against their plain versions: foa_frontend at one
chunk of 8 synthetic 60-s clips and at a stream's three segment shapes
(a push's [1, 4, 25,920] samples, the tail, a 1-s short clip), each
(beside torch.fft.rfft over the same
windowed frames, the FFT stage alone), gather_rows at B=256 rows of [300,
64, 7] (bf16, f32) from 4,000 staged windows, of their labels [60, 48]
f32, of 30-byte rows, and as the x+y pairs the feed launches, also
at the f32 rows of a TDM split and the 10- and 17-channel bf16 rows of
the mic and joint inputs. Device-only
times come from a CUDA graph of the calls (graph_ms), beside the time per
call; the build prints each kernel's registers and spills.
With --kernels-only it stops after phase 3, with no result line; it also
prints stem_dy.cu's static SASS instruction counts (cuobjdump).
Then a JSON line {"kernels": [...]}, the nvidia-smi line, and as the last
line {"ok": true, "device": {...}}. Any failed phase raises: the exit code
is non-zero and no result line is printed. Without a CUDA card, or run
from a directory that holds this file and nothing else of the repository,
it fails the same way.
"""
import contextlib
import copy
import json
import math
import os
import subprocess
import sys
import signal
import tempfile
import threading
import time
import weakref
from concurrent.futures import ThreadPoolExecutor

import numpy as np

H100_BYTES_PER_S = 3.35e12   # HBM3, SXM data sheet
H100_F32_FLOPS = 67e12       # f32 outside the tensor cores, SXM data sheet
H100_BF16_FLOPS = 989e12     # bf16 on the tensor cores, dense, SXM data sheet

GRU_TOL = {"float32": 1e-4,
           # both sides carry h in f32 and round once to bf16: at most one
           # bf16 ulp (2^-8 for |h| < 1) apart
           "bfloat16": 2.0 ** -7}
MODEL_TOL = 1e-4      # f32, TF32 off: cuDNN/cuBLAS vs CPU summation order
REPLY_TOL = 1e-4      # a reply's rows ran in a padded batch of another size
# Backward kernels, as a share of the largest |value| of the plain version's
# output: f32 sums in another order (1e-5); a bf16 output is one rounding of
# an f32 value on both sides, so they may sit one bf16 ulp apart (2^-7 of
# the value). Every reduced output (dRk, dRb, dbias) is f32 on both sides.
BWD_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
# train phase (a), f32 with TF32 off, card against CPU through the plain
# versions: losses and running statistics to 1e-5 relative; each gradient
# to 1e-3 of its largest |element| (deep reductions in another order, and
# a pool window whose two largest values lie within rounding may route its
# gradient to the other one); the updated parameters to 1e-6 where the
# gradient stands clear of that noise — AdaBelief's first step moves every
# element by about 1.1 lr whatever its size, so an element whose gradient
# sign is noise may move the other way — and to 2.3 lr everywhere.
# Some gradients are zero in exact arithmetic: the bias of a conv that
# feeds a train-mode BatchNorm (the batch mean absorbs it) and attention's
# key bias (softmax ignores a shift shared by all keys). Their elements are
# rounding noise on both sides, so they are held, card and CPU alike, below
# TRAIN_NULL_GRAD of the step's largest gradient element instead of to a
# share of themselves.
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_RTOL = 1e-3
TRAIN_NULL_GRAD = 1e-6
TRAIN_PARAM_ATOL = 1e-6
TRAIN_STATS_RTOL = 1e-5
TRAIN_STEPS = 20
# the kernels whose launches every phase checks exactly; batch_norm's
# passes follow a model's train-mode BatchNorms (4 a BatchNorm and 1 a
# fused stem a step) and are checked exactly where the model is SS5: 7
# BatchNorms (4 in the mother stage, 3 in the dense stage) and the stem;
# SS5 feeds no BatchNorm to a pool, so it launches no batch_norm_pool
COUNTED = ("gru_scan", "gru_scan_bwd", "stem_dy", "foa_frontend",
           "gather_rows")
SS5_BN_LAUNCHES = 4 * 7 + 1
SS5_COUNTED = COUNTED + ("batch_norm", "batch_norm_pool")
# batch_norm_pool launches a train step: 3 for each BatchNorm -> ReLU ->
# max pool of the zoo's conv stacks (SELDnet's three blocks; pass 1 stays
# batch_norm's)
ZOO_POOL_LAUNCHES = {"seldnet": 9, "seldnet_v1": 9, "Condseldnet": 9}
# [graph]: make_train_multistep(k=GRAPH_STEPS) against k eager steps from
# the same seed, bf16, cuDNN's deterministic algorithms in both: the graph
# replays the kernels the eager step launches, on the same values, with
# the dropout masks drawn at the generator's offset of each replay, so the
# two agree to rounding of the same sums (losses 1e-5 relative, parameters
# and running statistics 1e-6 absolute). A replay that reused the masks
# of the capture moves parameters by ~lr = 1e-3. The metric: one folded
# update against k updates sums the same counts in another order (1e-5).
GRAPH_STEPS = 8
GRAPH_CALLS = 2          # timed calls of k steps a run
GRAPH_LOSS_RTOL = 1e-5
GRAPH_STATE_ATOL = 1e-6
GRAPH_METRIC_RTOL = 1e-5
# [train] (c): the fused single step's calls checked against unfused steps
# (GRAPH_*'s tolerances), then timed steps of each in turns
FUSED_CALLS = 3
FUSED_TIMED = 10
# foa_frontend against its plain version, f32 with TF32 off, on the dB and
# IV channels: the 1024-term DFT sums run in another order, and the dB step
# and the IV normalisation amplify relative error where energy is low
FRONTEND_TOL = 1e-3
FEED_CLIPS = {1: 4, 2: 4, 3: 4, 4: 4, 5: 2, 6: 2}   # fold -> clips
FEED_SECONDS = 60
FEED_ARGV = ["--model", "conv_temporal", "--model_config",
             "SS5", "--doa_loss", "MMSE", "--from_wav", "--device_data",
             "--bf16", "--use_tfm", "--use_acs", "--agc", "true", "--batch",
             "64", "--loop_time", "5", "--epoch", "2", "--swa_start", "1",
             "--swa_freq", "1", "--eval_every", "0"]
# [clip]: 60-s DCASE clips at win 300 / step 5 (541 windows), the exact path
# in make_answer's chunks of 512 windows. The card against the CPU, f32
# with TF32 off: serving's tolerance (MODEL_TOL). Where the fast path must
# equal the exact one (a one-window clip; the trunk's frames farther than
# its receptive field from a window's edge, CLIP_INTERIOR trunk frames) and
# clip_batch=4 against clip-at-a-time, the card against itself: the same
# tolerance, the library kernels choosing their algorithms by batch size.
# Weight-only int8 (per-channel error up to amax/254) and bf16 weights and
# activations (8 mantissa bits through ~40 layers) against f32 on the
# sigmoid/tanh outputs: INT8_TOL and BF16_TOL, absolute.
CLIP_FRAMES = 3000
CLIP_COUNT = 4
CLIP_BATCH = 512
CLIP_INTERIOR = 10
INT8_TOL = 5e-2
BF16_TOL = 5e-2
# [stream]: 60-s clips pushed 1 s (50 feature frames) at a time, SS5 full
# width, f32 with TF32 off. The stream against the fast path on the card
# and the card's stream against the CPU's: MODEL_TOL (the trunk runs on
# 90-frame buffers in the stream and over the whole clip in the fast path,
# so cuDNN picks other algorithms). The head's GRUs run at B = 10 a stream
# (bootstrap, each push) and 14 (finalize: chunk + halo windows).
STREAM_SECONDS = 60
STREAM_PUSH = 50
STREAM_CHECK_SECONDS = 15
STREAM_N = 4
STREAM_GRU_BATCHES = (10, 14, 40, 56)
STREAM_REPS = 2
# [nas]: the search at its full input (300, 64, 7), f32, TF32 off.
# (a) each GRU kernel at D=2, T=60, B=256 in f32 at every unit count of the
# search space that the kernels take (GRU_TOL / BWD_TOL); (b) one fixed
# candidate (NAS_CONFIG: a draw of the default sampler at random.seed(1)
# in the 400-480 MFLOP window, its dense dropout set to 0) trained and
# scored on the card against the CPU on the same weights and batches
# (NAS_B x NAS_STEPS steps, NAS_EVAL_CLIPS eval clips), both proxies:
# losses to 1e-4 relative; ER, F and DE_F to NAS_COUNT_ATOL = 1e-2 (one
# thresholded SED decision that lands on the other side moves ER by
# 1 / Nref); DE to NAS_DE_ATOL = 0.5 degrees and the seld values to
# NAS_COUNT_ATOL (arccos of a dot product near +-1 and a flipped decision);
# (c) the command line on a synthesized feat_label tree (NAS_TRAIN_CLIPS
# train clips, NAS_TEST_CLIPS test clips of 600 label frames), B=256,
# --n_repeat NAS_REPEAT, --device_data --proxy trainer, NAS_SAMPLES
# candidates then one more; (d) run_parallel, 2 workers on the one card,
# against the serial run, both with cuDNN's deterministic algorithms: the
# configs equal, the losses to NAS_PARALLEL_RTOL = 1e-6 relative. Without
# them two serial runs differ (a serial run with the default algorithms is
# printed beside them):
# cuDNN's convolution backward sums in a run-dependent order, and Adam's
# and AdaBelief's first steps move an element by ~lr whatever its
# gradient's size, so a noise-level gradient whose sign flips moves it the
# other way.
NAS_CONFIG = {
    "n_classes": 12, "first_pool_size": [5, 2],
    "BLOCK0": "mother_stage",
    "BLOCK0_ARGS": {"depth": 2, "filters0": 48, "filters1": 24,
                    "filters2": 6, "kernel_size0": 1, "kernel_size1": 5,
                    "kernel_size2": 3, "connect0": [1], "connect1": [0, 1],
                    "connect2": [1, 1, 0], "strides": [1, 3]},
    "BLOCK1": "bidirectional_GRU_stage",
    "BLOCK1_ARGS": {"depth": 1, "units": 64},
    "BLOCK2": "simple_dense_stage",
    "BLOCK2_ARGS": {"depth": 3, "units": 4, "dense_activation": "relu",
                    "dropout_rate": 0.0},
    "BLOCK3": "bidirectional_GRU_stage",
    "BLOCK3_ARGS": {"depth": 2, "units": 12},
    "SED": "bidirectional_GRU_stage", "SED_ARGS": {"depth": 2, "units": 8},
    "DOA": "bidirectional_GRU_stage", "DOA_ARGS": {"depth": 2, "units": 16}}
NAS_B = 16
NAS_STEPS = 2
NAS_EVAL_CLIPS = 2
NAS_LOSS_RTOL = 1e-4
NAS_COUNT_ATOL = 1e-2
NAS_DE_ATOL = 0.5
NAS_TRAIN_CLIPS = 32
NAS_TEST_CLIPS = 2
NAS_REPEAT = 4
NAS_SAMPLES = 3
NAS_PARALLEL_SAMPLES = 4
NAS_PARALLEL_RTOL = 1e-6
# [vad]: the VAD rehearsal on the card (VAD_ARGV), both VAD models'
# forwards at B=256 card against CPU (VAD_OUT_ATOL, f32, TF32 off), one
# attention-model train step card against CPU as [train] (a) holds SS5's
# (loss to 1e-5 relative; gradients to TRAIN_GRAD_RTOL of their largest
# element, a leaf below VAD_NULL_GRAD of the step's largest element being
# zero in exact arithmetic; parameters to VAD_PARAM_ATOL = 1% of lr where
# the gradient is clear: at B=256 a clear element's gradient may differ by
# ~2e-4 of its leaf's largest, which near AdaBelief's knee (|g| of a few
# 1e-6) moves its first step by up to ~1e-6 (measured 9.2e-7); else to
# AdaBelief's first step, 2.3 lr), and the VAD search for two samples on
# the rehearsal's npz
VAD_ARGV = ["--clips", "64", "--val_clips", "8", "--seconds", "8",
            "--epochs", "16", "--batch", "256", "--device", "cuda"]
VAD_OUT_ATOL = 1e-5
VAD_PARAM_ATOL = 1e-5
VAD_NULL_GRAD = 1e-5
# [zoo]: the model zoo's nine configs (seld_tpu_torch.bench.ZOO_MODELS and
# zoo_model: tests/test_models.py's model for each, resnet_gru through
# conv_temporal with first_pool_size [5, 1]) at full width (300, 64, 7),
# seeded weights, 12 classes (the DCASE2021 class weights).
# (a) eval forward at B=ZOO_FWD_B, f32, TF32 off, card against CPU:
# MODEL_TOL absolute on sed/doa, for every config (the convs and products
# sum in another order; eval BatchNorm is affine, so depth adds no
# amplification); (b) one f32 step at B=ZOO_STEP_B card against CPU by
# [train] (a)'s rule (_step_agreement); (c) ZOO_STEPS bf16 steps at
# B=ZOO_TRAIN_B eager, then one make_train_multistep(ZOO_STEPS) call
# (warm-up and capture) and one timed call of replays, with exact
# launches (every family fits at B=256: dense_gru's peak is 60.2 GiB
# allocated); (d) stem_dy at conv_temp's [256, 300, 64, 32] bf16, pool
# [5, 1], against stem_dy_ref (BWD_TOL); (e) ZOO_SERVE as window
# artifacts behind the server, replies against the direct call (REPLY_TOL)
ZOO_FWD_B = 4
# seeded weights and unit running variances leave some families' heads
# saturated in eval mode (dense_gru's doa: std 0.000 on B=4), so (a) also
# holds the input of the first biGRU (the conv body's output) to
# ZOO_BODY_RTOL of its largest |value|
ZOO_BODY_RTOL = 1e-4
ZOO_STEP_B = 2
# (b) replays the CPU step's ReLU decisions on the card (relu_decisions):
# a ReLU input within rounding of zero otherwise moves the gradients
# upstream of it by up to 1e-1 of their leaves' largest elements. Its null
# leaves come from the forward's structure (null_leaves): at B=2 and full
# width the rounding noise of a null gradient reaches 4.1e-5 of the
# step's largest element (dense_gru's stem bias, CPU f32), where true
# gradients also lie (its sed_out kernel's largest, 3.4e-5), so no
# threshold tells them apart. ZOO_NULL_GRAD of the step's largest element
# is that rounding floor: a null leaf stays below it on the card, and
# every other gradient agrees to TRAIN_GRAD_RTOL of its leaf's largest
# element plus it (a BatchNorm scale or a CondConv expert bias whose sum
# cancels to 1e-4-1e-6 of the step's largest element carries rounding of
# 1e-7-1e-6 of it: 1e-3-2e-2 of its own largest; CPU f32 with replayed
# decisions against f64 stays within 0.28 of this tolerance)
ZOO_NULL_GRAD = 1e-4
# (b)'s updated parameters: the card's against the CPU optimizer's first
# step taken from the card's own gradients, to TRAIN_PARAM_ATOL on every
# element. AGC scales a clipped unit to 0.01 of its weights' norm, which
# puts many elements at AdaBelief's knee (|g| of a few 1e-6), where the
# first step moves by ~300 x a gradient's difference: gradients that agree
# to the rule above left resnet_gru's clear elements 3.2e-5 apart.
ZOO_TRAIN_B = 256
ZOO_STEPS = 10
ZOO_SERVE = ("seldnet", "xception_gru")
# [blocks]: path A, accdoa on SS5's config, and path B, SS5 with BLOCK2
# swapped for each 1-D block at SS5's conformer widths
# (seld_tpu_torch.bench.BLOCK_ROWS), full width (300, 64, 7), seeded
# weights, 12 classes. (a) eval forward at B=BLOCKS_FWD_B, f32, TF32 off,
# card against CPU: sed/doa to MODEL_TOL and the swapped block's output
# to ZOO_BODY_RTOL of its largest |value|; (b) one f32 step at
# B=BLOCKS_STEP_B card against CPU by [zoo] (b)'s rule (the CPU's ReLU
# decisions replayed, null leaves from the forward, the update against the
# CPU optimizer's step on the card's gradients), dropouts zeroed but
# rnn_gru_dropout's RNN_stage, whose recurrent and input dropout draw the
# same numpy keep masks on both sides; (c) BLOCKS_STEPS bf16
# steps at B=256 eager, then one make_train_multistep(BLOCKS_STEPS) call
# (warm-up, capture) and a timed call of replays, the rows' dropout rates
# on (rnn_gru_dropout's recurrent dropout takes the masked route, no
# kernel), exact launches: stem_dy 1 a step, gru_scan and gru_scan_bwd 2
# (SS5's DOA biGRU) + 2 (rnn_gru's RNN_stage) a step, accdoa 0; (d)
# --model accdoa through the training CLI on [feed]'s seeded wav tree,
# --epoch_scan, 2 epochs and a resume, sedLoss 0.0 on every history line,
# exact launches of all five kernels
BLOCKS_FWD_B = 4
BLOCKS_STEP_B = 2
BLOCKS_STEPS = 10
BLOCKS_FEED_ARGV = ["--model", "accdoa", "--model_config", "SS5",
                    "--doa_loss", "MSE", "--from_wav", "--device_data",
                    "--bf16", "--batch", "64", "--loop_time", "5",
                    "--epoch", "2", "--swa_start", "1", "--swa_freq", "1",
                    "--eval_every", "0"]
# [answer]: the dress rehearsal at rehearsal scale (4 train, 2 + 2 eval
# clips of 120 label frames, 5 epochs with SWA from epoch 2 and the
# ensemble evaluation every 2)
ANSWER_ARGV = ["--clips", "4", "--eval_clips", "2", "--batch", "8",
               "--epoch", "5", "--swa_start", "2", "--swa_freq", "1",
               "--eval_every", "2", "--device", "cuda"]
# [feed] runs the CLI (and its resume) once per variant, each under a run
# name of its own
FEED_VARIANTS = (("eager", ["--name", "smoke"]),
                 ("epoch_scan", ["--name", "smoke_scan", "--epoch_scan"]),
                 ("epoch_scan+fuse_metrics", ["--name", "smoke_fused",
                                              "--epoch_scan",
                                              "--fuse_metrics"]))


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, iters):
    import torch
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def _cudnn_gru(x_proj, rec_kernel, rec_bias):
    """torch.nn.GRU (cuDNN) computing gru_scan's function, and its f32
    input: x_proj of both directions side by side, where each direction's
    input weights select its own block, permuted z|r|h -> r|z|n."""
    import torch
    d, t, b, k = x_proj.shape
    u = k // 3
    perm = torch.cat([torch.arange(u, 2 * u), torch.arange(u),
                      torch.arange(2 * u, 3 * u)])
    gru = torch.nn.GRU(d * k, u, bidirectional=d == 2).to(x_proj.device)
    with torch.no_grad():
        for di in range(d):
            sfx = "_reverse" if di else ""
            w_ih = torch.zeros(k, d * k, device=x_proj.device)
            w_ih[torch.arange(k), di * k + perm.to(x_proj.device)] = 1.0
            getattr(gru, f"weight_ih_l0{sfx}").copy_(w_ih)
            getattr(gru, f"bias_ih_l0{sfx}").zero_()
            getattr(gru, f"weight_hh_l0{sfx}").copy_(rec_kernel[di][:, perm].T)
            getattr(gru, f"bias_hh_l0{sfx}").copy_(rec_bias[di][perm])
    inp = torch.cat(list(x_proj.float()), dim=-1)        # [T, B, D*3U]
    return gru, inp


def cudnn_gru(x_proj, rec_kernel, rec_bias):
    """One no-grad cuDNN GRU forward on gru_scan's function, f32."""
    import torch
    gru, inp = _cudnn_gru(x_proj, rec_kernel, rec_bias)

    def run():
        with torch.no_grad():
            return gru(inp)[0]
    return run


def _plan_text(plan):
    return f"plan Bt={plan.bt} C={plan.c} CTAs={plan.ctas}"


def _plan_json(plan):
    return {"bt": plan.bt, "c": plan.c, "ctas": plan.ctas}


def _gru_inputs(rng, d, t, b, u, dtype):
    import torch
    xp = torch.from_numpy(rng.randn(d, t, b, 3 * u).astype(
        np.float32)).cuda().to(getattr(torch, dtype))
    rk = torch.from_numpy((rng.randn(d, u, 3 * u) / math.sqrt(u))
                          .astype(np.float32)).cuda()
    rb = torch.from_numpy(0.1 * rng.randn(d, 3 * u).astype(np.float32)).cuda()
    return xp, rk, rb


def phase_kernels(card):
    import torch
    from seld_tpu_torch.ops.gru import (_FWD_RESIDENT, _FWD_VARIANTS,
                                        _RESIDENT_UNITS, _STREAM, _fwd_plan,
                                        _gru_scan_cuda, gru_scan,
                                        gru_scan_ref, library_variants)

    mirror = (_FWD_VARIANTS, _STREAM, (_FWD_RESIDENT, _RESIDENT_UNITS))
    if library_variants() != mirror:
        raise SystemExit(f"csrc/gru_fwd.cu's variants {library_variants()} "
                         f"differ from ops/gru.py's {mirror}")
    rng = np.random.RandomState(0)
    d, t = 2, 60
    worst = {"float32": 0.0, "bfloat16": 0.0}
    cases = [(dtype, b, 128) for dtype in ("float32", "bfloat16")
             for b in (1, 3, 17, 32, 256)]
    cases += [("float32", 17, 64), ("bfloat16", 17, 64)]
    # the widest variant, also with padding lanes (U = 152: 19 units a CTA)
    cases += [(dtype, b, u) for u in (192, 256)
              for dtype in ("float32", "bfloat16") for b in (3, 32, 256)]
    cases += [("float32", 17, 152), ("bfloat16", 256, 152)]
    for dtype, b, u in cases:
        xp, rk, rb = _gru_inputs(rng, d, t, b, u, dtype)
        hs = gru_scan(xp, rk, rb)
        torch.cuda.synchronize()
        ref = gru_scan_ref(xp, rk, rb)
        err = (hs.float() - ref.float()).abs().max().item()
        ok = hs.shape == ref.shape and hs.dtype == xp.dtype and \
            err <= GRU_TOL[dtype]
        ms = cuda_ms(lambda: gru_scan(xp, rk, rb), 50)
        log("kernels", f"gru_scan {dtype} B={b} U={u}: max_abs_err "
                       f"{err:.3e} (tol {GRU_TOL[dtype]:.1e}) "
                       f"{'ok' if ok else 'FAIL'}, kernel_ms {ms:.4f}, "
                       f"{_plan_text(_fwd_plan(d, b, u))}")
        if not ok:
            raise SystemExit(f"gru_scan disagrees with gru_scan_ref at "
                             f"{dtype} B={b} U={u}")
        worst[dtype] = max(worst[dtype], err)
        if (dtype, b, u) == ("float32", 32, 128):
            timing = (xp, rk, rb, hs)
        if (dtype, b, u) == ("bfloat16", 256, 128):
            train_args = (xp, rk, rb)
        if (dtype, b, u) == ("bfloat16", 256, 256):
            wide_args = (xp, rk, rb)

    # the serving path's shape: SS5 biGRU-128, T=60, a B=32 bucket, f32
    xp, rk, rb, hs = timing
    u = xp.shape[-1] // 3
    plan = _fwd_plan(xp.shape[0], xp.shape[2], u)
    lib = cudnn_gru(xp, rk, rb)
    lib_out = lib()
    lib_err = max((lib_out[..., :u] - hs[0]).abs().max().item(),
                  (lib_out[..., u:] - hs[1]).abs().max().item())
    if lib_err > GRU_TOL["float32"]:
        raise SystemExit(f"cuDNN GRU disagrees with gru_scan: {lib_err:.3e}")
    ms = cuda_ms(lambda: gru_scan(xp, rk, rb), 200)
    device_ms = graph_ms(lambda: gru_scan(xp, rk, rb), 50)
    plain_ms = cuda_ms(lambda: gru_scan_ref(xp, rk, rb), 10)
    library_ms = cuda_ms(lib, 200)
    bound_ms, bound_by = gru_scan_bound(xp, rk, rb)
    log("kernels", f"gru_scan f32 D=2 T=60 B=32 U=128 on {card}: "
                   f"kernel_ms {ms:.4f} (device ms {device_ms:.4f}; "
                   f"{_plan_text(plan)}) plain_ms "
                   f"{plain_ms:.4f} library_ms (cuDNN GRU) {library_ms:.4f} "
                   f"bound_ms {bound_ms:.5f}; cuDNN vs kernel {lib_err:.2e}")
    # and at the training path's shape, B=256 bf16, beside cuDNN's training
    # forward in bf16
    xp, rk, rb = train_args
    train_plan = _fwd_plan(xp.shape[0], xp.shape[2], u)
    train_ms = cuda_ms(lambda: gru_scan(xp, rk, rb), 50)
    train_device_ms = graph_ms(lambda: gru_scan(xp, rk, rb), 50)
    train_bound_ms, train_bound_by = gru_scan_bound(xp, rk, rb)
    g = torch.zeros(xp.shape[:3] + (u,), dtype=xp.dtype, device="cuda")
    lib_fwd, _ = cudnn_gru_train(xp, rk, rb, g)
    train_library_ms = cuda_ms(lib_fwd, 50)
    log("kernels", f"gru_scan bf16 D=2 T=60 B=256 U=128 (training shape): "
                   f"kernel_ms {train_ms:.4f} (device ms "
                   f"{train_device_ms:.4f}; {_plan_text(train_plan)}) "
                   f"library_ms (cuDNN GRU training forward, bf16) "
                   f"{train_library_ms:.4f} bound_ms {train_bound_ms:.5f} "
                   f"({train_bound_by})")
    # U=256, B=256 bf16: the widest variant against its bound
    wide_ms = cuda_ms(lambda: gru_scan(*wide_args), 50)
    wide_device_ms = graph_ms(lambda: gru_scan(*wide_args), 50)
    wide_bound_ms, wide_bound_by = gru_scan_bound(*wide_args)
    wide_plan = _fwd_plan(2, 256, 256)
    log("kernels", f"gru_scan bf16 D=2 T=60 B=256 U=256: kernel_ms "
                   f"{wide_ms:.4f} (device ms {wide_device_ms:.4f}; "
                   f"{_plan_text(wide_plan)}) bound_ms {wide_bound_ms:.5f} "
                   f"({wide_bound_by})")
    # every plan that takes U=128 at both shapes, each held against the
    # plain version, for the choice above
    for name, args in (("B=32 f32", timing[:3]), ("B=256 bf16", train_args)):
        ref = gru_scan_ref(*args).float()
        tol = GRU_TOL[str(args[0].dtype).split(".")[-1]]
        times = []
        for v in range(len(_FWD_VARIANTS)):
            p = _fwd_plan(args[0].shape[0], args[0].shape[2], u, variant=v)
            err = (_gru_scan_cuda(*args, plan=p).float() - ref).abs().max()
            if err.item() > tol:
                raise SystemExit(f"gru_scan variant {v} disagrees with "
                                 f"gru_scan_ref at {name}: {err.item():.3e}")
            v_ms = cuda_ms(lambda: _gru_scan_cuda(*args, plan=p), 50)
            times.append(f"variant {v} {_FWD_VARIANTS[v]} {_plan_text(p)}: "
                         f"{v_ms:.4f} ms (err {err.item():.1e})")
        log("kernels", f"gru_scan plans at {name}: " + "; ".join(times))
    # the stream head's batches: B = 10 a stream (bootstrap, each push),
    # 14 (finalize), and both at 4 lockstep streams
    stream_shapes = {f"{dtype}_B{b}": _stream_gru(rng, b, dtype, card)
                     for dtype in ("float32", "bfloat16")
                     for b in STREAM_GRU_BATCHES}
    return {"name": "gru_scan", "route": "cuda",
            "source": "seld_tpu_torch/csrc/gru_fwd.cu",
            "replaces": "seld_tpu/ops/pallas/gru.py:170",
            "launches": None, "max_abs_err": worst["float32"],
            "max_abs_err_bf16": worst["bfloat16"],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "device_ms": device_ms, "plan": _plan_json(plan),
            "train_shape_ms": train_ms,
            "train_shape_device_ms": train_device_ms,
            "train_shape_library_ms": train_library_ms,
            "train_shape_bound_ms": train_bound_ms,
            "train_shape_bound_by": train_bound_by,
            "train_shape_plan": _plan_json(train_plan),
            "u256_ms": wide_ms, "u256_device_ms": wide_device_ms,
            "u256_bound_ms": wide_bound_ms, "u256_bound_by": wide_bound_by,
            "u256_plan": _plan_json(wide_plan),
            "stream_shapes": stream_shapes}


def gru_scan_bound(xp, rk, rb):
    """gru_scan's bound: x_proj read and hs written in x_proj's dtype, the
    f32 weights read; the recurrent product and the gates' arithmetic."""
    d, t, b, k = xp.shape
    u = k // 3
    hs_numel = d * t * b * u
    nbytes = ((xp.numel() + hs_numel) * xp.element_size() + rk.numel() * 4
              + rb.numel() * 4)
    flops = 2 * d * t * b * u * 3 * u + 10 * d * t * b * u   # product + gates
    return bound(nbytes, flops)


def _bwd_bytes(xp, rk, rb, hs, g):
    """x_proj, hs and g read and dx_proj written in x_proj's dtype, the
    weights read and their gradients written in their own."""
    return ((xp.numel() * 2 + hs.numel() + g.numel()) * xp.element_size()
            + (rk.numel() * rk.element_size() + rb.numel() * 4) * 2)


def gru_bwd_bound(xp, rk, rb, hs, g):
    """gru_scan_bwd's bound: its bytes (`_bwd_bytes`); the three B x U x 3U
    products a step and direction at the f32 rate outside the tensor
    cores."""
    d, t, b, k = xp.shape
    u = k // 3
    return bound(_bwd_bytes(xp, rk, rb, hs, g), 3 * 2 * d * t * b * u * 3 * u)


def _split_products(a_dtype, b_dtype):
    """bf16 products a split product takes (csrc/gru_bwd.cu): 1 for bf16 x
    bf16, 3 with one side f32 (three parts), 6 with both."""
    import torch
    pa, pb = (1 if dt == torch.bfloat16 else 3 for dt in (a_dtype, b_dtype))
    return pa * pb if min(pa, pb) == 1 else 6


def gru_bwd_bound_tc(xp, rk, rb, hs, g, grid=False):
    """gru_scan_bwd's bound at the rates of the scheme its kernels run: the
    hp and dRk products as `_split_products` bf16 products at 989 TFLOP/s
    on the tensor cores; the recurrence's product in f32 outside them (67
    TFLOP/s), or, on the grid-resident plan, as 3 bf16 products; bytes as
    `gru_bwd_bound`. Operations add up: the passes run one after another."""
    import torch
    d, t, b, k = xp.shape
    u = k // 3
    prod = 2 * d * t * b * u * 3 * u
    tc = _split_products(hs.dtype, rk.dtype) + \
        _split_products(hs.dtype, torch.float32) + (3 if grid else 0)
    ops_ms = prod * tc / H100_BF16_FLOPS * 1e3 + \
        (0.0 if grid else prod / H100_F32_FLOPS * 1e3)
    bytes_ms = _bwd_bytes(xp, rk, rb, hs, g) / H100_BYTES_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms > ops_ms
                                   else "operations")


def gru_scan_bound_tc(xp, rk, rb, grid=False):
    """gru_scan's bound at its scheme's rate: on the grid-resident plan the
    product as `_GRID_H_PARTS` bf16 products at 989 TFLOP/s; on the others
    in f32 (gru_scan_bound)."""
    from seld_tpu_torch.ops.gru import _GRID_H_PARTS
    if not grid:
        return gru_scan_bound(xp, rk, rb)
    d, t, b, k = xp.shape
    u = k // 3
    nbytes = ((xp.numel() + d * t * b * u) * xp.element_size()
              + rk.numel() * rk.element_size() + rb.numel() * 4)
    ops_ms = 2 * d * t * b * u * 3 * u * _GRID_H_PARTS / \
        H100_BF16_FLOPS * 1e3
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms > ops_ms
                                   else "operations")


def bound(nbytes, flops):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    f32 operations over the f32 rate outside the tensor cores."""
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    ops_ms = flops / H100_F32_FLOPS * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms > ops_ms
                                   else "operations")


def kernel_split_ms(fn, n, prefix):
    """Device ms per call of fn by kernel, for the kernels whose name
    starts with `prefix`, from torch.profiler's CUDA events over n calls;
    None if the profiler recorded no device time."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
    except RuntimeError as e:          # a machine without CUPTI
        log("kernels", f"torch.profiler failed: {e}")
        return None
    out = {}
    for avg in prof.key_averages():
        if avg.device_type != DeviceType.CUDA:
            continue
        m = re.search(r"\b(" + prefix + r"\w*)", avg.key)
        us = getattr(avg, "self_device_time_total", None)
        us = avg.self_cuda_time_total if us is None else us
        if m and us > 0:
            out[m.group(1)] = out.get(m.group(1), 0.0) + us / 1e3 / n
    return out or None


def _split_text(split):
    if not split:
        return "not measured (no device time in the trace)"
    return ", ".join(f"{k} {v:.4f}" for k, v in split.items()) + \
        f"; sum {sum(split.values()):.4f}"


def rel_err(got, want):
    """max |got - want| as a share of max |want|."""
    want = want.float()
    return ((got.float() - want).abs().max()
            / want.abs().max().clamp_min(1e-30)).item()


def cudnn_gru_train(x_proj, rec_kernel, rec_bias, g):
    """cuDNN's GRU on gru_scan's function in x_proj's dtype: (training
    forward, training forward + backward for the cotangent g); the
    backward's time is their difference. cuDNN also computes the identity
    input weights' gradient."""
    import torch
    import warnings

    import torch.backends.cudnn.rnn as cudnn_rnn
    gru, inp = _cudnn_gru(x_proj, rec_kernel, rec_bias)
    gru = gru.to(x_proj.dtype)
    # else cuDNN compacts the weights every call; flatten_parameters() skips
    # bf16 (torch.backends.cudnn.is_acceptable takes f16/f32/f64 only), so
    # its flattening call is made directly
    with torch.no_grad():
        torch._cudnn_rnn_flatten_weight(
            gru._flat_weights, 4, gru.input_size,
            cudnn_rnn.get_cudnn_mode(gru.mode), gru.hidden_size,
            gru.proj_size, gru.num_layers, gru.batch_first,
            bool(gru.bidirectional))
    inp = inp.to(x_proj.dtype).requires_grad_()
    gout = torch.cat(list(g), dim=-1)                    # [T, B, D*U]

    def fwd():
        return gru(inp)[0]

    def fwd_bwd():
        gru(inp)[0].backward(gout)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fwd_bwd()
    flat = not any("contiguous chunk" in str(w.message) for w in caught)
    log("kernels", f"cuDNN GRU {x_proj.dtype} training weights in one "
                   f"flat buffer: {flat}" + ("" if flat else " (cuDNN "
                   "compacts them every call; its times include that)"))
    return fwd, fwd_bwd


def phase_kernels_bwd(card):
    import torch
    from seld_tpu_torch.ops.gru import (_BWD_GRID, _BWD_RESIDENT,
                                        _BWD_VARIANTS, _FWD_GRID, _GRID_BWD,
                                        _GRID_FWD, _RESIDENT_UNITS, _STREAM,
                                        _bwd_plan, _gru_scan_bwd_cuda,
                                        gru_scan_bwd, gru_scan_bwd_ref,
                                        gru_scan_ref, library_bwd_variants,
                                        library_grid)

    mirror = (_BWD_VARIANTS, _STREAM, (_BWD_RESIDENT, _RESIDENT_UNITS))
    if library_bwd_variants() != mirror:
        raise SystemExit(f"csrc/gru_bwd.cu's variants "
                         f"{library_bwd_variants()} differ from ops/gru.py's "
                         f"{mirror}")
    grid = (_GRID_FWD + (_FWD_GRID,), _GRID_BWD + (_BWD_GRID,))
    if library_grid() != grid:
        raise SystemExit(f"the grid-resident constants {library_grid()} "
                         f"differ from ops/gru.py's {grid}")
    rng = np.random.RandomState(4)
    d, t = 2, 60
    worst = {"float32": 0.0, "bfloat16": 0.0}
    timing = None
    cases = [(dtype, b, 128) for dtype in ("float32", "bfloat16")
             for b in (1, 3, 32, 256)]
    cases += [("float32", 17, 64), ("bfloat16", 64, 144)]
    # the widest variant, and blocks with padding lanes (U = 100 and 152 on
    # the wide variant, 208 on the widest)
    cases += [(dtype, b, u) for u in (192, 256)
              for dtype in ("float32", "bfloat16") for b in (3, 32, 256)]
    cases += [("float32", 17, 100), ("bfloat16", 256, 100),
              ("float32", 17, 152), ("bfloat16", 32, 208)]
    wide = None
    for dtype, b, u in cases:
        dt = getattr(torch, dtype)
        xp = torch.from_numpy(rng.randn(d, t, b, 3 * u).astype(
            np.float32)).cuda().to(dt)
        rk = torch.from_numpy((rng.randn(d, u, 3 * u) / math.sqrt(u))
                              .astype(np.float32)).cuda()
        rb = torch.from_numpy(0.1 * rng.randn(d, 3 * u).astype(
            np.float32)).cuda()
        hs = gru_scan_ref(xp, rk, rb)
        g = torch.from_numpy(rng.randn(d, t, b, u).astype(
            np.float32)).cuda().to(dt)
        got = gru_scan_bwd(xp, rk, rb, hs, g)
        torch.cuda.synchronize()
        want = gru_scan_bwd_ref(xp, rk, rb, hs, g)
        errs = [rel_err(a, w) for a, w in zip(got, want)]
        tols = [BWD_TOL[dtype], BWD_TOL["float32"], BWD_TOL["float32"]]
        ok = all(e <= tl for e, tl in zip(errs, tols)) and \
            got[0].dtype == dt
        log("kernels", f"gru_scan_bwd {dtype} B={b} U={u}: rel_err "
                       f"dx_proj {errs[0]:.2e} dRk {errs[1]:.2e} dRb "
                       f"{errs[2]:.2e} (tol {tols[0]:.1e}/"
                       f"{tols[1]:.0e}) {'ok' if ok else 'FAIL'}, "
                       f"{_plan_text(_bwd_plan(d, b, u))}")
        if not ok:
            raise SystemExit(f"gru_scan_bwd disagrees with "
                             f"gru_scan_bwd_ref at {dtype} B={b} U={u}")
        worst[dtype] = max(worst[dtype], max(
            (a.float() - w.float()).abs().max().item()
            for a, w in zip(got, want)))
        if (dtype, b, u) == ("bfloat16", 256, 128):
            timing = (xp, rk, rb, hs, g, got)
        if (dtype, b, u) == ("bfloat16", 256, 256):
            wide = (xp, rk, rb, hs, g)

    # U=256, B=256 bf16: the widest variant against its bound
    wide_ms = cuda_ms(lambda: gru_scan_bwd(*wide), 20)
    wide_device_ms = graph_ms(lambda: gru_scan_bwd(*wide), 20)
    wide_bound_ms, wide_bound_by = gru_bwd_bound(*wide)
    wide_plan = _bwd_plan(d, 256, 256)
    log("kernels", f"gru_scan_bwd bf16 D=2 T=60 B=256 U=256: kernel_ms "
                   f"{wide_ms:.4f} (device ms {wide_device_ms:.4f}; "
                   f"{_plan_text(wide_plan)}) bound_ms {wide_bound_ms:.5f} "
                   f"({wide_bound_by})")

    # the training path's shape: D=2, T=60, B=256, U=128, bf16 storage
    xp, rk, rb, hs, g, got = timing
    b, u = xp.shape[2], xp.shape[-1] // 3
    ms = cuda_ms(lambda: gru_scan_bwd(xp, rk, rb, hs, g), 20)
    device_ms = graph_ms(lambda: gru_scan_bwd(xp, rk, rb, hs, g), 20)
    passes = kernel_split_ms(lambda: gru_scan_bwd(xp, rk, rb, hs, g), 20,
                             "gru_bwd_")
    plain_ms = cuda_ms(lambda: gru_scan_bwd_ref(xp, rk, rb, hs, g), 2)
    lib_fwd, lib_both = cudnn_gru_train(xp, rk, rb, g)
    library_ms = cuda_ms(lib_both, 20) - cuda_ms(lib_fwd, 20)
    bound_ms, bound_by = gru_bwd_bound(xp, rk, rb, hs, g)
    log("kernels", f"gru_scan_bwd bf16 D=2 T=60 B=256 U=128 on {card}: "
                   f"kernel_ms {ms:.4f} (device ms {device_ms:.4f}) plain_ms "
                   f"{plain_ms:.4f} library_ms (cuDNN GRU backward) "
                   f"{library_ms:.4f} bound_ms {bound_ms:.5f} ({bound_by})")
    log("kernels", "gru_scan_bwd device ms per call by kernel (profiler): "
                   + _split_text(passes))
    # every plan that takes U=128 at the training shape and at the feed's
    # B=64, each held against the plain version, for the choice above
    for bb in (256, 64):
        args = [a[:, :, :bb].contiguous() if a.dim() == 4 else a
                for a in (xp, rk, rb, hs, g)]
        want = gru_scan_bwd_ref(*args)
        times = []
        for v in range(len(_BWD_VARIANTS)):
            try:
                p = _bwd_plan(d, bb, u, variant=v)
            except ValueError:          # the variant does not take U
                continue
            got_v = _gru_scan_bwd_cuda(*args, plan=p)
            err = max(rel_err(a, w) for a, w in zip(got_v, want))
            if err > BWD_TOL["bfloat16"]:
                raise SystemExit(f"gru_scan_bwd variant {v} disagrees with "
                                 f"gru_scan_bwd_ref at B={bb}: {err:.3e}")
            v_ms = cuda_ms(lambda: _gru_scan_bwd_cuda(*args, plan=p), 20)
            times.append(f"variant {v} {_BWD_VARIANTS[v]} {_plan_text(p)}: "
                         f"{v_ms:.4f} ms (rel_err {err:.1e})")
        log("kernels", f"gru_scan_bwd plans at B={bb} bf16: "
                       + "; ".join(times))
    rk_rows = {"u128": bwd_rk_row(card, (xp, rk, rb, hs, g), library_ms),
               "u256": bwd_rk_row(card, wide)}
    del wide
    bound_tc_ms, bound_tc_by = gru_bwd_bound_tc(xp, rk, rb, hs, g)
    entries = [{"name": "gru_scan_bwd", "route": "cuda",
                "source": "seld_tpu_torch/csrc/gru_bwd.cu",
                "replaces": "seld_tpu/ops/pallas/gru.py:209",
                "launches": None, "max_abs_err": worst["float32"],
                "max_abs_err_bf16": worst["bfloat16"],
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": library_ms,
                "device_ms": device_ms, "passes_ms": passes,
                "bound_tc_ms": bound_tc_ms, "bound_tc_by": bound_tc_by,
                "rk_rows": rk_rows,
                "plan": _plan_json(_bwd_plan(d, b, u)),
                "u256_ms": wide_ms, "u256_device_ms": wide_device_ms,
                "u256_bound_ms": wide_bound_ms, "u256_bound_by": wide_bound_by,
                "u256_plan": _plan_json(wide_plan)}]

    return entries + [kernels_stem_dy(card)]


def _bwd_tols(dtype, rk):
    """BWD_TOL of each output: dx_proj in x_proj's dtype, dRk in Rk's, dRb
    in f32."""
    return [BWD_TOL[dtype], BWD_TOL[str(rk.dtype).split(".")[-1]],
            BWD_TOL["float32"]]


def bwd_rk_row(card, args, library_ms=None):
    """gru_scan_bwd at one [kernels] row (D=2, T=60, B=256, bf16 storage)
    with Rk in f32 and in bf16 (as the training step hands it over), timed
    in turns: each held against the plain version (BWD_TOL) and called
    twice (bit-equal); device ms by pass (profiler: the tensor-core hp and
    dRk passes, the recurrence); cuDNN's bf16 backward at the shape; the f32
    and the tensor-core bounds."""
    import torch
    from seld_tpu_torch.ops.gru import _gru_scan_bwd_cuda, gru_scan_bwd_ref
    xp, rk32, rb, hs, g = args
    u = xp.shape[-1] // 3
    dtype = str(xp.dtype).split(".")[-1]
    if library_ms is None:
        lib_fwd, lib_both = cudnn_gru_train(xp, rk32, rb, g)
        library_ms = cuda_ms(lib_both, 20) - cuda_ms(lib_fwd, 20)
    out = {"library_ms": library_ms}
    rks = {"f32": rk32, "bf16": rk32.to(torch.bfloat16)}
    for rk_name, rk in rks.items():
        want = gru_scan_bwd_ref(xp, rk, rb, hs, g)
        tols = _bwd_tols(dtype, rk)
        got = _gru_scan_bwd_cuda(xp, rk, rb, hs, g)
        got2 = _gru_scan_bwd_cuda(xp, rk, rb, hs, g)
        torch.cuda.synchronize()
        errs = [rel_err(a, w) for a, w in zip(got, want)]
        same = all(torch.equal(a, c) for a, c in zip(got, got2))
        if not same or any(e > tl for e, tl in zip(errs, tols)):
            raise SystemExit(f"gru_scan_bwd (Rk {rk_name}) at U={u}: rel_err "
                             f"{errs} (tol {tols}), bit-equal {same}")
        b32, by32 = gru_bwd_bound(xp, rk, rb, hs, g)
        btc, bytc = gru_bwd_bound_tc(xp, rk, rb, hs, g)
        out[rk_name] = {"rel_err": errs, "ms": [], "passes_ms":
                        kernel_split_ms(lambda: _gru_scan_bwd_cuda(
                            xp, rk, rb, hs, g), 10, "gru_bwd_"),
                        "bound_ms": b32, "bound_by": by32,
                        "bound_tc_ms": btc, "bound_tc_by": bytc}
    for rk_name in ("f32", "bf16", "bf16", "f32"):
        rk = rks[rk_name]
        out[rk_name]["ms"].append(cuda_ms(
            lambda: _gru_scan_bwd_cuda(xp, rk, rb, hs, g), 20))
    for rk_name in rks:
        row = out[rk_name]
        log("kernels", f"gru_scan_bwd bf16 D=2 T=60 B=256 U={u} Rk "
                       f"{rk_name} on {card}: "
                       + "/".join(f"{m:.4f}" for m in row["ms"])
                       + " ms (" + _split_text(row["passes_ms"])
                       + f"); cuDNN GRU backward {library_ms:.4f}; bound "
                       f"f32 {row['bound_ms']:.5f} ({row['bound_by']}), "
                       f"tensor-core {row['bound_tc_ms']:.5f} "
                       f"({row['bound_tc_by']}); rel_err dRk "
                       f"{row['rel_err'][1]:.2e} (tol "
                       f"{_bwd_tols(dtype, rks[rk_name])[1]:.0e}), a second "
                       f"call bit-equal")
    return out


# the GRU kernels past U = 256: (dtype, B, U, Rk's dtype). The resident
# variants (U <= 512) at ragged tiles and uneven CTA shares (U = 260: 36
# units a CTA, the last 8; U = 388: 28 a CTA on 16, two CTAs empty); the
# streamed ones where Rk is f32 past U = 512 (U = 1024, 2056: 257 units a
# CTA, walked in two passes); the grid-resident ones where Rk comes in bf16
# (U = 1024 at B = 8: 64-row blocks; f32 storage at B = 100, U = 640; the
# forward alone at U = 544, whose backward, wanting U % 128 == 0, is
# streamed). Each called twice (the second call bit-equal).
GRU_WIDE_CHECKS = (("float32", 3, 260, "float32"),
                   ("bfloat16", 17, 384, "float32"),
                   ("float32", 17, 388, "float32"),
                   ("bfloat16", 3, 512, "float32"),
                   ("float32", 8, 1024, "float32"),
                   ("float32", 3, 2056, "float32"),
                   ("bfloat16", 8, 1024, "bfloat16"),
                   ("float32", 100, 640, "bfloat16"),
                   ("bfloat16", 17, 544, "bfloat16"))
# timed rows, B = 256: bf16 storage with Rk in bf16 (as the training step
# hands it over) and in f32, f32 storage with f32 Rk; each beside the
# streamed recurrences in turns where the plan is another
GRU_WIDE_ROWS = tuple((dtype, 256, u, rk) for u in (384, 512, 1024)
                      for dtype, rk in (("bfloat16", "bfloat16"),
                                        ("bfloat16", "float32"),
                                        ("float32", "float32")))
# [gru_wide]'s full-width path: SS5 with its DOA biGRU at 384 units, B =
# 256, bf16, make_train_multistep(WIDE_STEPS) replayed
WIDE_UNITS = 384
WIDE_STEPS = 8


def _plan_wide(plan, d, b, u, dtype):
    """A plan past U = 256 with its register/shared split and, for a
    resident plan, cudaOccupancyMaxActiveClusters and its waves; for a
    grid-resident one, the CTAs the card holds at once against those it
    needs."""
    from seld_tpu_torch.ops.gru import (_BWD_GRID, _FWD_GRID, grid_residency,
                                        max_active_clusters)
    text = f"variant {plan.variant} C={plan.c} Bt={plan.bt} " \
           f"threads={plan.threads} CTAs={plan.ctas}"
    out = {"variant": plan.variant, "c": plan.c, "bt": plan.bt,
           "threads": plan.threads, "ctas": plan.ctas}
    if plan.variant in (_FWD_GRID, _BWD_GRID):
        held, need = grid_residency(plan, d, b, u, dtype)
        text += (f", grid-resident: Rk {plan.rk_smem / 1024:.0f} KiB in "
                 f"shared memory a CTA, {plan.smem} B shared; {held} CTAs "
                 f"resident at once for {need}")
        out.update(rk_smem=plan.rk_smem, smem=plan.smem, resident=held)
    elif plan.smem:
        active = max_active_clusters(plan, d, b, u)
        clusters = plan.ctas // plan.c
        waves = -(-clusters // active)
        text += (f", Rk {plan.rk_reg / 1024:.0f} KiB in registers + "
                 f"{plan.rk_smem / 1024:.0f} KiB in shared memory a CTA, "
                 f"{plan.smem} B shared; cudaOccupancyMaxActiveClusters "
                 f"{active}: {clusters} clusters in {waves} wave(s)")
        out.update(rk_reg=plan.rk_reg, rk_smem=plan.rk_smem, smem=plan.smem,
                   max_active_clusters=active, waves=waves)
    return text, out


def _wide_check(xp, rk, rb, g, fplan, bplan):
    """The kernels on (fplan, bplan) against their plain versions, each
    called twice: (forward max_abs_err, backward rel_errs, bit-equal)."""
    import torch
    from seld_tpu_torch.ops.gru import (_gru_scan_bwd_cuda, _gru_scan_cuda,
                                        gru_scan_bwd_ref, gru_scan_ref)
    ref = gru_scan_ref(xp, rk, rb)
    hs = _gru_scan_cuda(xp, rk, rb, plan=fplan)
    hs2 = _gru_scan_cuda(xp, rk, rb, plan=fplan)
    got = _gru_scan_bwd_cuda(xp, rk, rb, ref, g, plan=bplan)
    got2 = _gru_scan_bwd_cuda(xp, rk, rb, ref, g, plan=bplan)
    torch.cuda.synchronize()
    want = gru_scan_bwd_ref(xp, rk, rb, ref, g)
    err = (hs.float() - ref.float()).abs().max().item()
    errs = [rel_err(a, w) for a, w in zip(got, want)]
    if hs.dtype != xp.dtype or got[0].dtype != xp.dtype:
        raise SystemExit(f"the GRU kernels returned {hs.dtype} / "
                         f"{got[0].dtype} for {xp.dtype} inputs")
    same = torch.equal(hs, hs2) and all(
        torch.equal(a, b) for a, b in zip(got, got2))
    return err, errs, same


def _graph_check(xp, rk, rb, g, ref, tols):
    """gru_scan and gru_scan_bwd on their default plans captured in one
    CUDA graph (a grid-resident kernel's cooperative launch and the memset
    that zeroes its counters become graph nodes), warmed up on the
    capturing stream first; the outputs zeroed, then replayed, twice.
    Returns (each replay bit-equal to the eager calls, forward max_abs_err,
    backward rel_errs), the errors against the plain versions."""
    import torch
    from seld_tpu_torch.ops.gru import (_gru_scan_bwd_cuda, _gru_scan_cuda,
                                        gru_scan_bwd_ref)

    def both():
        return (_gru_scan_cuda(xp, rk, rb),) + tuple(
            _gru_scan_bwd_cuda(xp, rk, rb, ref, g))
    eager = both()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        both()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = both()
    same = True
    for _ in range(2):
        for o in out:
            o.zero_()
        graph.replay()
        torch.cuda.synchronize()
        same = same and all(torch.equal(o, e) for o, e in zip(out, eager))
    want = gru_scan_bwd_ref(xp, rk, rb, ref, g)
    err = (out[0].float() - ref.float()).abs().max().item()
    errs = [rel_err(o, w) for o, w in zip(out[1:], want)]
    del graph
    return same, err, errs


def _kind(plan):
    from seld_tpu_torch.ops.gru import (_BWD_GRID, _BWD_STREAM, _FWD_GRID,
                                        _FWD_STREAM)
    if plan.variant in (_FWD_GRID, _BWD_GRID):
        return "grid"
    return "streamed" if plan.variant in (_FWD_STREAM, _BWD_STREAM) \
        else "resident"


def gru_wide(card):
    """gru_scan and gru_scan_bwd past U = 256 against their plain versions
    on the card (GRU_TOL, BWD_TOL), each call twice and bit-equal, on the
    default plans for Rk's dtype (resident up to U = 512; past it
    grid-resident with Rk in bf16, else streamed), and at the timed rows
    (GRU_WIDE_ROWS) on the streamed plans too where the default is
    another; there kernel ms of each in turns, the backward's device ms by pass, plain ms, the f32 and the
    tensor-core bounds, cuDNN's torch.nn.GRU at the same shape (forward:
    its training forward; backward: forward + backward less the forward);
    each plan with its split and residency. At U = 1024, B = 256 with Rk
    in bf16 the grid-resident kernels also replay from a CUDA graph
    (`_graph_check`). Then the full-width path through the resident
    kernels (`wide_step`). Returns ({row: forward
    numbers}, {row: backward numbers})."""
    import torch
    from seld_tpu_torch.ops.gru import (_BWD_STREAM, _FWD_STREAM,
                                        _RESIDENT_UNITS, _bwd_plan,
                                        _fwd_plan, _gru_scan_bwd_cuda,
                                        _gru_scan_cuda, gru_scan_bwd_ref,
                                        gru_scan_ref)
    rng = np.random.RandomState(14)
    d, t = 2, 60
    fwd_rows, bwd_rows = {}, {}
    for dtype, b, u, rk_dtype in GRU_WIDE_CHECKS + GRU_WIDE_ROWS:
        xp, rk, rb = _gru_inputs(rng, d, t, b, u, dtype)
        rk = rk.to(getattr(torch, rk_dtype))
        rk_bf16 = rk.dtype == torch.bfloat16
        g = torch.from_numpy(rng.randn(d, t, b, u).astype(
            np.float32)).cuda().to(xp.dtype)
        timed = (dtype, b, u, rk_dtype) in GRU_WIDE_ROWS
        new = (_fwd_plan(d, b, u, rk_bf16=rk_bf16),
               _bwd_plan(d, b, u, rk_bf16=rk_bf16))
        if u <= _RESIDENT_UNITS:
            want = ("resident", "resident")
        else:
            want = ("grid" if rk_bf16 else "streamed",
                    "grid" if rk_bf16 and u % 128 == 0 else "streamed")
        if (_kind(new[0]), _kind(new[1])) != want:
            raise SystemExit(f"U={u} Rk {rk_dtype}: the plans {new} are "
                             f"not {want}")
        runs = [("new", new)]
        if timed and want != ("streamed", "streamed"):
            runs.append(("streamed", (
                _fwd_plan(d, b, u, variant=_FWD_STREAM),
                _bwd_plan(d, b, u, variant=_BWD_STREAM))))
        tols = _bwd_tols(dtype, rk)
        key = f"{dtype}_B{b}_U{u}_Rk_{rk_dtype}"
        ref = gru_scan_ref(xp, rk, rb)
        if timed:
            fwd_rows[key], bwd_rows[key] = {}, {}
        for label, (fplan, bplan) in runs:
            err, errs, same = _wide_check(xp, rk, rb, g, fplan, bplan)
            ok = same and err <= GRU_TOL[dtype] and \
                all(e <= tl for e, tl in zip(errs, tols))
            ftext, fjson = _plan_wide(fplan, d, b, u, xp.dtype)
            btext, bjson = _plan_wide(bplan, d, b, u, xp.dtype)
            log("kernels", f"gru_scan/gru_scan_bwd {dtype} B={b} U={u} Rk "
                           f"{rk_dtype} ({label}: {_kind(fplan)} / "
                           f"{_kind(bplan)}): forward "
                           f"max_abs_err {err:.3e} (tol "
                           f"{GRU_TOL[dtype]:.1e}), backward rel_err dx_proj "
                           f"{errs[0]:.2e} dRk {errs[1]:.2e} dRb "
                           f"{errs[2]:.2e} (tol {tols[0]:.1e}/{tols[1]:.0e}/"
                           f"{tols[2]:.0e}), a second call bit-equal {same} "
                           f"{'ok' if ok else 'FAIL'}; forward plan {ftext}; "
                           f"backward plan {btext}")
            if not ok:
                raise SystemExit(f"the {label} GRU kernels disagree with "
                                 f"their plain versions (or with themselves) "
                                 f"at {dtype} B={b} U={u} Rk {rk_dtype}")
            if timed:
                fwd_rows[key][label] = {"kind": _kind(fplan), "ms": [],
                                        "max_abs_err": err, "plan": fjson}
                bwd_rows[key][label] = {
                    "kind": _kind(bplan), "ms": [], "rel_err": max(errs),
                    "plan": bjson, "passes_ms": kernel_split_ms(
                        lambda: _gru_scan_bwd_cuda(xp, rk, rb, ref, g,
                                                   plan=bplan),
                        3, "gru_bwd_")}
        if not timed:
            continue
        labels = [lb for lb, _ in runs]
        for label in labels + labels[::-1]:      # in turns
            fplan, bplan = dict(runs)[label]
            fwd_rows[key][label]["ms"].append(cuda_ms(
                lambda: _gru_scan_cuda(xp, rk, rb, plan=fplan), 5))
            bwd_rows[key][label]["ms"].append(cuda_ms(
                lambda: _gru_scan_bwd_cuda(xp, rk, rb, ref, g, plan=bplan),
                3))
        grid = (_kind(new[0]) == "grid", _kind(new[1]) == "grid")
        if all(grid) and (dtype, u) == ("bfloat16", 1024):
            same, err, errs = _graph_check(xp, rk, rb, g, ref, tols)
            ok = same and err <= GRU_TOL[dtype] and \
                all(e <= tl for e, tl in zip(errs, tols))
            log("kernels", f"gru_scan + gru_scan_bwd {dtype} B={b} U={u} Rk "
                           f"{rk_dtype} (grid / grid) in one CUDA graph, "
                           f"replayed twice: each replay bit-equal to the "
                           f"eager calls {same}; forward max_abs_err "
                           f"{err:.3e}, backward rel_err dx_proj "
                           f"{errs[0]:.2e} dRk {errs[1]:.2e} dRb "
                           f"{errs[2]:.2e} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"the grid-resident GRU kernels replayed "
                                 f"from a CUDA graph at {key} differ from "
                                 f"their eager calls or plain versions")
            fwd_rows[key]["graph"] = {"bit_equal": same, "max_abs_err": err,
                                      "rel_err": errs}
        plain_ms = cuda_ms(lambda: gru_scan_ref(xp, rk, rb), 2)
        bwd_plain_ms = cuda_ms(lambda: gru_scan_bwd_ref(xp, rk, rb, ref, g), 1)
        lib_fwd, lib_both = cudnn_gru_train(xp, rk.float(), rb, g)
        lib_ms = cuda_ms(lib_fwd, 10)
        lib_bwd_ms = cuda_ms(lib_both, 10) - lib_ms
        bounds = gru_scan_bound(xp, rk, rb) + gru_scan_bound_tc(
            xp, rk, rb, grid[0])
        bwd_bounds = gru_bwd_bound(xp, rk, rb, ref, g) + gru_bwd_bound_tc(
            xp, rk, rb, ref, g, grid[1])
        fwd_rows[key].update(plain_ms=plain_ms, library_ms=lib_ms,
                             bound_ms=bounds[0], bound_by=bounds[1],
                             bound_tc_ms=bounds[2], bound_tc_by=bounds[3])
        bwd_rows[key].update(plain_ms=bwd_plain_ms, library_ms=lib_bwd_ms,
                             bound_ms=bwd_bounds[0], bound_by=bwd_bounds[1],
                             bound_tc_ms=bwd_bounds[2],
                             bound_tc_by=bwd_bounds[3])
        for name, rows, pl, lib, bd in (
                ("gru_scan", fwd_rows, plain_ms, lib_ms, bounds),
                ("gru_scan_bwd", bwd_rows, bwd_plain_ms, lib_bwd_ms,
                 bwd_bounds)):
            log("kernels", f"{name} {dtype} D=2 T=60 B={b} U={u} Rk "
                           f"{rk_dtype} on {card}: " + ", ".join(
                               f"{lb} ({rows[key][lb]['kind']}) "
                               + "/".join(
                                   f"{m:.4f}" for m in rows[key][lb]["ms"])
                               + " ms" + (
                                   " [" + _split_text(
                                       rows[key][lb]["passes_ms"]) + "]"
                                   if name == "gru_scan_bwd" else "")
                               for lb in labels)
                           + f"; plain_ms {pl:.4f} library_ms (cuDNN GRU "
                           f"{'backward' if name == 'gru_scan_bwd' else 'training forward'}"
                           f") {lib:.4f} bound_ms f32 {bd[0]:.5f} ({bd[1]}),"
                           f" tensor-core {bd[2]:.5f} ({bd[3]})")
    fwd_rows["wide_step"] = wide_step(card)
    return fwd_rows, bwd_rows


def _device_ms_by(fn, pattern):
    """(device ms a call, device ms a call of the kernels whose name
    matches `pattern`) over one call of fn, from torch.profiler; (None,
    None) if it recorded no device time."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total = part = 0.0
    for avg in prof.key_averages():
        if avg.device_type != DeviceType.CUDA:
            continue
        us = getattr(avg, "self_device_time_total", None)
        us = avg.self_cuda_time_total if us is None else us
        total += us / 1e3
        if re.search(pattern, avg.key):
            part += us / 1e3
    return (total, part) if total > 0 else (None, None)


def wide_step(card):
    """SS5 with its DOA biGRU at WIDE_UNITS units (a user config; the JAX
    package runs it through its Pallas GRU), B=256, bf16, dropout on:
    make_train_multistep(WIDE_STEPS) warmed up and captured, then a timed
    call of replays: ms a step, windows/s, finite losses, exact launches
    (gru_scan 2, gru_scan_bwd 2, stem_dy 1 a step), and the GRU kernels'
    share of the device time of one replayed call (torch.profiler)."""
    import torch
    from seld_tpu_torch.bench import build, ss5_config
    from seld_tpu_torch.ops import kernels
    from seld_tpu_torch.train.steps import make_train_multistep
    cfg = ss5_config(True)
    cfg["DOA_ARGS"] = dict(cfg["DOA_ARGS"], units=WIDE_UNITS)
    torch.cuda.empty_cache()
    b = build(batch=256, dtype="bf16", device="cuda", cfg=cfg)
    k = WIDE_STEPS
    multistep = make_train_multistep(steps_per_call=k, **b.step_kwargs)
    xs = b.x.unsqueeze(0).expand(k, *b.x.shape)
    ys = tuple(y.unsqueeze(0).expand(k, *y.shape) for y in b.y)
    state, metric = b.state, b.metric
    state, metric, _ = multistep(state, metric, xs, ys)   # warm up, capture
    torch.cuda.synchronize()
    kernels.launch_counts.clear()
    times, losses = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        state, metric, (sl, dl) = multistep(state, metric, xs, ys)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / k * 1e3)
        losses += [sl, dl]
    launches = {n: kernels.launch_counts[n] for n in SS5_COUNTED}
    want = {n: {"gru_scan": 2, "gru_scan_bwd": 2, "stem_dy": 1,
                "batch_norm": SS5_BN_LAUNCHES}.get(n, 0)
            * 3 * k for n in SS5_COUNTED}

    def call():
        multistep(state, metric, xs, ys)
    total, gru = _device_ms_by(call, r"gru_(fwd|bwd)_")
    finite = bool(torch.isfinite(torch.cat(
        [v.reshape(-1).float() for v in losses])).all())
    ms = min(times)
    ok = finite and launches == want
    share = "not measured" if total is None else \
        f"{gru / k:.4f} of {total / k:.4f} device ms a step " \
        f"({100 * gru / total:.1f}%)"
    log("kernels", f"SS5 DOA biGRU U={WIDE_UNITS} bf16 B=256 graphed "
                   f"(make_train_multistep({k}), 3 calls): "
                   + ", ".join(f"{x:.3f}" for x in times)
                   + f" ms/step, best {256e3 / ms:.1f} windows/s; GRU "
                   f"kernels {share}; losses finite {finite}; launches "
                   f"{launches} (want {want}) on {card} "
                   f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the U=384 SS5 step gave a non-finite loss or "
                         "skipped a kernel")
    return {"ms": times, "windows_per_s": 256e3 / ms,
            "device_ms": None if total is None else total / k,
            "gru_device_ms": None if total is None else gru / k}


# stem_dy cases: (dtype, B, pool, y layout, dpooled layout); a layout is
# "channels-last" (C innermost: the stem conv's output), "channels-first",
# or "main path" (dpooled laid out as the training step hands it over)
STEM_CASES = ([(dtype, b, (5, 2), "channels-last", "channels-last")
               for dtype in ("float32", "bfloat16") for b in (8, 256)]
              + [("bfloat16", 8, (5, 2), "channels-first", "channels-last"),
                 ("float32", 256, (5, 2), "channels-last", "main path"),
                 ("bfloat16", 256, (5, 2), "channels-last", "main path")]
              # the other compile-time window, and the generic path's
              + [(dtype, 64, pool, "channels-last", "main path")
                 for pool in ((5, 1), (5, 4), (10, 2))
                 for dtype in ("float32", "bfloat16")]
              + [("bfloat16", 8, (5, 4), "channels-first", "channels-first"),
                 ("float32", 8, (10, 2), "channels-first", "main path")])


def _stem_inputs(gen, dtype, b, pool, layout, dp_layout, dp_order):
    """y [B, 300, 64, 32] on a coarse grid with many negatives (windows hold
    exact ties and ReLU zeros), dpooled and params6, in the given layouts."""
    import torch
    dt = getattr(torch, dtype)
    shape = (b, 300, 64, 32)
    first = (0, 3, 1, 2)                 # [B, C, T, F] in memory
    y = (torch.randint(-6, 5, shape if layout == "channels-last" else
                       tuple(shape[i] for i in first), generator=gen,
                       device="cuda") / 4.0).to(dt)
    if layout == "channels-first":
        y = y.movedim(1, -1)
    dshape = (b, 300 // pool[0], 64 // pool[1], 32)
    order = {"channels-last": (0, 1, 2, 3), "channels-first": first,
             "main path": dp_order}[dp_layout]
    dp = torch.randn(tuple(dshape[i] for i in order), generator=gen,
                     device="cuda").to(dt)
    dp = dp.permute(tuple(order.index(i) for i in range(4)))
    p6 = torch.stack([
        0.1 * torch.randn(32, generator=gen, device="cuda"),
        1.0 + 0.1 * torch.rand(32, generator=gen, device="cuda"),
        1.0 + 0.2 * torch.rand(32, generator=gen, device="cuda"),
        0.1 * torch.randn(32, generator=gen, device="cuda"),
        1e-3 * torch.randn(32, generator=gen, device="cuda"),
        1e-3 * torch.randn(32, generator=gen, device="cuda")])
    return y, dp, p6


def main_path_dpooled(**model):
    """(shape, strides, dtype) of the cotangent that the SS5 bf16 training
    step (or that of `model_name`/`cfg` of bench.build) hands the fused
    stem's backward: a tensor hook on the stem's pooled output during one
    step of seld_tpu_torch.bench's step at B=8."""
    import torch
    import seld_tpu_torch.models.layers as layers
    from seld_tpu_torch.bench import build
    seen = []
    fused = layers.conv_bn_relu_pool

    def hooked(*args, **kwargs):
        out = fused(*args, **kwargs)
        if out[0].requires_grad:
            out[0].register_hook(lambda g: seen.append(
                (tuple(g.shape), g.stride(), g.dtype)))
        return out
    layers.conv_bn_relu_pool = hooked
    try:
        b = build(batch=8, dtype="bf16", device="cuda", **model)
        b.step(b.state, b.metric, b.x, b.y)
        torch.cuda.synchronize()
    finally:
        layers.conv_bn_relu_pool = fused
    if len(seen) != 1:
        raise SystemExit(f"the stem's pooled output got {len(seen)} "
                         "cotangents in one step")
    return seen[0]


def sass_report(source):
    """Static SASS instruction counts of each kernel in a built library
    (cuobjdump -sass): all, global loads and stores, integer arithmetic
    (IMAD, IADD3, LEA, SHF, LOP3, ISETP, SEL, PRMT), the rest."""
    import collections
    import re

    from seld_tpu_torch.ops import kernels
    tool = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        log("kernels", f"no {tool}: SASS not counted")
        return {}
    text = subprocess.run([tool, "-sass", kernels.library_path(source)],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    integer = ("IMAD", "IADD3", "LEA", "SHF", "LOP3", "ISETP", "SEL", "PRMT")
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            k = re.search(r"\d+([A-Za-z]\w*?_kernel)(\w*)", m.group(1))
            args = [] if not k else re.findall(r"Li(\d+)E", k.group(2)) + (
                ["bf16"] if "bfloat16" in k.group(2) else [])
            name = m.group(1) if not k else k.group(1) + (
                f"<{','.join(args)}>" if args else "")
            while name in out:
                name += "'"
            out[name] = collections.Counter()
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)",
                      line)
        if name and m and m.group(1) != "NOP":
            op = m.group(1)
            c = out[name]
            c["all"] += 1
            c["LDG" if op == "LDG" else "STG" if op == "STG" else
              "int" if op in integer else "other"] += 1
    return {k: dict(v) for k, v in out.items()}


def phase_sass(card):
    """stem_dy.cu's static SASS instruction counts, by kernel."""
    for fn, counts in sass_report("stem_dy.cu").items():
        log("kernels", f"stem_dy.cu SASS {fn}: {counts}")


def kernels_stem_dy(card):
    """stem_dy against stem_dy_ref on every STEM_CASES case (with ties), and
    its times at the training path's shape: B=256 bf16, pool [5, 2], y
    channels-last and dpooled as the training step lays it out."""
    import torch
    from seld_tpu_torch.ops.stem_bwd import (_VEC_WINDOWS, _vector_path,
                                             library_vec_windows, stem_dy,
                                             stem_dy_ref)

    if library_vec_windows() != _VEC_WINDOWS:
        raise SystemExit(f"csrc/stem_dy.cu's vector windows "
                         f"{library_vec_windows()} differ from "
                         f"ops/stem_bwd.py's {_VEC_WINDOWS}")
    dshape, dstride, ddtype = main_path_dpooled()
    dp_order = tuple(sorted(range(4), key=lambda i: -dstride[i]))
    log("kernels", f"stem_dy dpooled on the training path: shape {dshape}, "
                   f"strides {dstride}, {ddtype}, dims outermost first "
                   f"{dp_order} (0 B, 1 T, 2 F, 3 C)")
    gen = torch.Generator(device="cuda").manual_seed(5)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    timing = None
    for dtype, b, pool, layout, dp_layout in STEM_CASES:
        y, dp, p6 = _stem_inputs(gen, dtype, b, pool, layout, dp_layout,
                                 dp_order)
        dy, dbias = stem_dy(y, dp, p6, pool)
        torch.cuda.synchronize()
        want_dy, want_db = stem_dy_ref(y, dp, p6, pool)
        e_dy, e_db = rel_err(dy, want_dy), rel_err(dbias, want_db)
        ties = _tied_windows(y, p6, pool)
        ok = (e_dy <= BWD_TOL[dtype] and e_db <= BWD_TOL["float32"]
              and dy.stride() == y.stride() and ties > 0)
        path = "vector" if _vector_path(y, pool) else "generic"
        log("kernels", f"stem_dy {dtype} B={b} pool {list(pool)} y "
                       f"{layout}, dpooled {dp_layout} {dp.stride()} "
                       f"({path} path): rel_err "
                       f"dy {e_dy:.2e} dbias {e_db:.2e} (tol "
                       f"{BWD_TOL[dtype]:.1e}/{BWD_TOL['float32']:.0e}), "
                       f"{ties} windows with tied positive maxima "
                       f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"stem_dy disagrees with stem_dy_ref at {dtype} "
                             f"B={b} pool {pool} {layout}/{dp_layout}")
        worst[dtype] = max(worst[dtype],
                           (dy.float() - want_dy.float()).abs().max().item())
        if (dtype, b, pool, dp_layout) == ("bfloat16", 256, (5, 2),
                                           "main path"):
            timing = (y, dp, p6)
        del y, dp, dy, want_dy
    # the training path's shape and layouts; out is a separate buffer, so
    # calls (and a graph's replays) do not chain through dy
    y, dp, p6 = timing
    out = torch.empty_like(y)
    ms = cuda_ms(lambda: stem_dy(y, dp, p6, (5, 2), out=out), 20)
    device_ms = graph_ms(lambda: stem_dy(y, dp, p6, (5, 2), out=out), 20)
    split = kernel_split_ms(lambda: stem_dy(y, dp, p6, (5, 2), out=out), 20,
                            "stem_dy_")
    plain_ms = cuda_ms(lambda: stem_dy_ref(y, dp, p6, (5, 2)), 3)
    # a bytes yardstick over the same bytes: a PyTorch elementwise pass that
    # reads y and writes a buffer like it, then a read of dpooled
    def stream():
        torch.mul(y, 2.0, out=out)
        dp.amax()
    stream_ms = cuda_ms(stream, 20)
    stream_device_ms = graph_ms(stream, 20)
    nbytes = (2 * y.numel() + dp.numel()) * y.element_size() + p6.numel() * 4
    bound_ms, bound_by = bound(nbytes, 0)
    log("kernels", f"stem_dy bf16 B=256 [256,300,64,32] pool [5,2] on "
                   f"{card}: kernel_ms {ms:.4f} (device ms {device_ms:.4f}; "
                   f"{_split_text(split)}) plain_ms {plain_ms:.4f} "
                   f"library_ms none; yardstick: torch.mul of y into a "
                   f"buffer like y and dpooled.amax() {stream_ms:.4f} "
                   f"(device ms "
                   f"{stream_device_ms:.4f}); bound_ms {bound_ms:.5f} "
                   f"({bound_by})")
    return {"name": "stem_dy", "route": "cuda",
            "source": "seld_tpu_torch/csrc/stem_dy.cu",
            "replaces": "seld_tpu/ops/pallas/stem_bwd.py:102",
            "launches": None, "max_abs_err": worst["float32"],
            "max_abs_err_bf16": worst["bfloat16"],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "device_ms": device_ms, "split_ms": split,
            "yardstick_ms": stream_ms,
            "yardstick_device_ms": stream_device_ms,
            "dpooled_strides": list(dstride)}


# batch_norm cases: (label, [..., C] shape, x dtype, params dtype); the
# first three are the training cells' shapes (SELDnet's first BatchNorm,
# SS5's mother stage, the SS5 stem's statistics over y), the rest the odd
# and mixed cases (C = 3 takes the one-channel-a-thread plan; bf16 x with
# f32 parameters gives an f32 y)
BN_CASES = (("seldnet", (256, 300, 64, 64), "bfloat16", "bfloat16"),
            ("ss5_stage", (256, 60, 11, 96), "bfloat16", "bfloat16"),
            ("stem_stats", (256, 300, 64, 32), "bfloat16", None),
            ("dense", (256, 60, 192), "float32", "float32"),
            ("odd", (7, 13, 11, 3), "float32", "float32"),
            ("mixed", (5, 9, 7, 32), "bfloat16", "float32"))
# the passes against their plain versions on the card: the sums (passes 1
# and 3) add in the same order with every step rounded alone, so they
# agree bit for bit; the normalise and dx round an f32 value to the output
# dtype on both sides, one rsqrt and one fused multiply-add apart (f32: a
# few f32 steps of the largest element; bf16: one bf16 step)
BN_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}


def composed_batch_norm(x, scale, bias, eps=1e-3):
    """The composed train-mode BatchNorm the port ran before the passes
    (models/layers.py): f32 copy, two means, the normalise, the cast."""
    import torch
    xf = x.float()
    dims = tuple(range(x.dim() - 1))
    mean = xf.mean(dims)
    var = xf.square().mean(dims) - mean.square()
    inv = torch.rsqrt(var + eps) * scale.float()
    out = torch.promote_types(x.dtype, scale.dtype)
    return ((xf - mean) * inv + bias.float()).to(out)


def kernels_batch_norm(card):
    """The four train-mode BatchNorm passes of csrc/batch_norm.cu against
    their plain versions on every BN_CASES case, then at SELDnet's first
    BatchNorm each pass's device ms beside its bytes bound, the composed
    chain's forward + backward and cuDNN's (F.batch_norm, a yardstick the
    port never calls) in the same call."""
    import torch
    import torch.nn.functional as F
    from seld_tpu_torch.ops import batch_norm as bn
    gen = torch.Generator(device="cuda").manual_seed(7)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    timing = None
    for label, shape, dtype, pdtype in BN_CASES:
        dt = getattr(torch, dtype)
        c = shape[-1]
        x = (torch.randn(shape, generator=gen, device="cuda") * 1.5
             + torch.rand(c, generator=gen, device="cuda") * 4 - 2).to(dt)
        x2 = x.view(-1, c)
        sums = bn.batch_norm_stats(x2)
        want_sums = bn.batch_norm_stats_ref(x2)
        errs = {"sums": rel_err(sums, want_sums)}
        equal = {"sums": torch.equal(sums, want_sums)}
        if pdtype is not None:
            pt = getattr(torch, pdtype)
            scale = (1 + 0.2 * torch.randn(c, generator=gen, device="cuda")
                     ).to(pt)
            bias = (0.1 * torch.randn(c, generator=gen, device="cuda")).to(pt)
            n = x2.shape[0]
            out = torch.promote_types(dt, pt)
            y, mom = bn.batch_norm_apply(x2, sums, scale, bias, n, 1e-3, out)
            want_y, want_mom = bn.batch_norm_apply_ref(x2, sums, scale, bias,
                                                       n, 1e-3, out)
            dy = torch.randn(y.shape, generator=gen, device="cuda").to(out)
            dsums = bn.batch_norm_grad_sums(x2, dy, mom)
            want_dsums = bn.batch_norm_grad_sums_ref(x2, dy, mom)
            dx = bn.batch_norm_grad_apply(x2, dy, mom, scale, dsums, n)
            want_dx = bn.batch_norm_grad_apply_ref(x2, dy, mom, scale, dsums,
                                                   n)
            errs.update(moments=rel_err(mom, want_mom), y=rel_err(y, want_y),
                        grad_sums=rel_err(dsums, want_dsums),
                        dx=rel_err(dx, want_dx))
            equal["grad_sums"] = torch.equal(dsums, want_dsums)
            tol = {"sums": 0.0, "grad_sums": 0.0, "moments": BN_TOL["float32"],
                   "y": BN_TOL[str(out).split(".")[1]], "dx": BN_TOL[dtype]}
            worst[dtype] = max(worst[dtype], errs["dx"], errs["y"])
            if label == "seldnet":
                timing = (x2, sums, scale, bias, y, mom, dy, dsums)
        else:
            tol = {"sums": 0.0}
        torch.cuda.synchronize()
        ok = all(errs[k] <= tol[k] for k in errs)
        log("kernels", f"batch_norm {label} {list(shape)} {dtype}"
                       f"{'' if pdtype is None else f' (params {pdtype})'} "
                       f"vector path {bool(bn._vec(x2))}: rel_err "
                       + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
                       + "; bit for bit: "
                       + ", ".join(f"{k} {v}" for k, v in equal.items())
                       + f" {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"batch_norm disagrees with its plain versions "
                             f"at {label}")
        del x, x2
    x2, sums, scale, bias, y, mom, dy, dsums = timing
    n = x2.shape[0]
    passes = {
        "stats": (lambda: bn.batch_norm_stats(x2), 1),
        "apply": (lambda: bn.batch_norm_apply(x2, sums, scale, bias, n, 1e-3,
                                              torch.bfloat16), 2),
        "grad_sums": (lambda: bn.batch_norm_grad_sums(x2, dy, mom), 2),
        "grad_apply": (lambda: bn.batch_norm_grad_apply(x2, dy, mom, scale,
                                                        dsums, n), 3)}
    xbytes = x2.numel() * x2.element_size()
    timed, total_ms, total_bytes = {}, 0.0, 0
    for name, (fn, tensors) in passes.items():
        device_ms = graph_ms(fn, 10)
        bound_ms, _ = bound(tensors * xbytes, 0)
        timed[name] = {"ms": cuda_ms(fn, 10), "device_ms": device_ms,
                       "bound_ms": bound_ms}
        total_ms += device_ms
        total_bytes += tensors * xbytes
    split = kernel_split_ms(lambda: [fn() for fn, _ in passes.values()], 5,
                            "batch_norm_")
    total_bound, _ = bound(total_bytes, 0)
    x4 = x2.view(256, 300, 64, 64)

    def composed():
        xg = x4.detach().requires_grad_(True)
        s, b = (t.detach().requires_grad_(True) for t in (scale, bias))
        composed_batch_norm(xg, s, b).backward(dy.view_as(x4))

    def fused():
        xg = x4.detach().requires_grad_(True)
        s, b = (t.detach().requires_grad_(True) for t in (scale, bias))
        bn.batch_norm_train(xg, s, b, 1e-3)[0].backward(dy.view_as(x4))

    def cudnn():
        xg = x4.movedim(-1, 1).detach().requires_grad_(True)
        s, b = (t.float().detach().requires_grad_(True)
                for t in (scale, bias))
        F.batch_norm(xg, None, None, s, b, training=True,
                     eps=1e-3).backward(dy.view_as(x4).movedim(-1, 1))
    fused_ms = cuda_ms(fused, 5)
    composed_ms = cuda_ms(composed, 3)
    library_ms = cuda_ms(cudnn, 5)
    share = 100 * total_bound / total_ms
    log("kernels", f"batch_norm SELDnet's first BatchNorm [256,300,64,64] "
                   f"bf16 on {card}, device ms a pass (bound at 3.35 TB/s): "
                   + ", ".join(f"{k} {v['device_ms']:.4f} "
                               f"({v['bound_ms']:.4f})"
                               for k, v in timed.items())
                   + f"; the four {total_ms:.4f} against {total_bound:.4f} "
                   f"({share:.1f}% of the bytes bound; "
                   f"{total_bytes / 1e9:.2f} GB); by kernel "
                   f"{_split_text(split)}; forward + backward through the "
                   f"autograd Function {fused_ms:.4f} ms, the composed "
                   f"chain {composed_ms:.4f} ms, library_ms (cuDNN "
                   f"F.batch_norm, channels-last) {library_ms:.4f}")
    return {"name": "batch_norm", "route": "cuda",
            "source": "seld_tpu_torch/csrc/batch_norm.cu",
            "replaces": None, "launches": None,
            "max_abs_err": worst["float32"],
            "max_abs_err_bf16": worst["bfloat16"],
            "ms": fused_ms, "plain_ms": composed_ms,
            "bound_ms": total_bound, "bound_by": "bytes",
            "library_ms": library_ms, "device_ms": total_ms,
            "passes_ms": timed, "split_ms": split}


# BatchNorm -> ReLU -> max pool at SELDnet's three blocks in training,
# bf16 as the training step runs them: (label, x [B, T, F, C], window)
BN_POOL_CASES = (("block1", (256, 300, 64, 64), (5, 4)),
                 ("block2", (256, 60, 16, 64), (1, 4)),
                 ("block3", (256, 60, 4, 64), (1, 2)))


def kernels_batch_norm_pool(card):
    """The fused BatchNorm -> ReLU -> max pool (batch_norm_relu_pool_train:
    pass 1 and csrc/batch_norm.cu's three pool passes) against the
    composed chain it stands for (batch_norm_train, relu, max_pool) on the
    card at BN_POOL_CASES: the pooled output, the batch mean and var (the
    running statistics' inputs), dx, dscale and dbias bit for bit, on x in
    quarter steps (windows with tied maxima), four channels biased to -3
    (windows all <= 0 after the affine) and a constant one with bias 0 (y
    exactly 0, which ReLU's backward stops); pass 2' counts against the
    composed ReLU output's; the launches (1 batch_norm, 3
    batch_norm_pool); each pass's device ms beside its bytes bound and
    both chains' forward + backward."""
    import torch
    from seld_tpu_torch.ops import batch_norm as bn
    from seld_tpu_torch.ops import kernels
    from seld_tpu_torch.ops.pooling import _windows, max_pool
    gen = torch.Generator(device="cuda").manual_seed(11)
    out = {}
    for label, shape, window in BN_POOL_CASES:
        c = shape[-1]
        x = (torch.randn(shape, generator=gen, device="cuda") * 4).round() \
            .div(4)
        x[..., 4] = 0.5
        x = x.to(torch.bfloat16)
        scale = (1 + 0.2 * torch.randn(c, generator=gen, device="cuda")
                 ).to(torch.bfloat16)
        bias = 0.1 * torch.randn(c, generator=gen, device="cuda")
        bias[:4] = -3.0
        bias[4] = 0.0
        bias = bias.to(torch.bfloat16)
        pshape = (shape[0], shape[1] // window[0], shape[2] // window[1], c)
        dp = torch.randn(pshape, generator=gen, device="cuda").to(
            torch.bfloat16)

        def fused(xg, s, b):
            return bn.batch_norm_relu_pool_train(xg, s, b, 1e-3, window)

        def composed(xg, s, b):
            y, m = bn.batch_norm_train(xg, s, b, 1e-3)
            return max_pool(torch.relu(y), window, strides=window), m

        def run(chain):
            xg, s, b = (t.detach().requires_grad_(True)
                        for t in (x, scale, bias))
            p, m = chain(xg, s, b)
            p.backward(dp)
            return (p.detach(), m[0], m[1], xg.grad, s.grad, b.grad)

        kernels.launch_counts.clear()
        got = run(fused)
        torch.cuda.synchronize()
        launches = {k: kernels.launch_counts[k]
                    for k in ("batch_norm", "batch_norm_pool")}
        want = run(composed)
        names = ("pooled", "mean", "var", "dx", "dscale", "dbias")
        equal = {n: torch.equal(g, w) for n, g, w in zip(names, got, want)}
        x2 = x.view(-1, c)
        n = x2.shape[0]
        sums = bn.batch_norm_stats(x2)
        p, count, mom = bn.batch_norm_pool_apply(
            x, sums, scale, bias, n, 1e-3, torch.bfloat16, window)
        y, _ = bn.batch_norm_apply(x2, sums, scale, bias, n, 1e-3,
                                   torch.bfloat16)
        r = _windows(torch.relu(y.view(shape)), window)
        want_count = (r == r.amax(dim=(2, 4), keepdim=True)).sum(dim=(2, 4))
        equal["count"] = torch.equal(count.long(), want_count)
        tied = int(((count > 1) & (p > 0)).sum())
        nonpositive = int((p <= 0).sum())
        del r, want_count, y
        ok = (all(equal.values()) and tied > 0 and nonpositive > 0
              and launches == {"batch_norm": 1, "batch_norm_pool": 3})
        dsums, share = bn.batch_norm_pool_grad_sums(x, p, dp, count, mom,
                                                    scale, bias, window)
        xb, pb, kb = (t.numel() * t.element_size() for t in (x, p, count))
        passes = {
            "stats": (lambda: bn.batch_norm_stats(x2), xb),
            "pool_apply": (lambda: bn.batch_norm_pool_apply(
                x, sums, scale, bias, n, 1e-3, torch.bfloat16, window),
                xb + pb + kb),
            "pool_grad_sums": (lambda: bn.batch_norm_pool_grad_sums(
                x, p, dp, count, mom, scale, bias, window), xb + 3 * pb + kb),
            "pool_grad_apply": (lambda: bn.batch_norm_pool_grad_apply(
                x, p, share, mom, scale, bias, window, dsums, n),
                2 * xb + 2 * pb)}
        timed = {}
        for name, (fn, nbytes) in passes.items():
            timed[name] = {"device_ms": graph_ms(fn, 10),
                           "bound_ms": bound(nbytes, 0)[0]}
        total_ms = sum(v["device_ms"] for v in timed.values())
        total_bytes = sum(nbytes for _, nbytes in passes.values())
        total_bound = bound(total_bytes, 0)[0]

        def step(chain):
            def go():
                xg, s, b = (t.detach().requires_grad_(True)
                            for t in (x, scale, bias))
                chain(xg, s, b)[0].backward(dp)
            return go
        fused_ms = cuda_ms(step(fused), 5)
        composed_ms = cuda_ms(step(composed), 3)
        split = (kernel_split_ms(lambda: [fn() for fn, _ in passes.values()],
                                 5, "batch_norm_") if label == "block1"
                 else None)
        log("kernels", f"batch_norm_pool {label} {list(shape)} bf16 window "
                       f"{list(window)} on {card}: bit for bit against the "
                       f"composed chain: "
                       + ", ".join(f"{k} {v}" for k, v in equal.items())
                       + f"; {tied} tied windows, {nonpositive} windows "
                       f"<= 0; launches {launches}; device ms a pass "
                       f"(bound at 3.35 TB/s): "
                       + ", ".join(f"{k} {v['device_ms']:.4f} "
                                   f"({v['bound_ms']:.4f})"
                                   for k, v in timed.items())
                       + f"; the four {total_ms:.4f} against "
                       f"{total_bound:.4f} ({100 * total_bound / total_ms:.1f}"
                       f"% of the bytes bound; {total_bytes / 1e9:.3f} GB)"
                       + (f"; by kernel {_split_text(split)}" if split else "")
                       + f"; forward + backward fused {fused_ms:.4f} ms, "
                       f"composed {composed_ms:.4f} ms "
                       f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"batch_norm_pool disagrees with the composed "
                             f"chain at {label}")
        out[label] = {"shape": list(shape), "window": list(window),
                      "passes_ms": timed, "device_ms": total_ms,
                      "bound_ms": total_bound, "ms": fused_ms,
                      "composed_ms": composed_ms, "tied": tied,
                      "nonpositive": nonpositive, "split_ms": split}
        del x, x2, p, count, dp, share, got, want
    return {"name": "batch_norm_pool", "route": "cuda",
            "source": "seld_tpu_torch/csrc/batch_norm.cu",
            "replaces": None, "launches": None, "bound_by": "bytes",
            "blocks": out}


def _tied_windows(y, p6, pool):
    """Windows whose positive maximum is held by two or more elements."""
    from seld_tpu_torch.ops.stem_bwd import bn_affine
    scale, shift = bn_affine(p6[0], p6[1], p6[2], p6[3], y.dtype)
    bno = (y * scale + shift).float()
    b, t, f, c = bno.shape
    pt, pf = pool
    w = bno.reshape(b, t // pt, pt, f // pf, pf, c)
    m = w.amax(dim=(2, 4), keepdim=True)
    cnt = ((w == m) & (w > 0)).sum(dim=(2, 4))
    return int((cnt > 1).sum().item())


def _grads_err(got, want):
    """max |got - want| / max |want| of each tensor."""
    return [rel_err(g.cpu(), w) for g, w in zip(got, want)]


def phase_routes(card):
    """The shapes the kernels do not take run the composed routes on the
    card, as the JAX package composes them with XLA, and match the CPU: a
    biGRU layer at U=6, B=8 and U=390, B=3 (forward and gradients, no GRU
    kernel launched), FOA features at 40 mels and n_fft 512 and mic
    features (log-mel + GCC-PHAT) at the main path's shape (no front-end
    launch), and one training step of a Conv2DBN stem with pool [5, 4],
    whose fused backward runs stem_dy's generic path (one launch). A biGRU
    at U=384 and U=512, B=8, where the JAX package runs its Pallas kernel,
    runs the resident GRU kernels (one forward, one backward launch) and
    matches the CPU."""
    import torch
    from seld_tpu_torch.models.layers import GRU, Conv2DBN
    from seld_tpu_torch.ops import kernels
    from seld_tpu_torch.ops.features import extract_features_batch
    from seld_tpu_torch.ops.gru import (_BWD_RES, _FWD_RES, _bwd_plan,
                                        _fwd_plan, gru_route)
    from seld_tpu_torch.ops.stem_bwd import _VEC_WINDOWS

    def step(module, x, w, device):
        m = copy.deepcopy(module).to(device)
        xd = x.detach().clone().to(device).requires_grad_()
        out = m(xd)
        (out * w.to(device)).sum().backward()
        return [out, xd.grad] + [p.grad for p in m.parameters()], \
            [b.detach().clone() for b in m.buffers()]

    rng = np.random.RandomState(11)
    kernels.launch_counts.clear()
    def gru_layer(u):
        gen = torch.Generator().manual_seed(u)
        layer = GRU(64, u, bidirectional=True, generator=gen)
        with torch.no_grad():
            layer.bias.copy_(0.1 * torch.randn(layer.bias.shape,
                                               generator=gen))
        return layer

    gru_counts = ("gru_scan", "gru_scan_bwd")
    # U % 4 != 0: the composed route, as the JAX package's lax.scan; U = 384
    # and 512 at B = 8 (the JAX package's Pallas shapes): the resident
    # kernels, one forward and one backward launch a layer
    for u, b in ((6, 8), (390, 3), (384, 8), (512, 8)):
        route = "plain" if u % 4 else "kernel"
        if gru_route(u) != route:
            raise SystemExit(f"U={u}, B={b} should take the {route} route")
        x = torch.from_numpy(rng.randn(b, 60, 64).astype(np.float32))
        w = torch.from_numpy(rng.randn(b, 60, u).astype(np.float32))
        layer = gru_layer(u)
        want, _ = step(layer, x, w, "cpu")
        kernels.launch_counts.clear()
        got, _ = step(layer, x, w, "cuda")
        err = max(_grads_err(got, want))
        counts = {k: kernels.launch_counts[k] for k in gru_counts}
        # past U = 256 the plans pick the resident variants
        resident = route == "kernel" and \
            _fwd_plan(2, b, u).variant in _FWD_RES and \
            _bwd_plan(2, b, u).variant in _BWD_RES
        kind = ", resident kernels" if resident else ""
        log("routes", f"biGRU U={u} B={b} T=60 f32 on the card vs the CPU "
                      f"({route} route{kind}): output and gradients rel_err "
                      f"{err:.2e} (tol {TRAIN_GRAD_RTOL:.0e}); GRU kernel "
                      f"launches {counts}")
        launches = 1 if route == "kernel" else 0
        if err > TRAIN_GRAD_RTOL or (route == "kernel") != resident or \
                any(n != launches for n in counts.values()):
            raise SystemExit(f"the {route} GRU route failed at U={u}")
    kernels.launch_counts.clear()

    wavs = torch.from_numpy(np.round(rng.uniform(-0.5, 0.5, (2, 4, 48000))
                                     * 32767).astype(np.int16))
    kw = dict(n_mels=40, n_fft=512, win_length=480, hop_length=240)
    want = extract_features_batch(wavs, **kw)
    got = extract_features_batch(wavs.cuda(), **kw)
    torch.cuda.synchronize()
    err = (got.cpu() - want).abs().max().item()
    launched = kernels.launch_counts["foa_frontend"]
    log("routes", f"features 40 mels n_fft 512 of 2 2-s clips on the card "
                  f"vs the CPU: {tuple(got.shape)} max_abs_err {err:.2e} "
                  f"(tol {FRONTEND_TOL:.0e}); front-end launches {launched}")
    if got.shape != want.shape or err > FRONTEND_TOL or launched:
        raise SystemExit("the composed front-end route failed")

    # mode "mic" (4 log-mel + 6 GCC-PHAT) runs the plain composition on the
    # card at every shape: 2 10-s int16 clips of noise, one with a second of
    # digital silence (unit GCC phase there on both sides)
    wavs = np.round(rng.randn(2, 4, 240000) * 0.03 * 32767).astype(np.int16)
    wavs[1, :, 48000:72000] = 0
    wavs = torch.from_numpy(wavs)
    want = extract_features_batch(wavs, mode="mic")
    got = extract_features_batch(wavs.cuda(), mode="mic")
    torch.cuda.synchronize()
    err = (got.cpu() - want).abs().max().item()
    launched = kernels.launch_counts["foa_frontend"]
    log("routes", f"mic features (log-mel + GCC-PHAT) of 2 10-s clips on "
                  f"the card vs the CPU: {tuple(got.shape)} max_abs_err "
                  f"{err:.2e} (tol {FRONTEND_TOL:.0e}); front-end launches "
                  f"{launched}")
    if tuple(got.shape) != (2, 501, 64, 10) or err > FRONTEND_TOL \
            or launched:
        raise SystemExit("the mic features on the card disagree with the "
                         "CPU's")

    pool = (5, 4)
    if pool in _VEC_WINDOWS:
        raise SystemExit(f"pool {pool} should take stem_dy's generic path")
    # input and weights on grids of 1/4 and 1/8: every conv sum is exact
    # in f32 whatever its order, so the card and the CPU pool the same y.
    # With continuous values a window whose two largest outputs differ by
    # the two convs' rounding routes its gradient to another element on
    # each device, and the input gradient differs there by a whole
    # cotangent (as train phase (a) notes)
    x = torch.from_numpy((rng.randint(-4, 5, (8, 300, 64, 7)) / 4.0)
                         .astype(np.float32))
    w = torch.from_numpy(rng.randn(8, 60, 16, 32).astype(np.float32))
    stem = Conv2DBN((300, 64, 7), 32, 7, pool=pool)
    with torch.no_grad():
        stem.Conv_0.kernel.copy_(torch.from_numpy(
            (rng.randint(-2, 3, (7, 7, 7, 32)) / 8.0).astype(np.float32)))
        stem.Conv_0.bias.copy_(torch.from_numpy(
            (rng.randint(-4, 5, 32) / 8.0).astype(np.float32)))
    stem.train()
    want, want_stats = step(stem, x, w, "cpu")
    got, got_stats = step(stem, x, w, "cuda")
    names = ["output", "input"] + [n for n, _ in stem.named_parameters()]
    errs = dict(zip(names, _grads_err(got, want)))
    # the conv bias's gradient is zero in exact arithmetic (the batch mean
    # absorbs it): rounding noise on both sides, held below TRAIN_NULL_GRAD
    # of the largest gradient element, as in train phase (a)
    null = names.index("Conv_0.bias")
    null_at = TRAIN_NULL_GRAD * max(g.abs().max().item() for g in want[1:])
    null_max = max(got[null].abs().max().item(),
                   want[null].abs().max().item())
    del errs["Conv_0.bias"]
    stats_err = max(_grads_err(got_stats, want_stats))
    launched = kernels.launch_counts["stem_dy"]
    log("routes", f"Conv2DBN 7x7/32 pool [5,4] train step B=8 f32 on the "
                  f"card vs the CPU: rel_err of the output and the "
                  f"gradients " + ", ".join(f"{k} {v:.2e}" for k, v in
                                            errs.items())
                  + f" (tol {TRAIN_GRAD_RTOL:.0e}); Conv_0.bias, zero in "
                  f"exact arithmetic, {null_max:.1e} (below {null_at:.1e}); "
                  f"running stats rel_err {stats_err:.2e} (tol "
                  f"{TRAIN_STATS_RTOL:.0e}); stem_dy launches {launched} "
                  f"(generic path) on {card}")
    if max(errs.values()) > TRAIN_GRAD_RTOL or null_max >= null_at or \
            stats_err > TRAIN_STATS_RTOL or launched != 1:
        raise SystemExit("the [5, 4] stem failed on the card")
    routes_dropout(card, rng)


def routes_dropout(card, rng):
    """GRU dropout's two routes and the equality max-pool backward on the
    card. A biGRU U=128 (B=8, T=60, f32) with the same numpy masks on the
    card and the CPU: input dropout alone keeps gru_scan (one forward, one
    backward launch); recurrent dropout takes the masked route, a plain
    recurrence under autograd, and launches no GRU kernel; output and
    gradients to TRAIN_GRAD_RTOL. SELD_EQ_MAXPOOL_BWD=1: a SAME [5, 2] pool
    (which without the knob sends each window's cotangent to one maximum) of
    a tied input routes each window's cotangent to its tied maxima split
    by their count (the JAX package's rule, computed here in numpy)."""
    import torch
    from seld_tpu_torch.ops import kernels
    from seld_tpu_torch.ops.gru import gru_forward, gru_route
    from seld_tpu_torch.ops.pooling import max_pool

    b, t, i, u = 8, 60, 64, 128
    gen = torch.Generator().manual_seed(u)
    kernel = 0.1 * torch.randn(2, i, 3 * u, generator=gen)
    rk = 0.1 * torch.randn(2, u, 3 * u, generator=gen)
    bias = 0.1 * torch.randn(2, 2, 3 * u, generator=gen)
    x = torch.from_numpy(rng.randn(b, t, i).astype(np.float32))
    w = torch.from_numpy(rng.randn(b, t, u).astype(np.float32))
    gate = torch.from_numpy((rng.rand(2, 3, b, 1, i) >= 0.2) / 0.8).float()
    rec = torch.from_numpy((rng.rand(2, 3, b, u) >= 0.2) / 0.8).float()

    def run(device, gate_masks, rec_masks):
        args = [a.detach().clone().to(device).requires_grad_()
                for a in (x, kernel, rk, bias)]
        out = gru_forward(*args, bidirectional=True,
                          gate_masks=gate_masks.to(device),
                          rec_masks=None if rec_masks is None
                          else rec_masks.to(device))
        (out * w.to(device)).sum().backward()
        return [out] + [a.grad for a in args]

    for label, rec_masks, route, launches in (
            ("input dropout", None, "kernel", 1),
            ("input + recurrent dropout", rec, "masked", 0)):
        if gru_route(u, masked=rec_masks is not None) != route:
            raise SystemExit(f"{label} should take the {route} route")
        want = run("cpu", gate, rec_masks)
        kernels.launch_counts.clear()
        got = run("cuda", gate, rec_masks)
        torch.cuda.synchronize()
        counts = {k: kernels.launch_counts[k] for k in ("gru_scan",
                                                        "gru_scan_bwd")}
        err = max(_grads_err(got, want))
        ok = err <= TRAIN_GRAD_RTOL and set(counts.values()) == {launches}
        log("routes", f"biGRU U={u} B={b} T={t} f32 with {label} (the same "
                      f"numpy masks), the {route} route: output and "
                      f"gradients card vs CPU rel_err {err:.2e} (tol "
                      f"{TRAIN_GRAD_RTOL:.0e}); GRU kernel launches {counts}"
                      f" (want {launches} each) on {card} "
                      f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"the GRU {route} route with {label} failed")

    pool = (5, 2)
    xp = np.round(rng.randn(4, 300, 64, 8) * 2) / 2      # many ties
    g = rng.randn(4, 60, 32, 8).astype(np.float32)
    x6 = xp.reshape(4, 60, 5, 32, 2, 8)
    y6 = x6.max(axis=(2, 4), keepdims=True)
    eq = (x6 == y6).astype(np.float32)
    want = (eq * g.reshape(4, 60, 1, 32, 1, 8)
            / eq.sum(axis=(2, 4), keepdims=True)).reshape(xp.shape)
    xt = torch.from_numpy(xp.astype(np.float32)).cuda().requires_grad_()
    old = os.environ.get("SELD_EQ_MAXPOOL_BWD")
    os.environ["SELD_EQ_MAXPOOL_BWD"] = "1"
    try:
        out = max_pool(xt, pool, strides=pool, padding="SAME")
    finally:
        if old is None:
            del os.environ["SELD_EQ_MAXPOOL_BWD"]
        else:
            os.environ["SELD_EQ_MAXPOOL_BWD"] = old
    out.backward(torch.from_numpy(g).cuda())
    err = np.abs(xt.grad.cpu().numpy() - want).max()
    tied = int(((eq.sum(axis=(2, 4))) > 1).sum())
    ok = err <= 1e-6 and tied > 0
    log("routes", f"SELD_EQ_MAXPOOL_BWD=1: SAME max pool [5, 2] of [4, 300, "
                  f"64, 8] with {tied} tied windows: the gradient "
                  f"against count-normalised tie routing max_abs_err "
                  f"{err:.1e} (tol 1e-6) on {card} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the equality max-pool backward failed on the card")


def phase_model(card):
    import torch
    from seld_tpu_torch.config import get_model_config
    from seld_tpu_torch.models import build_model
    from seld_tpu_torch.ops import kernels

    cfg = get_model_config("SS5", search_paths=[])
    shape = (300, 64, 7)
    gpu = build_model("conv_temporal", shape, cfg, seed=0, device="cuda")
    cpu = build_model("conv_temporal", shape, cfg, seed=0, device="cpu")
    x = torch.from_numpy(np.random.RandomState(1).randn(32, *shape).astype(
        np.float32))
    kernels.launch_counts.clear()
    xg = x.cuda()
    with torch.inference_mode():
        sed, doa = gpu(xg)
        torch.cuda.synchronize()
        launches = kernels.launch_counts["gru_scan"]
        sed_c, doa_c = cpu(x)
        fwd_ms = {b: cuda_ms(lambda: gpu(xg[:b]), 10) for b in (1, 8, 32)}
    if tuple(sed.shape) != (32, 60, 12) or tuple(doa.shape) != (32, 60, 36):
        raise SystemExit(f"SS5 output shapes {tuple(sed.shape)}, "
                         f"{tuple(doa.shape)}")
    if not (torch.isfinite(sed).all() and torch.isfinite(doa).all()):
        raise SystemExit("SS5 output is not finite")
    err = max((sed.cpu() - sed_c).abs().max().item(),
              (doa.cpu() - doa_c).abs().max().item())
    log("model", f"SS5 full width B=32: sed {tuple(sed.shape)} doa "
                 f"{tuple(doa.shape)}, card vs cpu max_abs_err {err:.3e} "
                 f"(tol {MODEL_TOL:.0e}), gru_scan launches {launches}; "
                 f"forward ms " + ", ".join(f"B={b} {ms:.3f}" for b, ms in
                                            fwd_ms.items()) + f" on {card}")
    if err > MODEL_TOL or launches != 2:
        raise SystemExit("SS5 on the card disagrees with the CPU or skipped "
                         "the GRU kernel")
    return gpu


def _bf16_request(client, x):
    """POST a bfloat16 window batch as its uint16 bit view (the card's
    machine has no ml_dtypes to build a numpy bfloat16 array)."""
    import io

    import torch
    bits = torch.from_numpy(x).to(torch.bfloat16).view(torch.int16).numpy()
    buf = io.BytesIO()
    np.save(buf, bits.view(np.uint16))
    out = client._request("POST", "/v1/score", buf.getvalue(),
                          {"X-SELD-Dtype": "bfloat16"})
    rounded = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    return out["sed"], out["doa"], rounded


def phase_serve(model, card):
    import torch
    from seld_tpu_torch.inference import export_window
    from seld_tpu_torch.ops import kernels
    from seld_tpu_torch.serving import SELDClient, SELDServer
    from seld_tpu_torch.serving.server import serve

    rng = np.random.RandomState(2)
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/ss5_window.npz"
        export_window(model, path)
        server = SELDServer(artifact=path, batch_window_ms=2.0, max_batch=32,
                            device="cuda")
        httpd = serve(server, "127.0.0.1", 0)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        try:
            client = SELDClient("127.0.0.1", httpd.server_address[1])
            slot = server._slots[server.DEFAULT]
            for b in (1, 4, 8, 16, 32):     # every bucket once, uncounted
                server.score(torch.zeros(b, 300, 64, 7))
            requests = [rng.randn(b, 300, 64, 7).astype(np.float32)
                        for b in [1, 3, 8] * 9]
            bf16_x = rng.randn(3, 300, 64, 7).astype(np.float32)

            def send(x):
                t0 = time.perf_counter()
                sed, doa = client.score(x)
                return sed, doa, time.perf_counter() - t0

            kernels.launch_counts.clear()
            dispatches0 = slot.batch_stats["dispatches"]
            t0 = time.perf_counter()
            replies = [send(x) for x in requests[:3]]          # one by one
            with ThreadPoolExecutor(8) as pool:                # concurrent
                replies += list(pool.map(send, requests[3:]))
            bf16_reply = _bf16_request(client, bf16_x)
            wall = time.perf_counter() - t0
            launches = kernels.launch_counts["gru_scan"]
            dispatches = slot.batch_stats["dispatches"] - dispatches0
            health = client.health()
            metrics = client.metrics()
        finally:
            httpd.shutdown()
            server.close()
            httpd.server_close()
            thread.join(timeout=10)

        art = slot.artifact
        x8 = torch.from_numpy(requests[2])
        direct_ms = []
        for _ in range(5):      # host tensor in, numpy out: no HTTP
            t1 = time.perf_counter()
            art.call(x8)
            direct_ms.append((time.perf_counter() - t1) * 1e3)
        worst = 0.0
        for x, (sed, doa, _) in zip(requests, replies):
            want = art.call(torch.from_numpy(x))
            worst = max(worst, np.abs(sed - want[0]).max(),
                        np.abs(doa - want[1]).max())
        want = art.call(torch.from_numpy(bf16_reply[2]))
        worst = max(worst, np.abs(bf16_reply[0] - want[0]).max(),
                    np.abs(bf16_reply[1] - want[1]).max())
    n_req = len(requests) + 1
    windows = sum(x.shape[0] for x in requests) + bf16_x.shape[0]
    p50 = float(np.median([r[2] for r in replies])) * 1e3
    log("serve", f"{n_req} requests ({windows} windows) in {dispatches} "
                 f"dispatches, gru_scan launches {launches}, reply vs direct "
                 f"forward max_abs_err {worst:.3e} (tol {REPLY_TOL:.0e}), "
                 f"p50 latency {p50:.2f} ms, {windows / wall:.1f} windows/s; "
                 f"direct call B=8 {np.median(direct_ms):.2f} ms on {card}")
    if worst > REPLY_TOL:
        raise SystemExit("a reply disagrees with the direct forward")
    if launches == 0 or launches != 2 * dispatches:
        raise SystemExit(f"{launches} gru_scan launches for {dispatches} "
                         "dispatches (want 2 per dispatch)")
    if health.get("status") != "ok" or "seld_batch_dispatches_total" \
            not in metrics:
        raise SystemExit("healthz/metrics incomplete")
    return launches


@contextlib.contextmanager
def relu_decisions(masks, replay):
    """torch.relu, inside the block, records each call's decision (input >
    0) into `masks`, or with `replay` applies the recorded decisions in
    call order, moved to the input's device: a card step then takes the
    CPU step's decisions. A ReLU input within f32 rounding of zero (BN
    outputs of ~1e-7 occur in every deep family at full width) otherwise
    takes its gradient from the side each device's rounding puts it on,
    and moves every gradient upstream of it by up to ~1e-1 of its leaf's
    largest element (conv_temp and dense_gru at B=2; the card against
    itself under other cuDNN algorithms agrees to 1e-5)."""
    import torch
    relu, calls = torch.relu, iter(masks)

    def decided(x):
        if not replay:
            masks.append((x > 0).cpu())
            return relu(x)
        return torch.where(next(calls).to(x.device), x, 0.0)
    torch.relu = decided
    try:
        yield
    finally:
        torch.relu = relu


@contextlib.contextmanager
def numpy_keep_masks(seed):
    """The recurrent layers' dropout keep masks (`keep_mask`) drawn from
    numpy seed `seed` in call order, so a card step and a CPU step take the
    same masks."""
    import torch
    from seld_tpu_torch.models import layers
    real, rng = layers.keep_mask, np.random.RandomState(seed)

    def drawn(shape, keep, generator, device, dtype, batch_dim=0):
        m = (rng.rand(*shape) < keep).astype(np.float32) / keep
        return torch.from_numpy(m).to(device=device, dtype=dtype)
    layers.keep_mask = drawn
    try:
        yield
    finally:
        layers.keep_mask = real


def null_leaves(model):
    """Register forward hooks that collect into the returned set the names
    of the parameters whose gradient is zero in exact arithmetic in a
    train-mode step, from the forward's structure: the bias of a conv whose
    output a BatchNorm takes directly (the batch mean absorbs it; a
    Conv2DBN's conv on its fused path too) and attention's key bias
    (softmax ignores a shift shared by all keys)."""
    from seld_tpu_torch.models.layers import (BatchNorm, Conv, Conv2DBN,
                                              MultiHeadAttention)
    name_of = {m: n for n, m in model.named_modules()}
    found, conv_out = set(), {}

    def bias(m, leaf="bias"):
        if getattr(m, leaf, None) is not None:
            found.add(f"{name_of[m]}.{leaf}".lstrip("."))

    def hook(m, args, out):
        if isinstance(m, Conv):
            conv_out[id(out)] = (m, out)    # out kept: its id stays unique
        elif isinstance(m, BatchNorm) and id(args[0]) in conv_out:
            bias(conv_out[id(args[0])][0])
        elif isinstance(m, Conv2DBN) and m.training:
            bias(m.Conv_0)
        elif isinstance(m, MultiHeadAttention):
            bias(m, "k_bias")
    for m in model.modules():
        if isinstance(m, (Conv, BatchNorm, Conv2DBN, MultiHeadAttention)):
            m.register_forward_hook(hook)
    return found


def _one_step(device, batch=8, nulls=None, **model):
    """One f32 bench step at `batch` (SS5, or `model_name`/`cfg` of
    bench.build) with dropouts zeroed on `device`; returns (losses, raw
    gradients, parameters before and after, running stats, learning rate,
    parameter names). With `nulls` a set, the step's null leaves
    (`null_leaves`) are added to it."""
    from seld_tpu_torch.bench import build
    b = build(batch=batch, dtype="fp32", device=device, dropout=False,
              **model)
    found = null_leaves(b.state.model) if nulls is not None else set()
    names = list(b.state.params)
    params = list(b.state.model.parameters())
    before = [p.detach().cpu().clone() for p in params]
    grads = []
    step_fn = b.state.optimizer.step

    def recording_step(ps, gs):
        grads.extend(g.detach().cpu().clone() for g in gs)
        step_fn(ps, gs)
    b.state.optimizer.step = recording_step
    _, _, losses = b.step(b.state, b.metric, b.x, b.y)
    if nulls is not None:
        nulls |= found
    after = [p.detach().cpu() for p in params]
    stats = [v.detach().cpu() for v in b.state.model.buffers()]
    return [v.item() for v in losses], grads, before, after, stats, \
        b.state.optimizer.lr, names


def _cpu_update(params, grads, lr):
    """The bench's optimizer (AdaBelief, AGC 0.01) taking its first step
    on the CPU from `params` with `grads`: the parameters it leaves."""
    from seld_tpu_torch.train.optimizers import adabelief
    params = [p.clone() for p in params]
    adabelief(params, lr, agc_clip=0.01).step(params, grads)
    return params


def _step_agreement(card_run, cpu_run, nulls=None,
                    null_grad=TRAIN_NULL_GRAD):
    """[train] (a)'s rule on two `_one_step` runs, the card's and the
    CPU's: (ok, the line's text). The null leaves are those whose CPU
    gradient stays below null_at = `null_grad` of the step's largest
    element; the card's must stay below that level. With `nulls` (the
    names `null_leaves` found), those are the null leaves, null_at is also
    the rounding floor of every comparison (a gradient agrees to
    TRAIN_GRAD_RTOL of its leaf's largest element plus null_at), and the
    card's updated parameters are held to the CPU optimizer's step taken
    from the card's gradients."""
    lc, gc, p0, pc, sc, lr, names = card_run
    lh, gh, _, ph, sh, _, _ = cpu_run
    loss_err = _max_rel(lc, lh)      # accdoa's SED loss is 0 on both
    null_at = null_grad * max(g.abs().max().item() for g in gh)
    floor = 0.0 if nulls is None else null_at
    null = [n in nulls if nulls is not None else
            g.abs().max().item() < null_at for n, g in zip(names, gh)]
    null_names = [n for n, z in zip(names, null) if z]
    grad_err = max(((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                   .item() for a, b, z in zip(gc, gh, null) if not z)
    grad_share, grad_leaf = max(
        (((a - b).abs().max() / (TRAIN_GRAD_RTOL * b.abs().max() + floor)
          .clamp_min(1e-30)).item(), n)
        for n, a, b, z in zip(names, gc, gh, null) if not z)
    null_max = max([a.abs().max().item() for a, z in zip(gc, null) if z],
                   default=0.0)
    clear_err, move_err = 0.0, 0.0
    for a, b, g, z in zip(pc, ph, gh, null):
        clear = g.abs() > TRAIN_GRAD_RTOL * g.abs().max()
        diff = (a - b).abs()
        if clear.any() and not z:
            clear_err = max(clear_err, diff[clear].max().item())
        move_err = max(move_err, diff.max().item())
    if nulls is not None:     # the card's step against the CPU's on its grads
        clear_err = max((a - b).abs().max().item()
                        for a, b in zip(pc, _cpu_update(p0, gc, lr)))
    stats_err = max(((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                    .item() for a, b in zip(sc, sh))
    moved = max((a - p).abs().max().item() for a, p in zip(pc, p0))
    ok = (loss_err <= TRAIN_LOSS_RTOL and grad_share <= 1.0
          and null_max < null_at
          and all(n.endswith("bias") for n in null_names)
          and clear_err <= TRAIN_PARAM_ATOL and move_err <= 2.3 * lr
          and stats_err <= TRAIN_STATS_RTOL and moved > 0.5 * lr)
    grads = (f"rel_err {grad_err:.2e} (tol {TRAIN_GRAD_RTOL:.0e})"
             if nulls is None else
             f"rel_err {grad_err:.2e}, {grad_share:.2e} of the tolerance "
             f"({TRAIN_GRAD_RTOL:.0e} of the leaf's largest + {floor:.1e}; "
             f"{grad_leaf})")
    listed = ", ".join(null_names if nulls is None or len(null_names) < 5
                       else null_names[:2] + ["..."])
    update = ("where the gradient is clear" if nulls is None else
              "against the CPU optimizer's step on the card's gradients")
    text = (f"losses {lc} rel_err {loss_err:.2e} (tol "
            f"{TRAIN_LOSS_RTOL:.0e}); {len(gc) - len(null_names)} "
            f"gradients {grads}; {len(null_names)} zero in exact "
            f"arithmetic ({listed}) below "
            f"{null_at:.1e} on the card: {null_max:.1e}; updated "
            f"params max_abs_err {clear_err:.2e} {update} (tol "
            f"{TRAIN_PARAM_ATOL:.0e}), {move_err:.2e} "
            f"anywhere (tol {2.3 * lr:.1e}); running stats rel_err "
            f"{stats_err:.2e} (tol {TRAIN_STATS_RTOL:.0e})")
    return ok, text


def phase_train(card):
    import torch
    from seld_tpu_torch.bench import build, gflops_per_window, \
        H100_BF16_PEAK_TFLOPS
    from seld_tpu_torch.ops import kernels

    # (a) one f32 step, card against the CPU through the plain versions
    t0 = time.perf_counter()
    ok, text = _step_agreement(_one_step("cuda"), _one_step("cpu"))
    log("train", f"(a) SS5 full width f32 B=8, one step, card vs cpu: "
                 f"{text}; {time.perf_counter() - t0:.1f} s "
                 f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the f32 train step on the card disagrees with the "
                         "CPU")

    # (b) bf16 steps at B=256 with dropout, through the bench's step
    b = build(batch=256, dtype="bf16", device="cuda")
    state, mstate = b.state, b.metric
    for _ in range(2):                       # warm up, uncounted
        state, mstate, _ = b.step(state, mstate, b.x, b.y)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.launch_counts.clear()
    losses = []
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        state, mstate, (sl, dl) = b.step(state, mstate, b.x, b.y)
        losses += [sl, dl]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: kernels.launch_counts[k] for k in SS5_COUNTED}
    finite = bool(torch.isfinite(torch.stack(losses)).all().item())
    ms_step = wall / TRAIN_STEPS * 1e3
    wps = TRAIN_STEPS * b.batch / wall
    mfu = wps * gflops_per_window(b.cfg) / 1e3 / H100_BF16_PEAK_TFLOPS
    want = {"gru_scan": 2 * TRAIN_STEPS, "gru_scan_bwd": 2 * TRAIN_STEPS,
            "stem_dy": TRAIN_STEPS, "foa_frontend": 0, "gather_rows": 0,
            "batch_norm": SS5_BN_LAUNCHES * TRAIN_STEPS,
            "batch_norm_pool": 0}
    log("train", f"(b) SS5 full width bf16 B=256, {TRAIN_STEPS} steps with "
                 f"dropout: losses finite {finite} (first "
                 f"{losses[0].item():.4f}/{losses[1].item():.4f}, last "
                 f"{losses[-2].item():.4f}/{losses[-1].item():.4f}); "
                 f"launches {counts} (want {want}; each gru_scan_bwd its "
                 f"tensor-core hp and dRk passes); {ms_step:.2f} ms/step, "
                 f"{wps:.1f} windows/s, MFU {mfu:.4f} of "
                 f"{H100_BF16_PEAK_TFLOPS:.0f} TFLOP/s bf16, "
                 f"max_memory_allocated "
                 f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB "
                 f"on {card}")
    if not finite or counts != want:
        raise SystemExit("bf16 training produced a non-finite loss or "
                         "skipped a kernel")
    return counts, train_fused(card)


def train_fused(card):
    """[train] (c): make_train_step(fuse_metrics=True), the single step
    with the metric inside (one CUDA graph: the first call warms up and
    captures, the rest replay), FUSED_CALLS calls against as many unfused
    steps from the same seed on the same batch, SS5 full width bf16 B=256
    dropout on, cuDNN deterministic; then FUSED_TIMED steps of each in
    turns. Returns the fused calls' launch counts."""
    import torch
    from seld_tpu_torch.bench import build
    from seld_tpu_torch.ops import kernels
    torch.backends.cudnn.deterministic = True
    try:
        runs = {"fused": build(batch=256, dtype="bf16", device="cuda",
                               fuse_metrics=True),
                "unfused": build(batch=256, dtype="bf16", device="cuda")}
        losses, launches = {}, {}
        for name, r in runs.items():
            kernels.launch_counts.clear()
            losses[name] = []
            for _ in range(FUSED_CALLS):
                r.state, r.metric, (sl, dl) = r.step(r.state, r.metric,
                                                     r.x, r.y)
                losses[name] += [sl.item(), dl.item()]
            launches[name] = {k: kernels.launch_counts[k]
                              for k in SS5_COUNTED}
        f, u = runs["fused"], runs["unfused"]
        loss_err = _max_rel(losses["fused"], losses["unfused"])
        param_err, stats_err = _state_err(f.state, u.state)
        metric_err = _max_rel([float(f.metric[n].sum()) for n in f.metric],
                              [float(u.metric[n].sum()) for n in u.metric])
        same_gen = torch.equal(f.state.generator.get_state(),
                               u.state.generator.get_state())
    finally:
        torch.backends.cudnn.deterministic = False
    want = {"gru_scan": 2 * FUSED_CALLS, "gru_scan_bwd": 2 * FUSED_CALLS,
            "stem_dy": FUSED_CALLS, "foa_frontend": 0, "gather_rows": 0,
            "batch_norm": SS5_BN_LAUNCHES * FUSED_CALLS,
            "batch_norm_pool": 0}
    ms = {"unfused": [], "fused": []}
    for name in ("unfused", "fused", "fused", "unfused"):
        r = runs[name]

        def run():
            for _ in range(FUSED_TIMED):
                r.state, r.metric, _ = r.step(r.state, r.metric, r.x, r.y)
        ms[name].append(_step_ms(run, FUSED_TIMED))
    ok = (loss_err <= GRAPH_LOSS_RTOL and param_err <= GRAPH_STATE_ATOL
          and stats_err <= GRAPH_STATE_ATOL and metric_err
          <= GRAPH_METRIC_RTOL and same_gen
          and launches["fused"] == launches["unfused"] == want)
    log("train", f"(c) make_train_step(fuse_metrics=True), SS5 full width "
                 f"bf16 B=256 dropout on, {FUSED_CALLS} calls (warm-up and "
                 f"capture, then replays of one graph) against as many "
                 f"unfused steps: losses rel_err {loss_err:.2e}, params "
                 f"max_abs_err {param_err:.2e}, running stats "
                 f"{stats_err:.2e} (tol {GRAPH_LOSS_RTOL:.0e} rel, "
                 f"{GRAPH_STATE_ATOL:.0e} abs), metric sums rel_err "
                 f"{metric_err:.2e} (tol {GRAPH_METRIC_RTOL:.0e}), dropout "
                 f"generators equal {same_gen}; launches fused "
                 f"{launches['fused']}, unfused {launches['unfused']} (want "
                 f"{want}; each gru_scan_bwd its tensor-core hp and dRk "
                 f"passes); ms a step in turns ({FUSED_TIMED} steps a run): "
                 f"unfused {ms['unfused'][0]:.2f}/{ms['unfused'][1]:.2f}, "
                 f"fused {ms['fused'][0]:.2f}/{ms['fused'][1]:.2f} on {card} "
                 f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("[train] (c) the fused single step disagrees with "
                         "the unfused step")
    return {"launches": launches["fused"], "ms": ms}


def _max_rel(a, b):
    return max(abs(x - y) / max(abs(y), 1e-30) for x, y in zip(a, b))


def _state_err(a, b):
    """Largest |a - b| over the parameters and over the running statistics
    of two TrainStates."""
    import torch
    with torch.no_grad():
        p = max((x - y).abs().max().item() for x, y in
                zip(a.model.parameters(), b.model.parameters()))
        s = max((x - y).abs().max().item() for x, y in
                zip(a.model.buffers(), b.model.buffers()))
    return p, s


def _step_ms(run, steps):
    """Host ms per step of `run()`, which runs `steps` steps, ended by a
    synchronize."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps * 1e3


def phase_graph(card):
    """make_train_multistep(k=GRAPH_STEPS), a CUDA graph of one step
    replayed k times a call, against k eager make_train_step calls from
    the same seed: SS5 full width, B=256, bf16, dropout on. Returns the
    launch counts of the timed graph calls."""
    import torch
    from seld_tpu_torch.bench import build
    from seld_tpu_torch.ops import kernels
    k, per_step = GRAPH_STEPS, {"gru_scan": 2, "gru_scan_bwd": 2,
                                "stem_dy": 1, "batch_norm": SS5_BN_LAUNCHES}

    def want(steps):
        return {n: per_step.get(n, 0) * steps for n in SS5_COUNTED}

    def counts():
        return {n: kernels.launch_counts[n] for n in SS5_COUNTED}

    # (a) the same k batches through the graph and eagerly; cuDNN's
    # deterministic algorithms in both, so that the two run the same
    # kernels on the same values
    torch.backends.cudnn.deterministic = True
    try:
        g = build(batch=256, dtype="bf16", device="cuda", steps_per_call=k)
        e = build(batch=256, dtype="bf16", device="cuda")
        xs, (sed, doa) = g.x, g.y
        kernels.launch_counts.clear()
        t0 = time.perf_counter()
        g.state, g.metric, (gs, gd) = g.step(g.state, g.metric, xs,
                                             (sed, doa))
        torch.cuda.synchronize()
        first_s, first = time.perf_counter() - t0, counts()
        eager = []
        for i in range(k):
            e.state, e.metric, (sl, dl) = e.step(e.state, e.metric, xs[i],
                                                 (sed[i], doa[i]))
            eager += [sl.item(), dl.item()]
        graphed = torch.stack([gs, gd], -1).reshape(-1).tolist()
        loss_err = _max_rel(graphed, eager)
        param_err, stats_err = _state_err(g.state, e.state)
        same_gen = torch.equal(g.state.generator.get_state(),
                               e.state.generator.get_state())
        metric_err = _max_rel([float(g.metric[n].sum()) for n in g.metric],
                              [float(e.metric[n].sum()) for n in e.metric])
        # one further eager step on each state draws the same masks
        after = []
        for b in (g, e):
            _, _, (sl, dl) = e.step(b.state, e.metric, xs[0],
                                    (sed[0], doa[0]))
            after.append([sl.item(), dl.item()])
        after_err = _max_rel(after[0], after[1])
        steps_ok = g.state.step == e.state.step == k + 1
    finally:
        torch.backends.cudnn.deterministic = False
    ok = (loss_err <= GRAPH_LOSS_RTOL and after_err <= GRAPH_LOSS_RTOL
          and param_err <= GRAPH_STATE_ATOL
          and stats_err <= GRAPH_STATE_ATOL and same_gen and steps_ok
          and metric_err <= GRAPH_METRIC_RTOL and first == want(k))
    log("graph", f"(a) SS5 full width bf16 B=256 dropout on, "
                 f"make_train_multistep(k={k}) (warm-up step, capture, "
                 f"{k - 1} replays in {first_s:.2f} s) against {k} eager "
                 f"steps: losses rel_err {loss_err:.2e}, params max_abs_err "
                 f"{param_err:.2e}, running stats {stats_err:.2e} (tol "
                 f"{GRAPH_LOSS_RTOL:.0e} rel, {GRAPH_STATE_ATOL:.0e} abs); "
                 f"metric sums rel_err {metric_err:.2e} (tol "
                 f"{GRAPH_METRIC_RTOL:.0e}); dropout generators equal "
                 f"{same_gen}; one more eager step rel_err {after_err:.2e}; "
                 f"launches {first} (want {want(k)}) "
                 f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the graphed steps disagree with the eager steps")

    # (b) times, eager and graphed in turns, and exact counts over
    # replays alone, with cuDNN's default algorithms (as the bench runs):
    # the same states, a graph captured anew
    from seld_tpu_torch.train.steps import make_train_multistep
    multistep = make_train_multistep(steps_per_call=k, **g.step_kwargs)

    def graphed():
        for _ in range(GRAPH_CALLS):
            g.state, g.metric, _ = multistep(g.state, g.metric, xs,
                                             (sed, doa))

    def eager():
        for i in range(GRAPH_CALLS * k):
            e.state, e.metric, _ = e.step(e.state, e.metric, xs[i % k],
                                          (sed[i % k], doa[i % k]))

    g.state, g.metric, _ = multistep(g.state, g.metric, xs, (sed, doa))
    n = GRAPH_CALLS * k
    ms = {"eager": [], "graph": []}
    replays = {name: 0 for name in SS5_COUNTED}
    for name in ("eager", "graph", "graph", "eager"):
        kernels.launch_counts.clear()
        ms[name].append(_step_ms(eager if name == "eager" else graphed, n))
        if name == "graph":
            replays = {m: c + kernels.launch_counts[m]
                       for m, c in replays.items()}
    want_counts = want(2 * n)         # two graphed runs of n steps
    mean = {name: sum(v) / len(v) for name, v in ms.items()}
    log("graph", f"(b) {n} steps a run, eager and graphed in turns: eager "
                 f"{ms['eager'][0]:.2f}/{ms['eager'][1]:.2f} ms/step "
                 f"({256e3 / mean['eager']:.1f} windows/s), graphed "
                 f"{ms['graph'][0]:.2f}/{ms['graph'][1]:.2f} ms/step "
                 f"({256e3 / mean['graph']:.1f} windows/s), "
                 f"{mean['eager'] / mean['graph']:.2f}x; launches {replays} "
                 f"(want {want_counts}; each gru_scan_bwd its tensor-core "
                 f"hp and dRk passes) on {card}")
    if replays != want_counts:
        raise SystemExit("a graph replay skipped a kernel or was counted "
                         "wrongly")
    return replays


def frontend_bound(n, t, n_fft=1024, n_mels=64, hop=480, sample_rate=24000):
    """foa_frontend's bound for n clips of t frames, from the work its
    function needs, not the work the kernel's algorithm does (the DFT as
    two dense products, about 80x an FFT's operations, and a dense
    filterbank). Bytes: the padded wav read and the features written, f32.
    Operations: per frame and channel a real FFT (2.5 N log2 N) and the
    window (N); per bin the power of 4 channels (3 each) and the 3 IV
    components with their norm (18); the filterbank's non-zeros (at most 2
    mels a bin) for the 4 power and 3 IV rows (2 each)."""
    from seld_tpu_torch.ops.frontend import _frontend_constants
    fbank = _frontend_constants(n_fft, n_fft, n_mels, sample_rate)[2]
    nnz = int(np.count_nonzero(fbank))
    bins = n_fft // 2 + 1
    per_frame = (4 * (2.5 * n_fft * math.log2(n_fft) + n_fft)
                 + bins * (4 * 3 + 18) + 7 * nnz * 2)
    lp = (t - 1) * hop + n_fft
    nbytes = (n * 4 * lp + n * 7 * t * n_mels) * 4
    return bound(nbytes, n * t * per_frame)


def frontend_f64(padded, n_fft=1024, win_length=960, hop=480, n_mels=64,
                 sample_rate=24000, eps=1e-8):
    """The front-end's function of the same padded wav in float64 through
    torch.fft: (mel, iv), a yardstick of accuracy only."""
    import torch
    from seld_tpu_torch.ops.frontend import _frontend_constants
    from seld_tpu_torch.ops.stft import _padded_window
    window = _padded_window(n_fft, win_length, device=padded.device).double()
    x = torch.fft.rfft(padded.double().unfold(-1, n_fft, hop) * window)
    fbank = torch.as_tensor(_frontend_constants(
        n_fft, win_length, n_mels, sample_rate)[2],
        device=padded.device).double()
    mel = (x.real ** 2 + x.imag ** 2) @ fbank
    w, xyz = x[:, :1], x[:, [3, 1, 2]]
    del x
    ivc = w.real * xyz.real + w.imag * xyz.imag
    del w, xyz
    iv = (ivc / torch.clamp_min(ivc.norm(dim=1, keepdim=True), eps)) @ fbank
    return mel, iv


def rfft_yardstick_ms(padded, n_fft=1024, win_length=960, hop=480):
    """torch.fft.rfft's time over the front-end's windowed frames
    (materialised beforehand, so only the FFT is timed): the FFT stage of
    the function alone, for scale; the port never calls it."""
    import torch
    from seld_tpu_torch.ops.stft import _padded_window
    window = _padded_window(n_fft, win_length, device=padded.device)
    frames = padded.unfold(-1, n_fft, hop) * window
    ms = cuda_ms(lambda: torch.fft.rfft(frames), 10)
    del frames
    torch.cuda.empty_cache()
    return ms


def phase_kernels_feed(card):
    import torch
    from seld_tpu_torch.ops.frontend import foa_frontend, foa_frontend_ref
    from seld_tpu_torch.ops.gather import gather_batch, gather_batch_ref
    from seld_tpu_torch.ops.mel import amplitude_to_db
    from seld_tpu_torch.ops.stft import reflect_pad

    # foa_frontend: one chunk of 8 clips of 60 s at 24 kHz, int16-quantised
    # noise at levels from -6 to -46 dBFS; the last clip is digital silence
    # from 30 s on, so its last frames must give IV 0 and power 0
    gen = torch.Generator(device="cuda").manual_seed(6)
    n, length = 8, 60 * 24000
    amp = torch.tensor([0.5, 0.1, 0.02, 0.005, 0.5, 0.25, 0.05, 0.01],
                       device="cuda")[:, None, None]
    wav = torch.randn(n, 4, length, generator=gen, device="cuda") * amp
    wav[-1, :, length // 2:] = 0
    wav = (wav * 32767).round().clamp(-32768, 32767) / 32768.0
    padded = reflect_pad(wav, 512).contiguous()
    del wav
    mel, iv = foa_frontend(padded)
    torch.cuda.synchronize()
    mel_r, iv_r = foa_frontend_ref(padded)
    t = mel.shape[2]
    db_err = (amplitude_to_db(mel, clip_dims=1)
              - amplitude_to_db(mel_r, clip_dims=1)).abs().max().item()
    iv_err = (iv - iv_r).abs().max().item()
    silent = 1 + (length // 2 + 512) // 480      # first all-silent frame
    quiet = (mel[-1, :, silent:].abs().max().item(),
             iv[-1, :, silent:].abs().max().item())
    ok = (tuple(mel.shape) == (n, 4, t, 64) and tuple(iv.shape) == (n, 3, t, 64)
          and db_err <= FRONTEND_TOL and iv_err <= FRONTEND_TOL
          and quiet == (0.0, 0.0))
    log("kernels", f"foa_frontend f32 [8, 4, {padded.shape[-1]}] -> T={t}: "
                   f"max_abs_err dB {db_err:.3e} IV {iv_err:.3e} (tol "
                   f"{FRONTEND_TOL:.0e}); silent frames mel/IV max "
                   f"{quiet[0]:.1e}/{quiet[1]:.1e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("foa_frontend disagrees with foa_frontend_ref")
    # both against the function in float64, for which of them is closer
    mel_e, iv_e = frontend_f64(padded)
    db_e = amplitude_to_db(mel_e, clip_dims=1)
    exact = {name: ((amplitude_to_db(m, clip_dims=1).double() - db_e).abs()
                    .max().item(), (v.double() - iv_e).abs().max().item())
             for name, (m, v) in (("kernel", (mel, iv)),
                                  ("plain", (mel_r, iv_r)))}
    log("kernels", "foa_frontend against float64 (torch.fft): max_abs_err "
                   + "; ".join(f"{k} dB {a:.3e} IV {b:.3e}"
                               for k, (a, b) in exact.items()))
    del mel_r, iv_r, mel_e, iv_e, db_e
    ms = cuda_ms(lambda: foa_frontend(padded), 10)
    device_ms = graph_ms(lambda: foa_frontend(padded), 10)
    plain_ms = cuda_ms(lambda: foa_frontend_ref(padded), 3)
    bound_ms, bound_by = frontend_bound(n, t)
    rfft_ms = rfft_yardstick_ms(padded)
    log("kernels", f"foa_frontend one chunk of 8 60-s clips on {card}: "
                   f"kernel_ms {ms:.4f} (device ms {device_ms:.4f}) plain_ms "
                   f"{plain_ms:.4f} library_ms none bound_ms {bound_ms:.5f} "
                   f"({bound_by}); FFT stage alone, torch.fft.rfft over the "
                   f"windowed frames (a yardstick, not the function): "
                   f"{rfft_ms:.4f}")
    entries = [{"name": "foa_frontend", "route": "cuda",
                "source": "seld_tpu_torch/csrc/foa_frontend.cu",
                "replaces": "seld_tpu/ops/pallas/frontend.py:208",
                "also_replaces": "seld_tpu/ops/pallas/frontend.py:150",
                "launches": None, "max_abs_err": max(db_err, iv_err),
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": None,
                "device_ms": device_ms, "rfft_frames_ms": rfft_ms,
                "stream_shapes": stream_frontend_shapes(card)}]
    del padded

    # gather_rows: B=256 ids into 4,000 staged windows [300, 64, 7] (bf16,
    # the path's, and f32, a TDM split's), their labels [60, 48] f32, and a
    # row of 30 bytes, which takes the kernel's byte-wise copy; each alone
    # and as the pairs the feed launches (x and y with one ids row), also
    # with the mic input's 10-channel and the joint input's 17-channel
    # rows (bf16: 384,000 and 652,800 bytes)
    ids = torch.randint(0, 4000, (256,), generator=gen, device="cuda",
                        dtype=torch.int32)
    arrays = {name: torch.randn(shape, generator=gen, device="cuda").to(dt)
              for name, shape, dt in (
                  ("x", (4000, 300, 64, 7), torch.bfloat16),
                  ("x f32", (4000, 300, 64, 7), torch.float32),
                  ("x mic", (4000, 300, 64, 10), torch.bfloat16),
                  ("x joint", (4000, 300, 64, 17), torch.bfloat16),
                  ("y", (4000, 60, 48), torch.float32),
                  ("bytes", (4000, 3, 5), torch.bfloat16))}
    cases = {name: (a,) for name, a in arrays.items()}
    cases["pair"] = (arrays["x"], arrays["y"])
    cases["pair with bytes"] = (arrays["x"], arrays["bytes"])
    for name in ("f32", "mic", "joint"):
        cases[f"pair {name}"] = (arrays[f"x {name}"], arrays["y"])
    rows = {}
    for name, arrs in cases.items():
        got = gather_batch(arrs, ids)
        torch.cuda.synchronize()
        equal = all(torch.equal(a, b)
                    for a, b in zip(got, gather_batch_ref(arrs, ids)))
        ms = cuda_ms(lambda: gather_batch(arrs, ids), 50)
        plain_ms = cuda_ms(lambda: gather_batch_ref(arrs, ids), 50)
        library_ms = cuda_ms(
            lambda: [torch.index_select(a, 0, ids) for a in arrs], 50)
        device_ms = graph_ms(lambda: gather_batch(arrs, ids), 50)
        library_device_ms = graph_ms(
            lambda: [torch.index_select(a, 0, ids) for a in arrs], 50)
        nbytes = sum(2 * ids.numel() * a[0].numel() * a.element_size()
                     for a in arrs) + ids.numel() * 4
        bound_ms, bound_by = bound(nbytes, 0)
        rows[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                          device_ms=device_ms,
                          library_device_ms=library_device_ms,
                          bound_ms=bound_ms, bound_by=bound_by)
        shapes = " + ".join(str(list(a.shape)) for a in arrs)
        log("kernels", f"gather_batch {name} B=256 of {shapes}: exactly "
                       f"equal {equal}; per call ms {ms:.4f}, device ms "
                       f"{device_ms:.4f}; plain_ms {plain_ms:.4f}; "
                       f"index_select x{len(arrs)} per call ms "
                       f"{library_ms:.4f}, device ms {library_device_ms:.4f};"
                       f" bound_ms {bound_ms:.5f} ({bound_by}) on {card}")
        if not equal:
            raise SystemExit(f"gather_batch disagrees with gather_batch_ref "
                             f"({name})")
        del got
    gather_host_us(arrays["x"], arrays["y"], ids)
    x, pair = rows["x"], rows["pair"]
    entries.append({"name": "gather_rows", "route": "cuda",
                    "source": "seld_tpu_torch/csrc/gather_rows.cu",
                    "replaces": "seld_tpu/ops/pallas/gather.py:67",
                    "also_replaces": "seld_tpu/ops/pallas/gather.py:135",
                    "launches": None, "max_abs_err": 0.0,
                    "ms": x["ms"], "plain_ms": x["plain_ms"],
                    "bound_ms": x["bound_ms"], "bound_by": x["bound_by"],
                    "library_ms": x["library_ms"],
                    "device_ms": pair["device_ms"],
                    "x_device_ms": x["device_ms"],
                    "labels_ms": rows["y"]["ms"],
                    "labels_device_ms": rows["y"]["device_ms"],
                    "labels_bound_ms": rows["y"]["bound_ms"],
                    "pair_ms": pair["ms"],
                    "pair_library_ms": pair["library_ms"],
                    "pair_device_library_ms": pair["library_device_ms"],
                    "pair_plain_ms": pair["plain_ms"],
                    "pair_bound_ms": pair["bound_ms"],
                    "f32_ms": rows["x f32"]["ms"],
                    "f32_bound_ms": rows["x f32"]["bound_ms"],
                    **{f"{name}_pair_{key}": rows[f"pair {name}"][key]
                       for name in ("f32", "mic", "joint")
                       for key in ("ms", "device_ms", "plain_ms",
                                   "library_ms", "bound_ms")}})
    del arrays, cases
    torch.cuda.empty_cache()
    return entries


def graph_ms(fn, n):
    """Device time of one call of fn: CUDA events around the replay of a
    CUDA graph of n calls, so the host's per-call work is not in it."""
    import torch
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()                                  # warm up off the graph
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop) / n
    del graph
    torch.cuda.empty_cache()
    return ms


def gather_host_us(x, y, ids, n=300):
    """Host microseconds per call of each piece of a gather wrapper's work,
    on the labels' shape (their copy is 1.8 us at the bytes bound): the
    pieces the lean wrapper dropped (a device switch, a Stream object, a
    row view, torch.empty's arguments) beside those it keeps, and whole
    calls (the x+y pair's host time hides behind its device time). n
    stays under the card's queue of pending launches, so the loop measures
    the host and not the device."""
    import torch
    from seld_tpu_torch.ops import gather as G
    from seld_tpu_torch.ops import kernels
    dev = y.device
    shape = (ids.shape[0],) + tuple(y.shape[1:])

    def device_switch():
        with torch.cuda.device(dev):
            pass
    pieces = {
        "device switch": device_switch,
        "current_stream(dev)": lambda: torch.cuda.current_stream(dev)
        .cuda_stream,
        "current_stream()": lambda: torch.cuda.current_stream().cuda_stream,
        "raw current stream": lambda: kernels.current_stream(dev.index),
        "current_device()": torch.cuda.current_device,
        "x[0].numel()": lambda: y[0].numel(),
        "torch.empty": lambda: torch.empty(shape, dtype=y.dtype, device=dev),
        "new_empty": lambda: y.new_empty(shape),
        "gather_batch(y)": lambda: G.gather_batch((y,), ids),
        "index_select(y)": lambda: torch.index_select(y, 0, ids),
        "gather_batch(x, y)": lambda: G.gather_batch((x, y), ids),
        "index_select(x), (y)": lambda: (torch.index_select(x, 0, ids),
                                         torch.index_select(y, 0, ids)),
    }
    out = {}
    for name, fn in pieces.items():
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        out[name] = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
    log("kernels", "gather host us per call: " + ", ".join(
        f"{k} {v:.2f}" for k, v in out.items()))
    return out


def _event_rows(rng):
    """DCASE-style label rows (frame, class, track, azimuth, elevation) for
    600 frames: a run of events of 10-40 frames, 0-3 frames apart, each
    with a fixed direction, and a shorter second event of another class
    over part of about a third of them. Outside the overlaps each event is
    a single-class run, the stretches TDM banks."""
    rows, fr = [], 0
    while fr < 600:
        length, cls = rng.randint(10, 41), rng.randint(12)
        azi, ele = rng.randint(-180, 180), rng.randint(-45, 46)
        rows += [(f, cls, 0, azi, ele) for f in range(fr, min(fr + length,
                                                              600))]
        if rng.rand() < 0.3:
            start = fr + rng.randint(0, length // 2)
            other = (cls + 1 + rng.randint(11)) % 12
            azi2 = rng.randint(-180, 180)
            rows += [(f, other, 1, azi2, 0) for f in range(
                start, min(start + rng.randint(5, 16), fr + length, 600))]
        fr += length + rng.randint(0, 4)
    return sorted(rows)


def write_wav_tree(root, clips, seconds, seed=0, mic=False, events=False):
    """`clips` {fold: count} 4-channel 24 kHz int16 wavs of `seconds`
    under root/foa_dev (and, with `mic`, root/mic_dev: the same stems,
    independent noise) and DCASE label CSVs (frame, class, track, azimuth,
    elevation) under root/metadata_dev: an event in most 100-ms frames,
    each frame's class drawn anew, or with `events` runs of events
    (`_event_rows`)."""
    import wave
    rng = np.random.RandomState(seed)
    dirs = ("foa_dev", "mic_dev") if mic else ("foa_dev",)
    for sub in dirs + ("metadata_dev",):
        os.makedirs(os.path.join(root, sub))
    n = int(24000 * seconds)
    i = 0
    for fold, count in clips.items():
        for _ in range(count):
            name = f"fold{fold}_room{1 + i % 3}_mix{i:03d}"
            for sub in dirs:
                level = 0.3 * 10.0 ** (-rng.rand())
                data = np.clip(rng.randn(n, 4) * level * 32767, -32768,
                               32767)
                with wave.open(os.path.join(root, sub, f"{name}.wav"),
                               "wb") as w:
                    w.setnchannels(4)
                    w.setsampwidth(2)
                    w.setframerate(24000)
                    w.writeframes(data.astype("<i2").tobytes())
            # the 600 label frames of a 60-s clip, also for a shorter one
            # (padded): a window without an event has a 0/0 DOA loss
            if events:
                rows = _event_rows(rng)
            else:
                rows = [(fr, rng.randint(12), 0, rng.randint(-180, 180),
                         rng.randint(-45, 46))
                        for fr in np.flatnonzero(rng.rand(600) < 0.7)]
            with open(os.path.join(root, "metadata_dev", f"{name}.csv"),
                      "w") as f:
                for row in rows:
                    f.write(",".join(str(v) for v in row) + "\n")
            i += 1


def check_prefetch(card):
    """DeviceIterator, the host loader's path to the card (the CLI without
    --device_data): every batch arrives equal to its host batch, in
    order, with a kernel reading each one on the compute stream."""
    import torch
    from seld_tpu_torch.data.loader import DeviceIterator, SeldDataset
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(40, 300, 64, 7).astype(np.float32)).to(
        torch.bfloat16)
    y = rng.randn(40, 60, 48).astype(np.float32)
    host = list(SeldDataset(x, y, 8, seed=1))
    dev, sums = [], []
    for xb, yb in DeviceIterator(SeldDataset(x, y, 8, seed=1), "cuda"):
        sums.append(xb.float().sum())
        dev.append((xb.cpu(), yb.cpu()))
    torch.cuda.synchronize()
    ok = len(dev) == len(host) == 5 and all(
        torch.equal(a, b) and torch.equal(c, torch.as_tensor(d))
        for (a, c), (b, d) in zip(dev, host))
    log("feed", f"DeviceIterator: {len(dev)} batches through pinned memory "
                f"and a side stream, equal to the host batches {ok} on "
                f"{card}")
    if not ok:
        raise SystemExit("DeviceIterator's batches differ from the host's")


def _feed_run(argv):
    """Run the training CLI's main on the card in the current directory
    with the launch counts at 0; returns (its result, the launch counts)."""
    import torch
    from seld_tpu_torch.ops import kernels
    from seld_tpu_torch.train.main import main as train_main
    kernels.launch_counts.clear()
    out = train_main([*argv, "--device", "cuda"])
    torch.cuda.synchronize()
    return out, {k: kernels.launch_counts[k] for k in COUNTED}


def _frontend_chunks(n_train, n_val, n_test, chunk=8):
    """foa_frontend launches of an FOA extraction of the three splits."""
    return sum(-(-c // chunk) for c in (n_train, n_val, n_test))


def _want_counts(steps, epochs, n_train, n_val, n_test, frontend=None,
                 gru_layers=2):
    """Exact launches of each kernel for a CLI run of `steps` train steps
    over `epochs` epochs: the front-end once per chunk of each split's
    clips (or `frontend` launches); one gather launch (x and y) per batch;
    per train step `gru_layers` GRU forwards and backwards (SS5's DOA
    biGRU: 2; accdoa has none) and 1 stem backward; per eval batch (one
    clip) `gru_layers` GRU forwards."""
    from seld_tpu_torch.data.device_dataset import LAUNCHES_PER_BATCH
    evals = epochs * (n_val + n_test)
    if frontend is None:
        frontend = _frontend_chunks(n_train, n_val, n_test)
    return {"foa_frontend": frontend,
            "gather_rows": LAUNCHES_PER_BATCH * (steps + evals),
            "gru_scan": gru_layers * (steps + evals),
            "gru_scan_bwd": gru_layers * steps, "stem_dy": steps}


def _feed_variant(root, card, label, flags, argv=FEED_ARGV, frontend=None,
                  channels=7, tag="feed", gru_layers=2):
    """One training run of the CLI with `flags` (2 epochs) and its
    --resume; checks the counts (the front-end's: `frontend(epochs run)`,
    else one launch per chunk of each split), the losses, the resumed
    epochs and the normalizer's width (`channels`), logs each epoch's
    windows/s and returns (counts, the run's windows/s, the run's result,
    the resumed run's result)."""
    from seld_tpu_torch.train.checkpoint import latest_best
    clips = FEED_CLIPS
    n_train = sum(c for f, c in clips.items() if f <= 4)
    n_val, n_test = clips[5], clips[6]
    argv = [*argv, "--abspath", root, *flags]
    out, counts = _feed_run(argv)
    trainer = out["trainer"]
    run_dir = os.path.join(root, "saved_model", trainer.config.name)
    best = latest_best(run_dir)
    with open(best + ".meta.json") as f:
        best_epoch = json.load(f)["epoch"]
    resumed, resumed_counts = _feed_run([*argv, "--resume", "--epoch", "3"])
    norm_path = os.path.join(run_dir, "normalizer.npz")
    has_normalizer = os.path.exists(norm_path)
    if has_normalizer:
        with np.load(norm_path) as norm:
            has_normalizer = norm["mean"].shape == (1, 64, channels)
    hist, rhist = out["history"], resumed["history"]
    cfg = trainer.config
    per_epoch = n_train * 10 * cfg.loop_time // cfg.batch   # 10 windows/clip
    windows = per_epoch * cfg.batch
    want = _want_counts(trainer.state.step, len(hist), n_train, n_val,
                        n_test, frontend and frontend(len(hist)), gru_layers)
    rtrainer = resumed["trainer"]
    rwant = _want_counts(rtrainer.state.step - (best_epoch + 1) * per_epoch,
                         len(rhist), n_train, n_val, n_test,
                         frontend and frontend(len(rhist)), gru_layers)
    losses = [h[s][k] for h in hist + rhist for s in ("train", "val")
              for k in ("sedLoss", "doaLoss")]
    finite = all(math.isfinite(v) for v in losses)
    resumed_ok = ([h["epoch"] for h in rhist]
                  == list(range(best_epoch + 1, 3))
                  and rtrainer.start_epoch == best_epoch + 1)
    log(tag, f"{label}: features, normalizer and staging in "
             f"{out['setup_secs']:.2f} s on the card; {channels}-channel "
             f"input {trainer.input_shape == (300, 64, channels)}")
    for h in hist + rhist:
        log(tag, f"{label} epoch {h['epoch']}: {per_epoch} steps of "
                    f"{cfg.batch} in {h['train_secs']:.3f} s, "
                    f"{windows / h['train_secs']:.1f} windows/s through the "
                    f"feed; train sed/doa loss {h['train']['sedLoss']:.4f}/"
                    f"{h['train']['doaLoss']:.4f}, val seld "
                    f"{h['val']['seldScore']:.4f}; epoch with val and test "
                    f"{h['secs']:.3f} s")
    log(tag, f"{label}: launches {counts} (want {want}); best "
             f"checkpoint from epoch {best_epoch}, normalizer.npz "
             f"{channels} wide {has_normalizer}; resumed epochs "
             f"{[h['epoch'] for h in rhist]}, launches {resumed_counts} "
             f"(want {rwant}); losses finite {finite} on {card}")
    if not (finite and counts == want and resumed_counts == rwant
            and trainer.state.step == cfg.epoch * per_epoch == len(hist)
            * per_epoch and has_normalizer and resumed_ok
            and trainer.input_shape == (300, 64, channels)):
        raise SystemExit(f"the wav-native training path ({label}) failed a "
                         "check")
    # the first epoch holds the warm-up (and, with --epoch_scan, the
    # capture): the run's rate is its later epochs'
    later = [h["train_secs"] for h in hist[1:]]
    return counts, windows * len(later) / sum(later), out, resumed


def phase_feed(card):
    """The wav-native training path through the CLI on FEED_CLIPS clips of
    FEED_SECONDS, eagerly and with --epoch_scan [--fuse_metrics]; returns
    {variant: the first run's launch counts}."""
    check_prefetch(card)
    cwd = os.getcwd()
    t_phase = time.perf_counter()
    counts, rates = {}, {}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        write_wav_tree(root, FEED_CLIPS, FEED_SECONDS)
        log("feed", f"{sum(FEED_CLIPS.values())} wavs of {FEED_SECONDS} s "
                    f"written in {time.perf_counter() - t0:.1f} s")
        os.chdir(root)
        try:
            for label, flags in FEED_VARIANTS:
                counts[label], rates[label], _, _ = _feed_variant(
                    root, card, label, flags)
        finally:
            os.chdir(cwd)
    log("feed", "windows/s through the feed after the first epoch: " + ", ".join(
        f"{label} {rate:.1f}" for label, rate in rates.items())
        + f"; phase {time.perf_counter() - t_phase:.1f} s on {card}")
    return counts


class FirstBatches:
    """An augment that records, on the card, the first batch each epoch
    gathers (the device-side step counter n; epoch n // steps) and passes
    the batch on unchanged: device ops only, so it runs inside a captured
    epoch step, and it draws nothing from the generator."""

    def __init__(self, steps, epochs=3):
        self.steps, self.epochs = steps, epochs
        self.x = self.y = self.n = None

    def __call__(self, gen, x, y):
        import torch
        if self.x is None:       # the first step runs eagerly (warm-up)
            self.x = x.new_zeros((self.epochs, *x.shape))
            self.y = y.new_zeros((self.epochs, *y.shape))
            self.n = torch.zeros(1, dtype=torch.int64, device=x.device)
        e = torch.clamp(self.n // self.steps, max=self.epochs - 1)
        first = (self.n % self.steps) == 0
        for buf, new in ((self.x, x), (self.y, y)):
            old = torch.index_select(buf, 0, e)[0]
            buf.index_copy_(0, e, torch.where(first, new, old)[None])
        self.n.add_(1)
        return x, y


def _tdm_variant(root, card, steps):
    """--use_tdm --tdm_epoch 1 --epoch_scan: a rebuild and a restage each
    epoch. Besides _feed_variant's checks: each epoch's first gathered
    batch (recorded inside the replayed epoch step) equals the host's
    gather from that epoch's split at the epoch's first index row, and
    differs from the old split's; each rebuild's seconds by part, its
    foa_frontend device ms (CUDA events around each launch) and the
    epoch step's warm-up + capture seconds; the card's allocated bytes
    before and after each staging."""
    import torch
    from seld_tpu_torch.data import tdm_pipeline
    from seld_tpu_torch.data.transforms import compose
    from seld_tpu_torch.ops import features
    from seld_tpu_torch.train import graphs
    from seld_tpu_torch.train import main as cli

    probes, staged, frontend_ms, captures = [], [], [], []
    events = []

    def probing_augment(config):
        probes.append(FirstBatches(steps))
        real = orig["build_augment"](config)
        return probes[-1] if real is None else compose(probes[-1], real)

    base = cli.DeviceDataset

    class Recording(base):
        def __init__(self, x, y, *args, train=True, **kwargs):
            before = torch.cuda.memory_allocated()
            super().__init__(x, y, *args, train=train, **kwargs)
            self.record = None
            if train:
                # was the split staged before this one freed first?
                old_freed = (staged[-1]["staged_x"]() is None
                             if staged else None)
                self.record = {"run": len(probes) - 1, "x": x, "y": y,
                               "before": before,
                               "after": torch.cuda.memory_allocated(),
                               "bytes": self.hbm_bytes(),
                               "staged_x": weakref.ref(self.device_arrays[0]),
                               "old_freed": old_freed}
                staged.append(self.record)

        def epoch_index_matrix(self):
            idx = super().epoch_index_matrix()
            if self.record is not None:
                self.record["idx"] = idx.cpu()
            return idx

    def timed_frontend(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = orig["fused_foa_frontend"](*args, **kwargs)
        stop.record()
        events.append((start, stop))
        return out

    def timed_extract(*args, **kwargs):
        events.clear()
        out = orig["extract_clip_features"](*args, **kwargs)
        torch.cuda.synchronize()
        frontend_ms.append((len(events), sum(a.elapsed_time(b)
                                             for a, b in events)))
        return out

    def timed_capture(self):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        orig["capture"](self)
        torch.cuda.synchronize()
        captures.append(time.perf_counter() - t0)

    orig = {"build_augment": cli.build_augment,
            "fused_foa_frontend": features.fused_foa_frontend,
            "extract_clip_features": tdm_pipeline.extract_clip_features,
            "capture": graphs.StepGraph._warm_up_and_capture}
    n_train = sum(c for f, c in FEED_CLIPS.items() if f <= 4)
    static = _frontend_chunks(n_train, FEED_CLIPS[5], FEED_CLIPS[6])
    cli.build_augment, cli.DeviceDataset = probing_augment, Recording
    features.fused_foa_frontend = timed_frontend
    tdm_pipeline.extract_clip_features = timed_extract
    graphs.StepGraph._warm_up_and_capture = timed_capture
    try:
        result = _feed_variant(
            root, card, "tdm", ["--name", "smoke_tdm", "--use_tdm",
                                "--tdm_epoch", "1", "--epoch_scan"],
            frontend=lambda epochs: static + epochs * -(-n_train // 8),
            tag="tdm")
    finally:
        cli.build_augment, cli.DeviceDataset = orig["build_augment"], base
        features.fused_foa_frontend = orig["fused_foa_frontend"]
        tdm_pipeline.extract_clip_features = orig["extract_clip_features"]
        graphs.StepGraph._warm_up_and_capture = orig["capture"]
    _, _, out, resumed = result

    # the replayed epochs read the new splits
    ok, first_run = True, [r for r in staged if r["run"] == 0]
    for e, rec in enumerate(first_run):
        ids = rec["idx"][0].long().numpy()
        got_x = probes[0].x[e].cpu()
        want_x = torch.as_tensor(rec["x"][ids])
        same = (torch.equal(got_x, want_x) and torch.equal(
            probes[0].y[e].cpu(), torch.as_tensor(rec["y"][ids])))
        stale = e > 0 and torch.equal(
            got_x, torch.as_tensor(first_run[e - 1]["x"][ids]))
        ok &= same and not stale and rec["old_freed"] in (None, True)
        log("tdm", f"epoch {e}: the replayed epoch step's first batch "
                   f"equals the host's gather from split {e} {same}, from "
                   f"split {e - 1} {stale if e else 'n/a'}; staged "
                   f"{rec['bytes'] / 1e9:.3f} GB (x f32 "
                   f"{tuple(rec['x'].shape)}), the split before it freed "
                   f"first {rec['old_freed']}, card allocated "
                   f"{rec['before'] / 1e9:.3f} GB before the staging, "
                   f"{rec['after'] / 1e9:.3f} GB after")
    rebuilds = out["tdm_rebuilds"] + resumed["tdm_rebuilds"]
    hist = out["history"] + resumed["history"]
    timing = []
    for r, (launches, ms), cap, h in zip(rebuilds, frontend_ms, captures,
                                         hist):
        row = {**r, "foa_frontend_launches": launches,
               "frontend_device_ms": ms, "capture_s": cap,
               "train_s": h["train_secs"]}
        timing.append(row)
        log("tdm", f"rebuild for epoch {r['epoch']}: paste {r['paste_s']:.3f}"
                   f" s (host), extract {r['extract_s']:.3f} s (card: "
                   f"{launches} foa_frontend launches, the front-end "
                   f"wrapper's device ms (pad, kernel, dB, layout) "
                   f"{ms:.3f}), "
                   f"normalize + window {r['normalize_window_s']:.3f} s "
                   f"(host), restage {r['restage_s']:.3f} s, warm-up + "
                   f"capture {cap:.3f} s; the epoch's train "
                   f"{h['train_secs']:.3f} s (capture included) on {card}")
    counts_ok = (len(rebuilds) == len(frontend_ms) == len(hist)
                 and len(captures) == len(hist)
                 and len(first_run) == len(out["history"]) == 2)
    if not (ok and counts_ok):
        raise SystemExit("a TDM restage failed its check (the replayed "
                         "epoch read another split, or a rebuild was "
                         "missed)")
    return result[0], result[1], timing


def phase_tdm_mic(card):
    """TDM and the microphone-array inputs through the training CLI at SS5
    full width: FEED_CLIPS clips of FEED_SECONDS under foa_dev and mic_dev
    (the same stems, independent noise), labels in runs of events;
    --use_tdm --tdm_epoch 1 --epoch_scan (a rebuild and a restage each
    epoch), --from_wav --wav_mode mic (10 channels; no foa_frontend
    launch) and --use_both --use_acs --epoch_scan (17 channels; the FOA
    half's foa_frontend launches only), each with its --resume. Returns
    {variant: (the first run's launch counts, windows/s)} and the TDM
    rebuilds' timing."""
    cwd = os.getcwd()
    t_phase = time.perf_counter()
    n_train = sum(c for f, c in FEED_CLIPS.items() if f <= 4)
    flag = {k: int(v) for k, v in zip(FEED_ARGV, FEED_ARGV[1:])
            if k in ("--batch", "--loop_time")}
    steps = n_train * 10 * flag["--loop_time"] // flag["--batch"]
    no_acs = [a for a in FEED_ARGV if a != "--use_acs"]
    out = {}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        write_wav_tree(root, FEED_CLIPS, FEED_SECONDS, seed=1, mic=True,
                       events=True)
        log("tdm", f"{sum(FEED_CLIPS.values())} clips of {FEED_SECONDS} s "
                   f"under foa_dev and mic_dev written in "
                   f"{time.perf_counter() - t0:.1f} s")
        os.chdir(root)
        try:
            counts, rate, timing = _tdm_variant(root, card, steps)
            out["tdm"] = (counts, rate)
            for label, flags, argv, channels, frontend in (
                    ("mic", ["--name", "smoke_mic", "--wav_mode", "mic"],
                     no_acs, 10, lambda epochs: 0),
                    ("joint", ["--name", "smoke_joint", "--use_both",
                               "--epoch_scan"], FEED_ARGV, 17, None)):
                counts, rate, _, _ = _feed_variant(
                    root, card, label, flags, argv=argv, frontend=frontend,
                    channels=channels, tag="mic")
                out[label] = (counts, rate)
        finally:
            os.chdir(cwd)
    log("tdm", "windows/s through the feed after the first epoch: "
               + ", ".join(f"{k} {r:.1f}" for k, (_, r) in out.items())
               + f"; phase {time.perf_counter() - t_phase:.1f} s on {card}")
    return out, timing


def _max_err(got, want):
    """Largest |got - want| over lists of (sed, doa) pairs, on the host."""
    return max(max((g.float().cpu() - w.float().cpu()).abs().max().item()
                   for g, w in zip(gp, wp))
               for gp, wp in zip(got, want))


def _gru_at_clip_shape(rng, b, card):
    """gru_scan held against gru_scan_ref at a clip path's batch shape
    [2, 60, b, 384] f32; its time, plain and library (cuDNN) times and
    bound."""
    from seld_tpu_torch.ops.gru import _fwd_plan, gru_scan, gru_scan_ref
    xp, rk, rb = _gru_inputs(rng, 2, 60, b, 128, "float32")
    hs = gru_scan(xp, rk, rb)
    ref = gru_scan_ref(xp, rk, rb)
    err = (hs - ref).abs().max().item()
    if err > GRU_TOL["float32"]:
        raise SystemExit(f"gru_scan disagrees with gru_scan_ref at B={b}: "
                         f"{err:.3e}")
    ms = cuda_ms(lambda: gru_scan(xp, rk, rb), 50)
    plain_ms = cuda_ms(lambda: gru_scan_ref(xp, rk, rb), 3)
    library_ms = cuda_ms(cudnn_gru(xp, rk, rb), 50)
    bound_ms, bound_by = gru_scan_bound(xp, rk, rb)
    plan = _fwd_plan(2, b, 128)
    log("clip", f"gru_scan f32 D=2 T=60 B={b} U=128: max_abs_err {err:.3e} "
                f"(tol {GRU_TOL['float32']:.0e}), kernel_ms {ms:.4f} "
                f"({_plan_text(plan)}) plain_ms {plain_ms:.4f} library_ms "
                f"(cuDNN GRU) {library_ms:.4f} bound_ms {bound_ms:.5f} "
                f"({bound_by}) on {card}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "plan": _plan_json(plan)}


def _counted(run):
    """run() with the launch counts set to 0 before and read after (the
    COUNTED kernels')."""
    import torch
    from seld_tpu_torch.ops import kernels
    kernels.launch_counts.clear()
    out = run()
    torch.cuda.synchronize()
    return out, {k: v for k, v in kernels.launch_counts.items()
                 if k in COUNTED}


def phase_clip(card):
    """Clip scoring at SS5 full width; returns gru_scan's clip-shape
    measurements and its launches on the exact and fast paths."""
    import torch
    from seld_tpu_torch.config import get_model_config
    from seld_tpu_torch.inference import (ensemble_outputs,
                                          export_clip_fast,
                                          export_clip_fast_ensemble,
                                          load_exported)
    from seld_tpu_torch.inference.quantize import (dequantize_tree,
                                                   quantize_tree)
    from seld_tpu_torch.models import build_model
    from seld_tpu_torch.serving import SELDClient, SELDServer
    from seld_tpu_torch.serving.server import serve

    rng = np.random.RandomState(8)
    n_win = (CLIP_FRAMES - 300) // 5 + 1
    fast_rows = -(-n_win // 8) * 8
    shapes = {"exact": CLIP_BATCH, "fast": fast_rows,
              "fast_clip_batch4": -(-CLIP_COUNT * n_win // 8) * 8}
    gru = {name: _gru_at_clip_shape(rng, b, card)
           for name, b in shapes.items()}

    cfg = get_model_config("SS5", search_paths=[])
    cfg["n_classes"] = 12
    gpu = build_model("conv_temporal", (300, 64, 7), cfg, seed=0,
                      device="cuda")
    cpu = build_model("conv_temporal", (300, 64, 7), cfg, seed=0,
                      device="cpu")
    clips = [torch.from_numpy(rng.randn(CLIP_FRAMES, 64, 7).astype(
        np.float32)) for _ in range(CLIP_COUNT)]
    on_card = [c.cuda() for c in clips]

    def score(model, xs, **kw):
        return ensemble_outputs(model, xs, batch_size=CLIP_BATCH,
                                time_down=5, **kw)

    # the main path, counted: the exact and the fast path on the card
    t0 = time.perf_counter()
    exact, exact_counts = _counted(lambda: score(gpu, on_card))
    exact_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fast, fast_counts = _counted(lambda: score(gpu, on_card, fast=True))
    fast_s = time.perf_counter() - t0
    batched, batched_counts = _counted(
        lambda: score(gpu, on_card, fast=True, clip_batch=CLIP_COUNT))
    launches = {"exact": exact_counts.get("gru_scan", 0),
                "fast": fast_counts.get("gru_scan", 0),
                "fast_clip_batch4": batched_counts.get("gru_scan", 0)}
    chunks = -(-n_win // CLIP_BATCH)
    want = {"exact": 2 * chunks * CLIP_COUNT, "fast": 2 * CLIP_COUNT,
            "fast_clip_batch4": 2}
    others = {k: v for c in (exact_counts, fast_counts, batched_counts)
              for k, v in c.items() if k != "gru_scan" and v}
    if launches != want or others:
        raise SystemExit(f"clip path launches {launches} (want {want}), "
                         f"other kernels {others}")
    for sed, doa in exact + fast + batched:
        labels = CLIP_FRAMES // 5
        if tuple(sed.shape) != (labels, 12) or \
                tuple(doa.shape) != (labels, 36) \
                or not (torch.isfinite(sed).all() and
                        torch.isfinite(doa).all()):
            raise SystemExit(f"clip outputs {tuple(sed.shape)}, "
                             f"{tuple(doa.shape)} or not finite")

    # the card against the CPU: the exact path on one clip, the fast path
    # on two
    t0 = time.perf_counter()
    exact_err = _max_err(exact[:1], score(cpu, clips[:1]))
    fast_err = _max_err(fast[:2], score(cpu, clips[:2], fast=True))
    cpu_s = time.perf_counter() - t0
    batch_err = _max_err(batched, fast)

    # the fast path equals the exact one where it must: a one-window clip,
    # and the trunk's frames away from a window's edges
    one = [on_card[0][:300]]
    one_err = _max_err(score(gpu, one, fast=True), score(gpu, one))
    with torch.inference_mode():
        trunk = gpu(on_card[1][None], stage="trunk")[0]
        interior_err = 0.0
        last = CLIP_FRAMES - 300
        for start in (0, last // 10 * 5, last):
            window = gpu(on_card[1][None, start:start + 300],
                         stage="trunk")[0]
            lo, hi = CLIP_INTERIOR, 60 - CLIP_INTERIOR
            interior_err = max(interior_err, (
                trunk[start // 5 + lo:start // 5 + hi] - window[lo:hi]
            ).abs().max().item())
    fast_vs_exact = _max_err(fast, exact)
    corr = float(np.corrcoef(
        torch.cat([d.flatten() for _, d in fast]).cpu().numpy(),
        torch.cat([d.flatten() for _, d in exact]).cpu().numpy())[0, 1])
    log("clip", f"{CLIP_COUNT} clips of {CLIP_FRAMES} frames ({n_win} "
                f"windows): exact {exact_s * 1e3 / CLIP_COUNT:.1f} ms/clip, "
                f"fast {fast_s * 1e3 / CLIP_COUNT:.1f} ms/clip (first runs, "
                f"host clock); card vs cpu max_abs_err exact {exact_err:.3e}"
                f", fast {fast_err:.3e} (tol {MODEL_TOL:.0e}; cpu "
                f"{cpu_s:.1f} s); clip_batch={CLIP_COUNT} vs one at a time "
                f"{batch_err:.3e}; fast vs exact: one-window clip "
                f"{one_err:.3e}, trunk interior {interior_err:.3e}, whole "
                f"clips {fast_vs_exact:.3e} (doa corr {corr:.5f}); gru_scan "
                f"launches {launches}")
    if max(exact_err, fast_err, batch_err, one_err, interior_err) \
            > MODEL_TOL:
        raise SystemExit("a clip path disagrees with its reference")

    # artifacts: a clip artifact, a two-member clip ensemble, int8 weights
    other = build_model("conv_temporal", (300, 64, 7), cfg, seed=1,
                        device="cuda")
    fast2 = score(other, on_card[:1], fast=True)
    deq = copy.deepcopy(gpu)
    deq.load_state_dict(dequantize_tree(quantize_tree(gpu.state_dict(),
                                                      "int8")))
    with tempfile.TemporaryDirectory() as tmp:
        paths = {
            "clip": export_clip_fast(gpu, f"{tmp}/clip.npz", CLIP_FRAMES,
                                     time_down=5),
            "ensemble": export_clip_fast_ensemble(
                [gpu, other], f"{tmp}/ens.npz", CLIP_FRAMES,
                time_downs=[5, 5]),
            "int8": export_clip_fast(gpu, f"{tmp}/int8.npz", CLIP_FRAMES,
                                     time_down=5, quantize="int8")}
        arts = {k: load_exported(p, device="cuda") for k, p in paths.items()}
        x0 = clips[0]
        art_err = max(np.abs(g - w.cpu().numpy()).max() for g, w in
                      zip(arts["clip"].call(x0), fast[0]))
        ens_want = [(a + b) / 2 for a, b in zip(fast[0], fast2[0])]
        ens_err = max(np.abs(g - w.cpu().numpy()).max() for g, w in
                      zip(arts["ensemble"].call(x0), ens_want))
        int8_out = arts["int8"].call(x0)
        int8_deq_err = _max_err([tuple(torch.from_numpy(o)
                                       for o in int8_out)],
                                score(deq, on_card[:1], fast=True))
        int8_err = max(np.abs(g - w.cpu().numpy()).max() for g, w in
                       zip(int8_out, fast[0]))
        sizes = {k: a.meta["bytes"] for k, a in arts.items()}

        # a served clip artifact: its reply against the direct call
        server = SELDServer(artifact=paths["clip"], batch_window_ms=2.0,
                            device="cuda")
        httpd = serve(server, "127.0.0.1", 0)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        try:
            client = SELDClient("127.0.0.1", httpd.server_address[1],
                                timeout=600)
            health = client.health()
            reply = client.score(clips[2].numpy())
        finally:
            httpd.shutdown()
            server.close()
            httpd.server_close()
            thread.join(timeout=10)
        reply_err = max(np.abs(g - w).max() for g, w in
                        zip(reply, arts["clip"].call(clips[2])))

    bf16_model = copy.deepcopy(gpu).to(torch.bfloat16)
    bf16_out, bf16_counts = _counted(lambda: score(
        bf16_model, [c.to(torch.bfloat16) for c in on_card[:1]], fast=True))
    bf16_err = _max_err(bf16_out, fast[:1])
    log("clip", f"clip artifact vs direct {art_err:.3e}, two-member "
                f"ensemble vs the average {ens_err:.3e}, int8 artifact vs "
                f"dequantised model {int8_deq_err:.3e} (tol {MODEL_TOL:.0e})"
                f", int8 vs f32 {int8_err:.3e} (tol {INT8_TOL:.0e}), bf16 "
                f"vs f32 {bf16_err:.3e} (tol {BF16_TOL:.0e}; gru_scan "
                f"launches {bf16_counts.get('gru_scan', 0)}), served reply "
                f"vs direct {reply_err:.3e} (tol {REPLY_TOL:.0e}); artifact "
                f"bytes {sizes}; healthz units {health.get('units')}")
    if max(art_err, ens_err, int8_deq_err, reply_err) > MODEL_TOL or \
            int8_err > INT8_TOL or bf16_err > BF16_TOL or \
            health.get("units") != ["clip"] or \
            bf16_counts.get("gru_scan", 0) != 2:
        raise SystemExit("a clip artifact, the quantised or bf16 path or "
                         "the served clip disagrees")
    return {"gru": gru, "launches": launches}


def _stream_gru(rng, b, dtype, card):
    """gru_scan against gru_scan_ref at a stream head's batch [2, 60, b,
    384], its times, cuDNN's f32 GRU on the same values and its bound."""
    from seld_tpu_torch.ops.gru import _fwd_plan, gru_scan, gru_scan_ref
    xp, rk, rb = _gru_inputs(rng, 2, 60, b, 128, dtype)
    hs = gru_scan(xp, rk, rb)
    err = (hs.float() - gru_scan_ref(xp, rk, rb).float()).abs().max().item()
    if err > GRU_TOL[dtype] or hs.dtype != xp.dtype:
        raise SystemExit(f"gru_scan disagrees with gru_scan_ref at {dtype} "
                         f"B={b}: {err:.3e}")
    ms = cuda_ms(lambda: gru_scan(xp, rk, rb), 100)
    device_ms = graph_ms(lambda: gru_scan(xp, rk, rb), 50)
    plain_ms = cuda_ms(lambda: gru_scan_ref(xp, rk, rb), 5)
    library_ms = cuda_ms(cudnn_gru(xp, rk, rb), 100)
    bound_ms, bound_by = gru_scan_bound(xp, rk, rb)
    plan = _fwd_plan(2, b, 128)
    log("kernels", f"gru_scan (stream head) {dtype} D=2 T=60 B={b} U=128: "
                   f"max_abs_err "
                   f"{err:.3e} (tol {GRU_TOL[dtype]:.1e}), kernel_ms "
                   f"{ms:.4f} (device ms {device_ms:.4f}; "
                   f"{_plan_text(plan)}) plain_ms {plain_ms:.4f} "
                   f"library_ms (cuDNN GRU, f32) {library_ms:.4f} bound_ms "
                   f"{bound_ms:.5f} ({bound_by}) on {card}")
    return {"max_abs_err": err, "ms": ms, "device_ms": device_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "plan": _plan_json(plan)}


def _stream_wav():
    """The [stream] phase's seeded 60-s 24 kHz FOA wav, int16-quantised
    noise at -26 dBFS, float32 [4, T]."""
    gen = np.random.RandomState(10)
    wav = gen.randn(4, STREAM_SECONDS * 24000) * 0.05 * 32767
    return wav.round().clip(-32768, 32767).astype(np.float32) / 32768.0


def stream_frontend_shapes(card):
    """(a) of [stream]: foa_frontend at the shapes a stream gives it, on
    the phase's wav: a push's segment (chunk + 2 edge frames = 54 frames of
    hop, 55 frames out), the right-aligned tail (as long) and a short clip
    (1 s, the front-end's one-extraction path)."""
    import torch
    wav = torch.from_numpy(_stream_wav()).cuda()
    seg = (STREAM_PUSH + 2 * 2) * 480
    return {name: _stream_frontend(name, w, card) for name, w in (
        ("push segment", wav[:, :seg]), ("tail", wav[:, -seg:]),
        ("short clip", wav[:, :24000]))}


def _stream_frontend(name, wav, card):
    """foa_frontend against foa_frontend_ref on one reflect-padded segment
    [1, 4, L + 1024] of a stream, its times, the rfft yardstick and its
    bound."""
    from seld_tpu_torch.ops.frontend import foa_frontend, foa_frontend_ref
    from seld_tpu_torch.ops.mel import amplitude_to_db
    from seld_tpu_torch.ops.stft import reflect_pad
    padded = reflect_pad(wav[None], 512).contiguous()
    mel, iv = foa_frontend(padded)
    mel_r, iv_r = foa_frontend_ref(padded)
    t = mel.shape[2]
    err = max((amplitude_to_db(mel, clip_dims=1)
               - amplitude_to_db(mel_r, clip_dims=1)).abs().max().item(),
              (iv - iv_r).abs().max().item())
    if err > FRONTEND_TOL:
        raise SystemExit(f"foa_frontend disagrees with foa_frontend_ref at "
                         f"the stream's {name} ({t} frames): {err:.3e}")
    ms = cuda_ms(lambda: foa_frontend(padded), 50)
    device_ms = graph_ms(lambda: foa_frontend(padded), 50)
    plain_ms = cuda_ms(lambda: foa_frontend_ref(padded), 10)
    rfft_ms = rfft_yardstick_ms(padded)
    bound_ms, bound_by = frontend_bound(1, t)
    log("kernels", f"foa_frontend (stream) f32 {name} [1, 4, "
                   f"{padded.shape[-1]}] -> T={t}: max_abs_err (dB, IV) "
                   f"{err:.3e} (tol {FRONTEND_TOL:.0e}), kernel_ms {ms:.4f} "
                   f"(device ms {device_ms:.4f}) plain_ms {plain_ms:.4f} "
                   f"bound_ms {bound_ms:.5f} ({bound_by}); torch.fft.rfft "
                   f"over the windowed frames {rfft_ms:.4f} on {card}")
    return {"frames": t, "max_abs_err": err, "ms": ms,
            "device_ms": device_ms, "plain_ms": plain_ms,
            "rfft_frames_ms": rfft_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


def _stream_frames(engine, clip, push=STREAM_PUSH):
    """(sed, doa) host arrays of every frame a clip ([T, F, C], or [N, T,
    F, C] for lockstep streams, then [N, T', ...]) emits, pushed `push`
    frames at a time, then finalized."""
    engine.reset()
    out = []
    for lo in range(0, clip.shape[-3], push):
        out.extend(engine.push(clip[..., lo:lo + push, :, :]))
    out.extend(engine.finalize())
    axis = 0 if engine.n_streams == 1 else 1
    return (np.stack([s for s, _ in out], axis=axis),
            np.stack([d for _, d in out], axis=axis))


def _frames_err(got, want):
    return max(float(np.abs(np.asarray(g, np.float32)
                            - np.asarray(w, np.float32)).max())
               for g, w in zip(got, want))


def _stream_session(client, sid, clip, out, push=STREAM_PUSH):
    """One /v1/stream session over a whole clip: `out[sid]` = (sed, doa)."""
    seds, doas = [], []
    for lo in range(0, clip.shape[0], push):
        sed, doa = client.stream_push(sid, clip[lo:lo + push])
        seds.extend(sed)
        doas.extend(doa)
    sed, doa = client.stream_finalize(sid)
    out[sid] = (np.stack(seds + list(sed)), np.stack(doas + list(doa)))


def _push_syncs(engine, clip):
    """The synchronizing CUDA calls of one steady-state push, as torch's
    sync debug mode reports them (warn): the push's copies in and out and
    any the model makes."""
    import warnings

    import torch
    from seld_tpu_torch import stream_demo
    engine.reset()
    n_boot = stream_demo.boot_pushes(engine)
    for lo in range(0, (n_boot + 1) * STREAM_PUSH, STREAM_PUSH):
        if lo == n_boot * STREAM_PUSH:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    engine.push(clip[..., lo:lo + STREAM_PUSH, :, :])
            finally:
                torch.cuda.set_sync_debug_mode("default")
        else:
            engine.push(clip[..., lo:lo + STREAM_PUSH, :, :])
    return sum("synchroniz" in str(w.message) for w in caught)


def phase_stream(card):
    """Real-time streaming at SS5 full width (module docstring, phase 12);
    returns the kernels' stream-shape measurements and the launches of the
    counted runs."""
    import torch
    from seld_tpu_torch import stream_demo
    from seld_tpu_torch.config import get_model_config
    from seld_tpu_torch.inference import (StreamingSELD, StreamingSELDWav,
                                          ensemble_outputs,
                                          export_streaming,
                                          measure_trunk_halo)
    from seld_tpu_torch.models import build_model
    from seld_tpu_torch.ops.features import extract_features
    from seld_tpu_torch.serving import SELDClient, SELDServer
    from seld_tpu_torch.serving.server import serve

    t_phase = time.perf_counter()
    rng = np.random.RandomState(9)
    wav = _stream_wav()
    wav_card = torch.from_numpy(wav).cuda()
    seconds = wav.shape[1]

    # (b) the engine on a 60-s feature clip (the kernels at the stream's
    # shapes, (a), are held in phase 3)
    cfg = get_model_config("SS5", search_paths=[])
    cfg["n_classes"] = 12
    gpu = build_model("conv_temporal", (300, 64, 7), cfg, seed=0,
                      device="cuda")
    cpu = build_model("conv_temporal", (300, 64, 7), cfg, seed=0,
                      device="cpu")
    frames = STREAM_SECONDS * 50
    clips = rng.randn(STREAM_N, frames, 64, 7).astype(np.float32)
    clip = clips[0]
    t0 = time.perf_counter()
    engine = StreamingSELD(gpu, (64, 7))
    halo_s = time.perf_counter() - t0
    halo_cpu = measure_trunk_halo(cpu, (64, 7), 5)
    head_calls = 1 + (frames - engine.l_f) // engine.chunk_f + 1
    (sed, doa), counts = _counted(lambda: _stream_frames(engine, clip))
    want_counts = {"gru_scan": 2 * head_calls}
    got_counts = {k: v for k, v in counts.items() if v}
    fast = ensemble_outputs(gpu, [clip], fast=True, batch_size=CLIP_BATCH)[0]
    fast = tuple(f.cpu().numpy() for f in fast)
    fast_err = _frames_err((sed, doa), fast)
    short = clip[:STREAM_CHECK_SECONDS * 50]
    card_vs_cpu = _frames_err(
        _stream_frames(engine, short),
        _stream_frames(StreamingSELD(cpu, (64, 7), halo=engine.halo_t),
                       short))
    ok = (sed.shape == (frames // 5, 12) and doa.shape == (frames // 5, 36)
          and np.isfinite(sed).all() and np.isfinite(doa).all())
    log("stream", f"halo {engine.halo_t} trunk frames on the card "
                  f"({halo_s:.2f} s), {halo_cpu} on the CPU; l_f "
                  f"{engine.l_f}; {sed.shape[0]} of {frames // 5} frames "
                  f"emitted; against the fast path on the card "
                  f"{fast_err:.3e}, a {STREAM_CHECK_SECONDS}-s stream card "
                  f"vs CPU {card_vs_cpu:.3e} (tol {MODEL_TOL:.0e}); "
                  f"launches {got_counts} (want {want_counts}: 2 a head "
                  f"call, {head_calls} head calls)")
    if not ok or max(fast_err, card_vs_cpu) > MODEL_TOL or \
            got_counts != want_counts or engine.halo_t != halo_cpu:
        raise SystemExit("the stream disagrees with the fast path or the "
                         "CPU, or launched other kernels than gru_scan's "
                         f"{want_counts}")

    engine4 = StreamingSELD(gpu, (64, 7), halo=engine.halo_t,
                            n_streams=STREAM_N)
    (sed4, doa4), counts4 = _counted(lambda: _stream_frames(engine4, clips))
    singles = [(sed, doa)] + [_stream_frames(engine, c) for c in clips[1:]]
    lock_err = max(_frames_err((sed4[k], doa4[k]), singles[k])
                   for k in range(STREAM_N))
    bf16_model = copy.deepcopy(gpu).to(torch.bfloat16)
    try:
        bf16_halo = measure_trunk_halo(bf16_model, (64, 7), 5,
                                       dtype=torch.bfloat16)
    except ValueError as e:     # a measurement: recorded, not a failure
        bf16_halo = f"raised: {e}"
    engine_bf16 = StreamingSELD(bf16_model, (64, 7), halo=engine.halo_t,
                                dtype=torch.bfloat16)
    bf16_out, bf16_counts = _counted(lambda: _stream_frames(engine_bf16,
                                                            clip))
    bf16_err = _frames_err(bf16_out, (sed, doa))
    log("stream", f"{STREAM_N} lockstep streams vs {STREAM_N} single ones "
                  f"{lock_err:.3e} (tol {MODEL_TOL:.0e}; gru_scan launches "
                  f"{counts4.get('gru_scan', 0)}); bf16 engine vs f32 "
                  f"{bf16_err:.3e} (tol {BF16_TOL:.0e}; gru_scan launches "
                  f"{bf16_counts.get('gru_scan', 0)}); halo measured in bf16"
                  f": {bf16_halo} (f32: {engine.halo_t})")
    if lock_err > MODEL_TOL or bf16_err > BF16_TOL or \
            counts4.get("gru_scan") != 2 * head_calls or \
            bf16_counts.get("gru_scan") != 2 * head_calls:
        raise SystemExit("lockstep or bf16 streams disagree")

    # (c) raw audio: StreamingSELDWav against offline extraction + crop +
    # normalizer + the fast path
    with torch.inference_mode():
        feats = extract_features(wav_card).cpu().numpy()[:frames]
    mean, std = feats.mean(axis=0), feats.std(axis=0) + 1e-6
    sw = StreamingSELDWav(gpu, normalizer=(mean, std), halo=engine.halo_t)
    extractions = [0]
    extract = sw.frontend._extract

    def counting_extract(segment):
        extractions[0] += 1
        return extract(segment)
    sw.frontend._extract = counting_extract

    def run_wav():
        out = []
        for lo in range(0, seconds, 24000):
            out.extend(sw.push(wav[:, lo:lo + 24000]))
        return out + sw.finalize()
    wav_out, wav_counts = _counted(run_wav)
    wav_fast = ensemble_outputs(gpu, [(feats - mean) / std], fast=True,
                                batch_size=CLIP_BATCH)[0]
    wav_err = _frames_err((np.stack([s for s, _ in wav_out]),
                           np.stack([d for _, d in wav_out])),
                          tuple(f.cpu().numpy() for f in wav_fast))
    log("stream", f"StreamingSELDWav on a {STREAM_SECONDS}-s wav: "
                  f"{len(wav_out)} frames, against offline extraction + "
                  f"the fast path {wav_err:.3e} (tol {MODEL_TOL:.0e}); "
                  f"{extractions[0]} front-end extractions, launches "
                  f"{dict(wav_counts)}")
    if len(wav_out) != frames // 5 or wav_err > MODEL_TOL or \
            wav_counts.get("foa_frontend") != extractions[0] or \
            wav_counts.get("gru_scan") != 2 * head_calls:
        raise SystemExit("the wav stream disagrees or its launches are "
                         "not one foa_frontend an extraction")

    # (d) bundles, served
    with tempfile.TemporaryDirectory() as tmp:
        b32 = export_streaming(gpu, f"{tmp}/f32", (64, 7))
        bint8 = export_streaming(gpu, f"{tmp}/int8", (64, 7),
                                 quantize="int8")
        exp32 = StreamingSELD.from_exported(b32, device="cuda")
        exp8 = StreamingSELD.from_exported(bint8, device="cuda")
        bundle_err = _frames_err(_stream_frames(exp32, clip), (sed, doa))
        int8_out = _stream_frames(exp8, clip)
        int8_err = _frames_err(int8_out, (sed, doa))
        served = export_streaming(gpu, f"{tmp}/served", (64, 7))
        server = SELDServer(bundle=served, device="cuda")
        httpd = serve(server, "127.0.0.1", 0)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        try:
            port = httpd.server_address[1]
            got = {}
            threads = [threading.Thread(
                target=_stream_session,
                args=(SELDClient("127.0.0.1", port, timeout=600), sid, c,
                      got)) for sid, c in (("a", clips[0]), ("b", clips[1]))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            session_err = max(_frames_err(got["a"], singles[0]),
                              _frames_err(got["b"], singles[1]))
            client = SELDClient("127.0.0.1", port, timeout=600)
            client.stream_push("short", clip[:40])
            try:
                client.stream_finalize("short")
                short_code = 200
            except RuntimeError as e:
                short_code = 400 if "-> 400" in str(e) else str(e)
            client.stream_drop("short")
            # a reload between two pushes of a live session: the session
            # keeps its engine (f32) while the bundle on disk turns int8
            half = frames // 2
            seds, doas = [], []
            for lo in range(0, frames, STREAM_PUSH):
                if lo == half:
                    export_streaming(gpu, served, (64, 7), quantize="int8")
                    client.reload()
                s_, d_ = client.stream_push("r", clip[lo:lo + STREAM_PUSH])
                seds.extend(s_)
                doas.extend(d_)
            s_, d_ = client.stream_finalize("r")
            reload_err = _frames_err((np.stack(seds + list(s_)),
                                      np.stack(doas + list(d_))),
                                     (sed, doa))
            health = client.health()
            gauge = [ln for ln in client.metrics().splitlines()
                     if ln.startswith("seld_stream_sessions ")]
        finally:
            httpd.shutdown()
            server.close()
            httpd.server_close()
            thread.join(timeout=10)
    log("stream", f"bundle f32 vs live {bundle_err:.3e} (tol "
                  f"{MODEL_TOL:.0e}), int8 vs f32 {int8_err:.3e} (tol "
                  f"{INT8_TOL:.0e}); served: two concurrent sessions vs "
                  f"the live engine {session_err:.3e}, a short stream's "
                  f"finalize {short_code}, a session across /v1/reload "
                  f"{reload_err:.3e}, bundle after reload quantize "
                  f"{health['bundle_meta'].get('quantize')}, {gauge}")
    if max(bundle_err, session_err, reload_err) > MODEL_TOL or \
            int8_err > INT8_TOL or short_code != 400 or \
            gauge != ["seld_stream_sessions 0"] or \
            health["bundle_meta"].get("quantize") != "int8":
        raise SystemExit("a bundle, a served session or the reload "
                         "disagrees")

    # (e) timings: push latency, device time and idle share a push at 1
    # and STREAM_N streams, finalize and the real-time factor
    timing = {}
    for n, eng, c in ((1, engine, clip), (STREAM_N, engine4, clips)):
        runs = [stream_demo.stream_clip(eng, c) for _ in range(STREAM_REPS)]
        n_boot = stream_demo.boot_pushes(eng)
        lat = np.concatenate([r[1][n_boot:] for r in runs])
        span = np.concatenate([r[2][n_boot:] for r in runs])
        device_ms = stream_demo.profile_push_ms(eng, c)
        syncs = _push_syncs(eng, c)
        p50 = float(np.percentile(lat, 50))
        timing[n] = {"push_p50_ms": p50,
                     "push_p99_ms": float(np.percentile(lat, 99)),
                     "push_event_p50_ms": float(np.percentile(span, 50)),
                     "device_ms_per_push": device_ms,
                     "idle_share": 1 - device_ms / p50,
                     "boot_push_ms": float(np.mean([r[1][n_boot - 1]
                                                    for r in runs])),
                     "finalize_ms": float(np.mean([r[3] for r in runs])),
                     "realtime_x": float(np.mean(
                         [STREAM_SECONDS * n / r[4] for r in runs])),
                     "syncs_per_push": syncs}
        t = timing[n]
        log("stream", f"{n} stream(s): push p50 {t['push_p50_ms']:.3f} ms "
                      f"p99 {t['push_p99_ms']:.3f} ms (host clock; CUDA-"
                      f"event span p50 {t['push_event_p50_ms']:.3f}), "
                      f"device {device_ms:.3f} ms a push (torch.profiler)"
                      f", idle {t['idle_share']:.1%}; bootstrap push "
                      f"{t['boot_push_ms']:.3f} ms, finalize "
                      f"{t['finalize_ms']:.3f} ms, {t['realtime_x']:.0f}x "
                      f"real time ({STREAM_REPS} reps of a "
                      f"{STREAM_SECONDS}-s clip); {syncs} synchronizing "
                      f"call(s) in a steady-state push on {card}")
    log("stream", f"phase {time.perf_counter() - t_phase:.1f} s")
    return {"timing": timing, "launches": {"gru_scan": want_counts["gru_scan"],
                         "foa_frontend": wav_counts["foa_frontend"]},
            "halo": engine.halo_t, "bf16_halo": bf16_halo}


def phase_answer(card):
    """The dress rehearsal on the card (its CLIs as subprocesses)."""
    from seld_tpu_torch import dress_rehearsal
    with tempfile.TemporaryDirectory() as tmp:
        work = os.path.join(tmp, "rehearsal")
        t0 = time.perf_counter()
        dress_rehearsal.main(["--workdir", work] + ANSWER_ARGV)
        answers = [f for f in os.listdir(os.path.join(work, "answer"))
                   if f.endswith(".csv")]
    if len(answers) != 2:
        raise SystemExit(f"make_answer wrote {len(answers)} CSVs")
    log("answer", f"dress rehearsal passed in {time.perf_counter() - t0:.1f}"
                  f" s on {card}")


def _nas_gru_units():
    """The unit counts of the search space's GRU stage that the kernels
    take: every one but 6, which runs the plain recurrence."""
    from seld_tpu_torch.nas.search import SELD_SEARCH_SPACE_1D
    from seld_tpu_torch.ops.gru import gru_kernel_applicable
    units = SELD_SEARCH_SPACE_1D["bidirectional_GRU_stage"]["units"]
    taken = [u for u in units if gru_kernel_applicable(u)]
    if [u for u in units if u not in taken] != [6]:
        raise SystemExit(f"the GRU kernels take {taken} of the NAS space's "
                         f"{units}; all but 6 expected")
    return taken


def nas_kernels(card):
    """[nas] (a): gru_scan and gru_scan_bwd against their plain versions at
    D=2, T=60, B=256 in f32 at every unit count of the search space that
    they take, each with its time, the plain version's, its bound and (the
    forward) cuDNN's torch.nn.GRU time."""
    import torch
    from seld_tpu_torch.ops.gru import (_bwd_plan, _fwd_plan, gru_scan,
                                        gru_scan_bwd, gru_scan_bwd_ref,
                                        gru_scan_ref)
    rng = np.random.RandomState(11)
    d, t, b = 2, 60, 256
    fwd, bwd = {}, {}
    for u in _nas_gru_units():
        xp, rk, rb = _gru_inputs(rng, d, t, b, u, "float32")
        hs = gru_scan(xp, rk, rb)
        torch.cuda.synchronize()
        ref = gru_scan_ref(xp, rk, rb)
        err = (hs - ref).abs().max().item()
        if err > GRU_TOL["float32"]:
            raise SystemExit(f"gru_scan disagrees with gru_scan_ref at f32 "
                             f"B={b} U={u}: {err:.3e}")
        ms = cuda_ms(lambda: gru_scan(xp, rk, rb), 20)
        plain_ms = cuda_ms(lambda: gru_scan_ref(xp, rk, rb), 2)
        library_ms = cuda_ms(cudnn_gru(xp, rk, rb), 20)
        bound_ms, bound_by = gru_scan_bound(xp, rk, rb)
        fwd[u] = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                  "bound_ms": bound_ms, "bound_by": bound_by,
                  "max_abs_err": err, "plan": _plan_json(_fwd_plan(d, b, u))}
        g = torch.from_numpy(rng.randn(d, t, b, u).astype(np.float32)).cuda()
        got = gru_scan_bwd(xp, rk, rb, hs, g)
        torch.cuda.synchronize()
        want = gru_scan_bwd_ref(xp, rk, rb, ref, g)
        errs = [rel_err(a, w) for a, w in zip(got, want)]
        if max(errs) > BWD_TOL["float32"]:
            raise SystemExit(f"gru_scan_bwd disagrees with gru_scan_bwd_ref "
                             f"at f32 B={b} U={u}: rel_err {errs}")
        b_ms = cuda_ms(lambda: gru_scan_bwd(xp, rk, rb, hs, g), 10)
        b_plain_ms = cuda_ms(lambda: gru_scan_bwd_ref(xp, rk, rb, hs, g), 1)
        b_bound_ms, b_bound_by = gru_bwd_bound(xp, rk, rb, hs, g)
        bwd[u] = {"ms": b_ms, "plain_ms": b_plain_ms, "bound_ms": b_bound_ms,
                  "bound_by": b_bound_by, "rel_err": max(errs),
                  "plan": _plan_json(_bwd_plan(d, b, u))}
        log("nas", f"gru_scan f32 D=2 T=60 B=256 U={u}: max_abs_err "
                   f"{err:.2e} kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} "
                   f"library_ms (cuDNN GRU) {library_ms:.4f} bound_ms "
                   f"{bound_ms:.5f} ({bound_by}); gru_scan_bwd rel_err "
                   f"{max(errs):.2e} kernel_ms {b_ms:.4f} plain_ms "
                   f"{b_plain_ms:.4f} bound_ms {b_bound_ms:.5f} "
                   f"({b_bound_by})")
        del xp, rk, rb, hs, ref, g, got, want
    return fwd, bwd


class _TimedSplit:
    """A split whose iteration is timed: from the first batch to the end
    of the device's work for the last (one synchronize at each end)."""

    def __init__(self, split):
        self.split = split
        self.device_resident = getattr(split, "device_resident", False)
        self.batch_size = split.batch_size
        self.seconds = None

    def __len__(self):
        return len(self.split)

    def __iter__(self):
        import torch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        yield from self.split
        torch.cuda.synchronize()
        self.seconds = time.perf_counter() - t0


def _nas_clips(root):
    from seld_tpu_torch.data.loader import load_seldnet_data
    data = os.path.join(root, "DCASE2021", "feat_label")
    feat, lab = (os.path.join(data, d) for d in ("foa_dev_norm",
                                                  "foa_dev_label"))
    return (load_seldnet_data(feat, lab, mode="train"),
            load_seldnet_data(feat, lab, mode="test"))


def _nas_sets(clips, n_train_clips, n_eval_clips):
    """Host splits of the first clips: train at NAS_B, eval a clip a batch."""
    from seld_tpu_torch.data.loader import SeldDataset
    (xtr, ytr), (xte, yte) = clips
    return (SeldDataset.from_clips(xtr[:n_train_clips], ytr[:n_train_clips],
                                   NAS_B),
            SeldDataset.from_clips(xte[:n_eval_clips], yte[:n_eval_clips],
                                   NAS_B, train=False))


def nas_card_vs_cpu(card, clips):
    """[nas] (b): NAS_CONFIG trained NAS_STEPS steps and scored through
    train_and_eval_candidate on the card (cuDNN's deterministic
    algorithms) and on the CPU, from the same weights on the same batches,
    with each proxy; returns the layout of the cotangent the card's step
    handed the stem's backward."""
    import torch
    import seld_tpu_torch.models.layers as layers
    from seld_tpu_torch.models import build_model
    from seld_tpu_torch.nas.sampler import sample_constraint
    from seld_tpu_torch.nas.search import train_and_eval_candidate
    from seld_tpu_torch.train import metrics as M

    if not sample_constraint(400_000_000, 480_000_000)(NAS_CONFIG,
                                                       (300, 64, 7)):
        raise SystemExit("NAS_CONFIG lies outside the search's window")
    n_clips = -(-NAS_B * NAS_STEPS // 10)
    weights = build_model("conv_temporal", (300, 64, 7), NAS_CONFIG,
                          device="cpu").state_dict()
    seen, sweeps = [], []
    fused, calc = layers.conv_bn_relu_pool, M.calculate_seld_score

    def hooked(*args, **kwargs):
        out = fused(*args, **kwargs)
        if out[0].requires_grad and out[0].is_cuda:
            out[0].register_hook(lambda g: seen.append(
                (tuple(g.shape), g.stride(), g.dtype)))
        return out

    def recording(values):
        out = calc(values)
        if torch.is_tensor(out) and out.dim():
            sweeps.append(out.cpu().numpy())
        return out
    layers.conv_bn_relu_pool, M.calculate_seld_score = hooked, recording
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for proxy in ("reference", "trainer"):
            res, times = {}, {}
            for dev in ("cuda", "cpu"):
                trainset, testset = _nas_sets(clips, n_clips, NAS_EVAL_CLIPS)
                if len(trainset) != NAS_STEPS:
                    raise SystemExit(f"{len(trainset)} train batches")
                t0 = time.perf_counter()
                res[dev] = train_and_eval_candidate(
                    NAS_CONFIG, (300, 64, 7), trainset, testset,
                    proxy=proxy, device=dev, weights=weights)
                times[dev] = time.perf_counter() - t0
            card_v, cpu_v = res["cuda"], res["cpu"]
            card_sweep, cpu_sweep = sweeps[-2], sweeps[-1]
            errs = {k: abs(card_v[k] - cpu_v[k]) for k in (
                "loss", "val_loss", "test_error_rate", "test_f1score",
                "test_der", "test_derf", "test_seld_score",
                "test_seld_score_searched")}
            errs["sweep"] = float(np.abs(card_sweep - cpu_sweep).max())
            ok = (all(errs[k] <= NAS_LOSS_RTOL * abs(cpu_v[k])
                      for k in ("loss", "val_loss"))
                  and all(errs[k] <= NAS_COUNT_ATOL for k in (
                      "test_error_rate", "test_f1score", "test_derf",
                      "test_seld_score", "test_seld_score_searched",
                      "sweep"))
                  and errs["test_der"] <= NAS_DE_ATOL
                  and card_sweep.shape == (12,)
                  and all(np.isfinite(card_v[k]) for k in errs
                          if k != "sweep"))
            log("nas", f"candidate card vs CPU, proxy {proxy}, B={NAS_B} x "
                       f"{NAS_STEPS} steps + {NAS_EVAL_CLIPS} eval clips: "
                       f"card {times['cuda']:.2f} s, CPU {times['cpu']:.2f} "
                       f"s; loss {card_v['loss']:.6f} vs {cpu_v['loss']:.6f}, "
                       f"seld {card_v['test_seld_score']:.5f} vs "
                       f"{cpu_v['test_seld_score']:.5f}, searched "
                       f"{card_v['test_seld_score_searched']:.5f} at "
                       f"{card_v['searched_threshold']:.3f} vs "
                       f"{cpu_v['test_seld_score_searched']:.5f} at "
                       f"{cpu_v['searched_threshold']:.3f}; |diff| "
                       + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
                       + f" {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"NAS candidate card vs CPU ({proxy}) "
                                 f"disagree: {errs}")
    finally:
        layers.conv_bn_relu_pool, M.calculate_seld_score = fused, calc
        torch.backends.cudnn.deterministic = deterministic
    if len(seen) != 2 * NAS_STEPS:
        raise SystemExit(f"the stem's pooled output got {len(seen)} "
                         f"cotangents on the card in {2 * NAS_STEPS} steps")
    return seen[0]


def nas_stem_dy(card, dpooled):
    """[nas] (a), the stem: stem_dy in f32 at [256, 300, 64, 32], pool
    [5, 2], dpooled laid out as the candidate's step hands it over."""
    import torch
    from seld_tpu_torch.ops.stem_bwd import stem_dy, stem_dy_ref
    dshape, dstride, ddtype = dpooled
    dp_order = tuple(sorted(range(4), key=lambda i: -dstride[i]))
    gen = torch.Generator(device="cuda").manual_seed(6)
    y, dp, p6 = _stem_inputs(gen, "float32", 256, (5, 2), "channels-last",
                             "main path", dp_order)
    dy, dbias = stem_dy(y, dp, p6, (5, 2))
    torch.cuda.synchronize()
    want_dy, want_db = stem_dy_ref(y, dp, p6, (5, 2))
    e_dy, e_db = rel_err(dy, want_dy), rel_err(dbias, want_db)
    err = (dy - want_dy).abs().max().item()
    if e_dy > BWD_TOL["float32"] or e_db > BWD_TOL["float32"]:
        raise SystemExit(f"stem_dy f32 disagrees with stem_dy_ref: {e_dy:.2e}"
                         f" / {e_db:.2e}")
    del dy, want_dy
    out = torch.empty_like(y)
    ms = cuda_ms(lambda: stem_dy(y, dp, p6, (5, 2), out=out), 20)
    device_ms = graph_ms(lambda: stem_dy(y, dp, p6, (5, 2), out=out), 20)
    plain_ms = cuda_ms(lambda: stem_dy_ref(y, dp, p6, (5, 2)), 3)
    nbytes = (2 * y.numel() + dp.numel()) * y.element_size() + p6.numel() * 4
    bound_ms, bound_by = bound(nbytes, 0)
    log("nas", f"stem_dy f32 B=256 [256,300,64,32] pool [5,2], dpooled "
               f"{ddtype} strides {dstride} on {card}: rel_err dy {e_dy:.2e} "
               f"dbias {e_db:.2e}, kernel_ms {ms:.4f} (device ms "
               f"{device_ms:.4f}) plain_ms {plain_ms:.4f} bound_ms "
               f"{bound_ms:.5f} ({bound_by})")
    return {"ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": err,
            "dpooled_strides": list(dstride)}


def _nas_want_counts(config, n_train, n_eval):
    """A candidate's launches: stem_dy one a train step; gru_scan one a GRU
    layer the kernels take (U != 6) a train step and an eval batch;
    gru_scan_bwd one such layer a train step; gather_rows one a batch."""
    from seld_tpu_torch.ops.gru import gru_kernel_applicable
    from seld_tpu_torch.utils import sorted_block_keys
    layers = 0
    for key in sorted_block_keys(config) + ["SED", "DOA"]:
        args = config[f"{key}_ARGS"]
        if config[key] == "bidirectional_GRU_stage" and \
                gru_kernel_applicable(args["units"]):
            layers += args["depth"]
    want = {"stem_dy": n_train, "gru_scan": layers * (n_train + n_eval),
            "gru_scan_bwd": layers * n_train,
            "gather_rows": n_train + n_eval}
    return {k: v for k, v in want.items() if v}, layers


def nas_cli(card, root, results_dir):
    """[nas] (c): the command line, NAS_SAMPLES candidates, then one more
    (resumed), each candidate's exact launch counts, its seconds and its
    fit's windows/s; (e) analyze_nas on the results."""
    import collections
    import random

    import torch
    from seld_tpu_torch import analyze_nas, nas_search
    from seld_tpu_torch.nas import search as SR
    from seld_tpu_torch.ops import kernels
    real = SR.train_and_eval_candidate
    runs = []

    def counted(model_config, input_shape, trainset, testset, **kw):
        torch.cuda.synchronize()
        before = collections.Counter(kernels.launch_counts)
        timed = _TimedSplit(trainset)
        t0 = time.perf_counter()
        perf = real(model_config, input_shape, timed, testset, **kw)
        torch.cuda.synchronize()
        runs.append({"config": model_config,
                     "seconds": time.perf_counter() - t0,
                     "fit_seconds": timed.seconds,
                     "counts": {k: v for k, v in (collections.Counter(
                         kernels.launch_counts) - before).items()
                         if k in COUNTED},
                     "n_train": len(trainset), "n_eval": len(testset),
                     "batch": trainset.batch_size})
        return perf

    argv = ["--task", "seld", "--name", "nas_smoke", "--dataset_path",
            os.path.join(root, "DCASE2021", "feat_label"), "--results_dir",
            results_dir, "--batch_size", "256", "--n_repeat",
            str(NAS_REPEAT), "--proxy", "trainer", "--device_data",
            "--device", "cuda"]
    SR.train_and_eval_candidate = counted
    kernels.launch_counts.clear()
    try:
        random.seed(0)
        search = nas_search.main(argv + ["--n_samples", str(NAS_SAMPLES)])
        with open(search.path) as f:
            first = json.load(f)
        random.seed(1)
        search = nas_search.main(argv + ["--n_samples",
                                         str(NAS_SAMPLES + 1)])
    finally:
        SR.train_and_eval_candidate = real
    torch.cuda.synchronize()
    total = dict(kernels.launch_counts)
    with open(search.path) as f:
        after = json.load(f)
    digits = sorted(k for k in after if k.isdigit())
    if len(runs) != NAS_SAMPLES + 1 or digits != [
            f"{i:03}" for i in range(NAS_SAMPLES + 1)] or any(
            after[k] != first[k] for k in first):
        raise SystemExit(f"the resumed search trained {len(runs)} "
                         f"candidates for {NAS_SAMPLES + 1} samples or "
                         "changed an earlier entry")
    for i, run in enumerate(runs):
        want, layers = _nas_want_counts(run["config"], run["n_train"],
                                        run["n_eval"])
        perf = after[f"{i:03}"]["perf"]
        rate = run["n_train"] * run["batch"] / run["fit_seconds"]
        run.update(windows_per_s=rate, gru_layers=layers,
                   flops=perf["flops"],
                   test_seld_score_searched=perf["test_seld_score_searched"])
        ok = run["counts"] == want and np.isfinite(perf["loss"])
        which = "the resumed run" if i == NAS_SAMPLES else "run 1"
        log("nas", f"candidate {i} ({which}): {run['seconds']:.2f} s, fit "
                   f"{run['n_train']} "
                   f"steps x B={run['batch']} in {run['fit_seconds']:.3f} s "
                   f"= {rate:.0f} windows/s, {run['n_eval']} eval batches; "
                   f"{layers} GRU layers on the kernels; {perf['flops']} "
                   f"flops; launches {run['counts']} (want {want}) "
                   f"{'ok' if ok else 'FAIL'}; searched seld "
                   f"{perf['test_seld_score_searched']:.4f}")
        if not ok:
            raise SystemExit(f"NAS candidate {i}: launches {run['counts']} "
                             f"!= {want} or a non-finite loss")
    out = analyze_nas.main(["--results", search.path])
    if out["pairs"] != NAS_SAMPLES + 1:
        raise SystemExit(f"analyze_nas read {out['pairs']} pairs")
    return runs, total


def nas_parallel(card, clips, results_dir):
    """[nas] (d): run_parallel with two worker threads on the one card
    against the serial run from the same random.seed, both with cuDNN's
    deterministic algorithms."""
    import random

    import torch
    from seld_tpu_torch.nas.search import (RandomSearch,
                                           train_and_eval_candidate)

    def evaluate(model_config, device):
        # a split of its own a candidate: the shuffle does not depend on
        # which worker iterates first
        return train_and_eval_candidate(
            model_config, (300, 64, 7), *_nas_sets(clips, 4, 1),
            proxy="trainer", device=device)

    card_dev = torch.device("cuda", 0)
    stored, secs = {}, {}
    deterministic = torch.backends.cudnn.deterministic
    try:
        # "default": the serial run with cuDNN's default algorithms, to
        # show how far a run moves without determinism (printed, not held)
        for name in ("default", "serial", "parallel"):
            torch.backends.cudnn.deterministic = name != "default"
            random.seed(2)
            search = RandomSearch(f"nas_{name}", {"proxy": "trainer"},
                                  results_dir=results_dir)
            t0 = time.perf_counter()
            if name != "parallel":
                search.run(NAS_PARALLEL_SAMPLES,
                           lambda cfg: evaluate(cfg, card_dev),
                           verbose=False)
            else:
                search.run_parallel(NAS_PARALLEL_SAMPLES, evaluate,
                                    workers=2, devices=[card_dev],
                                    verbose=False)
            torch.cuda.synchronize()
            secs[name] = time.perf_counter() - t0
            with open(search.path) as f:
                stored[name] = json.load(f)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    worst = drift = 0.0
    for i in range(NAS_PARALLEL_SAMPLES):
        a, b = stored["serial"][f"{i:03}"], stored["parallel"][f"{i:03}"]
        c = stored["default"][f"{i:03}"]
        if a["config"] != b["config"] or a["config"] != c["config"]:
            raise SystemExit(f"run_parallel drew another config at {i}")
        for key in ("loss", "val_loss"):
            if not np.isfinite(b["perf"][key]):
                raise SystemExit(f"run_parallel candidate {i}: {key} not "
                                 "finite")
            worst = max(worst, abs(a["perf"][key] - b["perf"][key])
                        / abs(a["perf"][key]))
            drift = max(drift, abs(a["perf"][key] - c["perf"][key])
                        / abs(a["perf"][key]))
    log("nas", f"run_parallel, 2 workers on one card: {NAS_PARALLEL_SAMPLES}"
               f" candidates in {secs['parallel']:.2f} s (serial "
               f"{secs['serial']:.2f} s), the serial configs in order, "
               f"losses to {worst:.2e} relative (tol {NAS_PARALLEL_RTOL:.0e},"
               f" cuDNN deterministic) "
               f"{'ok' if worst <= NAS_PARALLEL_RTOL else 'FAIL'}; the "
               f"serial run with cuDNN's default algorithms moves the "
               f"losses by up to {drift:.2e} relative (not held)")
    if worst > NAS_PARALLEL_RTOL:
        raise SystemExit(f"run_parallel losses differ by {worst:.2e}")
    secs["default_drift"] = drift
    return secs


def phase_nas(card):
    """The architecture search on the card: (a) the GRU kernels at the
    space's unit counts and stem_dy in f32, (b) one candidate card vs CPU,
    (c) the command line with a resume and exact launch counts, (d)
    run_parallel on two workers, (e) analyze_nas."""
    from seld_tpu_torch.dress_rehearsal import synthesize_dataset
    t0 = time.perf_counter()
    gru_fwd, gru_bwd = nas_kernels(card)
    secs = {"kernels": time.perf_counter() - t0}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        synthesize_dataset(tmp, NAS_TRAIN_CLIPS, NAS_TEST_CLIPS, 600,
                           n_classes=12)
        clips = _nas_clips(tmp)
        secs["data"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        dpooled = nas_card_vs_cpu(card, clips)
        secs["card_vs_cpu"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        stem = nas_stem_dy(card, dpooled)
        secs["stem_dy"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        runs, launches = nas_cli(card, tmp, os.path.join(tmp, "results"))
        secs["cli"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        parallel = nas_parallel(card, clips, os.path.join(tmp, "results"))
        secs["parallel"] = time.perf_counter() - t0
    log("nas", "seconds by part: " + ", ".join(
        f"{k} {v:.1f}" for k, v in secs.items()))
    return {"gru_fwd": gru_fwd, "gru_bwd": gru_bwd, "stem": stem,
            "launches": launches,
            "candidates": [{k: r[k] for k in (
                "seconds", "fit_seconds", "windows_per_s", "n_train",
                "n_eval", "gru_layers", "flops", "counts")} for r in runs],
            "parallel_seconds": parallel, "seconds": secs}


def phase_vad(card):
    """Voice activity detection on the card: the VAD rehearsal (prepare,
    the bDNN baseline, window and full-sequence AUC), both VAD models'
    forwards and one attention-model train step against the CPU, and the
    VAD search for two samples on the rehearsal's npz. The VAD path
    launches none of the port's kernels."""
    import random

    import torch
    from seld_tpu_torch import nas_search, vad_rehearsal
    from seld_tpu_torch.data.vad import VadDataset
    from seld_tpu_torch.models import build_model
    from seld_tpu_torch.ops import kernels
    from seld_tpu_torch.train.vad import VADTrainer

    kernels.launch_counts.clear()
    shape = (7, 80, 1)
    with tempfile.TemporaryDirectory() as tmp:
        work = os.path.join(tmp, "vad")
        t0 = time.perf_counter()
        reh = vad_rehearsal.main(["--workdir", work] + VAD_ARGV)
        secs = {"rehearsal": time.perf_counter() - t0}
        log("vad", f"rehearsal on {card}: best window AUC "
                   f"{reh['best_val_auc']:.5f} after {reh['epochs']} epochs, "
                   f"full-sequence AUC {reh['sequence']['auc']:.5f} F1 "
                   f"{reh['sequence']['f1']:.5f}; seconds " + ", ".join(
                       f"{k} {v:.1f}" for k, v in reh["seconds"].items()))
        if not 0.5 < reh["best_val_auc"] <= 1.0:
            raise SystemExit(f"the VAD baseline's AUC is "
                             f"{reh['best_val_auc']}")
        pairs = list(np.load(os.path.join(work, "train.npz"),
                             allow_pickle=True)["pairs"])

        t0 = time.perf_counter()
        x, y = next(iter(VadDataset(pairs, batch_size=256)))
        x, y = torch.from_numpy(x), torch.from_numpy(y)
        models = (("vad_architecture", {
            "flatten": True, "last_unit": 7, "BLOCK0": "simple_dense_block",
            "BLOCK0_ARGS": {"units": [512, 512], "dense_activation": "relu",
                            "dropout_rate": 0.5}}),
            ("spectro_temporal_attention_based_VAD", {}))
        for name, cfg in models:
            cpu = build_model(name, shape, cfg, seed=3, device="cpu")
            card_m = build_model(name, shape, cfg, seed=3, device="cuda")
            with torch.no_grad():
                want, got = cpu(x), card_m(x.cuda())
            want = want if isinstance(want, tuple) else (want,)
            got = got if isinstance(got, tuple) else (got,)
            err = max((g.cpu() - w).abs().max().item()
                      for g, w in zip(got, want))
            log("vad", f"{name} forward B=256 card vs CPU: max_abs_err "
                       f"{err:.2e} (tol {VAD_OUT_ATOL:.0e}) "
                       f"{'ok' if err <= VAD_OUT_ATOL else 'FAIL'}")
            if err > VAD_OUT_ATOL:
                raise SystemExit(f"{name}: card and CPU forwards disagree")

        name, cfg, lr = "spectro_temporal_attention_based_VAD", \
            {"dropout_rate": 0.0}, 1e-3
        weights = build_model(name, shape, cfg, seed=4,
                              device="cpu").state_dict()
        grads, losses, params = {}, {}, {}
        for dev in ("cuda", "cpu"):
            trainer = VADTrainer(cfg, shape, model_name=name, lr=lr,
                                 device=dev, weights=weights)
            names = [k for k, _ in trainer.model.named_parameters()]
            opt_step = trainer.state.optimizer.step

            def recording_step(ps, gs, dev=dev, names=names,
                               opt_step=opt_step):
                grads[dev] = {n: g.detach().cpu().clone()
                              for n, g in zip(names, gs)}
                opt_step(ps, gs)
            trainer.state.optimizer.step = recording_step
            losses[dev] = trainer.train_step(x.to(dev), y.to(dev)).item()
            params[dev] = {k: p.detach().cpu() for k, p in
                           trainer.model.named_parameters()}
        # as [train] (a): a leaf whose CPU gradient stays below
        # VAD_NULL_GRAD of the step's largest element is zero in exact
        # arithmetic (a bias feeding a train-mode BatchNorm); the others'
        # gradients agree to TRAIN_GRAD_RTOL of their largest element, and
        # their parameters to VAD_PARAM_ATOL where the gradient stands
        # above TRAIN_GRAD_RTOL of it; every element moved by <= 2.3 lr
        gh, gc = grads["cpu"], grads["cuda"]
        null_at = VAD_NULL_GRAD * max(g.abs().max().item()
                                      for g in gh.values())
        null = sorted(k for k, g in gh.items()
                      if g.abs().max().item() < null_at)
        grad_err = clear_err = move_err = 0.0
        for k, g in gh.items():
            diff = (params["cuda"][k] - params["cpu"][k]).abs()
            move_err = max(move_err, diff.max().item())
            if k in null:
                continue
            scale = g.abs().max().clamp_min(1e-30)
            grad_err = max(grad_err, ((gc[k] - g).abs().max()
                                      / scale).item())
            clear = g.abs() > TRAIN_GRAD_RTOL * scale
            if clear.any():
                clear_err = max(clear_err, diff[clear].max().item())
        loss_err = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
        ok = (loss_err <= 1e-5 and grad_err <= TRAIN_GRAD_RTOL
              and all(k.endswith("bias") for k in null)
              and clear_err <= VAD_PARAM_ATOL and move_err <= 2.3 * lr)
        log("vad", f"attention model train step B=256 card vs CPU: loss "
                   f"{losses['cuda']:.6f} vs {losses['cpu']:.6f} (rel "
                   f"{loss_err:.1e}); {len(gh) - len(null)} gradients "
                   f"rel_err {grad_err:.1e} (tol {TRAIN_GRAD_RTOL:.0e}), "
                   f"{len(null)} zero in exact arithmetic ({', '.join(null)})"
                   f"; parameters {clear_err:.1e} where the gradient is "
                   f"clear (tol {VAD_PARAM_ATOL:.0e}), {move_err:.1e} "
                   f"anywhere (tol {2.3 * lr:.1e}) "
                   f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("the attention VAD's train step disagrees")
        secs["models"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        random.seed(1)    # a seed whose first VAD draws are quick to accept
        search = nas_search.main([
            "--task", "vad", "--name", "vad_smoke", "--vad_pairs",
            os.path.join(work, "train.npz"), "--results_dir", tmp,
            "--n_samples", "2", "--batch_size", "256", "--n_repeat", "4",
            "--min_flops", "500000", "--max_flops", "600000", "--device",
            "cuda"])
        aucs = [search.results[f"{i:03}"]["perf"]["val_auc"]
                for i in range(2)]
        secs["search"] = time.perf_counter() - t0
        log("vad", f"VAD search: 2 candidates, val AUC {aucs} in "
                   f"{secs['search']:.1f} s")
        if search.n_done != 2 or not all(np.isfinite(aucs)):
            raise SystemExit(f"the VAD search gave {aucs}")
    torch.cuda.synchronize()
    launches = {k: v for k, v in kernels.launch_counts.items()
                if k in COUNTED}
    if launches:
        raise SystemExit(f"the VAD path launched {launches}")
    log("vad", "seconds by part: " + ", ".join(
        f"{k} {v:.1f}" for k, v in secs.items()))
    return {"rehearsal": {k: reh[k] for k in ("best_val_auc", "sequence",
                                              "epochs", "seconds")},
            "search_val_auc": aucs, "launches": launches, "seconds": secs}


def zoo_forward(card):
    """(a) each config's eval forward, card against CPU, f32."""
    import torch
    from seld_tpu_torch.models import build_model
    from seld_tpu_torch.ops import kernels
    from seld_tpu_torch.bench import ZOO_MODELS, zoo_model
    x = torch.from_numpy(np.random.RandomState(21).randn(
        ZOO_FWD_B, 300, 64, 7).astype(np.float32))
    xg = x.cuda()
    out = {}
    for name in ZOO_MODELS:
        model_name, cfg = zoo_model(name)
        cpu = build_model(model_name, (300, 64, 7), cfg, seed=0,
                          device="cpu")
        gpu = build_model(model_name, (300, 64, 7), cfg, seed=0,
                          device="cuda")
        body = []              # the first biGRU block's input, each side
        for m in (gpu, cpu):
            gru = next(c for c in m.modules()
                       if type(c).__name__ == "BidirectionalGRUBlock")
            gru.register_forward_pre_hook(
                lambda mod, args: body.append(args[0].float().cpu()))
        kernels.launch_counts.clear()
        with torch.inference_mode():
            got = gpu(xg)
            torch.cuda.synchronize()
            launches = kernels.launch_counts["gru_scan"]
            want = cpu(x)
            body_err = rel_err(body[0], body[1])
            ms = cuda_ms(lambda: gpu(xg), 3)
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        err = max((g.cpu() - w).abs().max().item()
                  for g, w in zip(got, want))
        spread = float(want[1].std())
        ok = (finite and err <= MODEL_TOL and launches == 2
              and body_err <= ZOO_BODY_RTOL
              and tuple(got[0].shape) == (ZOO_FWD_B, 60, 12))
        n_params = sum(p.numel() for p in gpu.parameters())
        log("zoo", f"(a) {name} ({model_name}, {n_params} parameters) "
                   f"forward B={ZOO_FWD_B} f32 card vs CPU: sed/doa "
                   f"max_abs_err {err:.2e} (tol {MODEL_TOL:.0e}), doa std "
                   f"{spread:.3f}; the biGRU's input {tuple(body[1].shape)} "
                   f"rel_err {body_err:.2e} (tol {ZOO_BODY_RTOL:.0e}); "
                   f"gru_scan launches {launches} (want 2), {ms:.2f} ms on "
                   f"the card {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"zoo {name}: the forward on the card "
                             "disagrees with the CPU or skipped gru_scan")
        out[name] = {"max_abs_err": err, "body_rel_err": body_err,
                     "ms_b4": ms, "params": n_params}
        del cpu, gpu, got, want
    return out


def zoo_train_step(card):
    """(b) one f32 step at B=ZOO_STEP_B, card against CPU."""
    from seld_tpu_torch.bench import ZOO_MODELS, zoo_model
    out = {}
    for name in ZOO_MODELS:
        t0 = time.perf_counter()
        model_name, cfg = zoo_model(name, dropout=False)
        model = {"model_name": model_name, "cfg": cfg}
        nulls, masks = set(), []
        with relu_decisions(masks, replay=False):
            cpu = _one_step("cpu", ZOO_STEP_B, nulls, **model)
        with relu_decisions(masks, replay=True):
            card = _one_step("cuda", ZOO_STEP_B, **model)
        ok, text = _step_agreement(card, cpu, nulls, ZOO_NULL_GRAD)
        log("zoo", f"(b) {name} f32 B={ZOO_STEP_B}, one step, card vs cpu "
                   f"(the CPU's {len(masks)} ReLU decisions replayed): "
                   f"{text}; {time.perf_counter() - t0:.1f} s "
                   f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"zoo {name}: the f32 train step on the card "
                             "disagrees with the CPU")
        out[name] = text
    return out


def _zoo_bf16_run(model_name, cfg, batch, k=ZOO_STEPS, names=COUNTED):
    """k eager bf16 steps, then a make_train_multistep(k) call that warms
    up and captures and a timed call of replays: (eager ms/step, graphed
    ms/step, eager launches, replay launches of the kernels `names`,
    losses finite, peak allocated and reserved GiB)."""
    import torch
    from seld_tpu_torch.bench import build
    from seld_tpu_torch.ops import kernels
    from seld_tpu_torch.train.steps import make_train_multistep
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    b = build(batch=batch, dtype="bf16", device="cuda",
              model_name=model_name, cfg=cfg)
    state, metric = b.state, b.metric
    for _ in range(2):                       # warm up, uncounted
        state, metric, _ = b.step(state, metric, b.x, b.y)
    torch.cuda.synchronize()
    kernels.launch_counts.clear()
    losses = []
    t0 = time.perf_counter()
    for _ in range(k):
        state, metric, (sl, dl) = b.step(state, metric, b.x, b.y)
        losses += [sl, dl]
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) / k * 1e3
    eager = {n: kernels.launch_counts[n] for n in names}
    torch.cuda.empty_cache()      # the graph's pool allocates on its own
    multistep = make_train_multistep(steps_per_call=k, **b.step_kwargs)
    xs = b.x.unsqueeze(0).expand(k, *b.x.shape)
    ys = tuple(y.unsqueeze(0).expand(k, *y.shape) for y in b.y)
    state, metric, (sl, dl) = multistep(state, metric, xs, ys)
    losses += [sl, dl]
    torch.cuda.synchronize()
    kernels.launch_counts.clear()
    t0 = time.perf_counter()
    state, metric, (sl, dl) = multistep(state, metric, xs, ys)
    torch.cuda.synchronize()
    graph_ms = (time.perf_counter() - t0) / k * 1e3
    losses += [sl, dl]
    replays = {n: kernels.launch_counts[n] for n in names}
    finite = bool(torch.isfinite(torch.cat(
        [v.reshape(-1).float() for v in losses])).all())
    peak = (torch.cuda.max_memory_allocated() / 2 ** 30,
            torch.cuda.max_memory_reserved() / 2 ** 30)
    del b, state, metric, multistep, xs, ys
    return eager_ms, graph_ms, eager, replays, finite, peak


def zoo_bf16(card):
    """(c) bf16 training at B=ZOO_TRAIN_B (or the largest power of two that
    fits), eager and graphed, with exact launches a step."""
    from seld_tpu_torch.bench import ZOO_MODELS, zoo_model
    from seld_tpu_torch.ops import kernels
    out = {}
    for name in ZOO_MODELS:
        model_name, cfg = zoo_model(name)
        per_step = {"gru_scan": 2, "gru_scan_bwd": 2,
                    "stem_dy": int(model_name == "conv_temporal"),
                    "batch_norm_pool": ZOO_POOL_LAUNCHES.get(name, 0)}
        names = COUNTED + ("batch_norm_pool",)
        want = {n: per_step.get(n, 0) * ZOO_STEPS for n in names}
        batch = ZOO_TRAIN_B
        eager_ms, graph_ms, eager, replays, finite, peak = _zoo_bf16_run(
            model_name, cfg, batch, names=names)
        ok = finite and eager == want and replays == want
        log("zoo", f"(c) {name} bf16 B={batch}, {ZOO_STEPS} steps: eager "
                   f"{eager_ms:.2f} ms/step "
                   f"({batch * 1e3 / eager_ms:.1f} windows/s), graphed "
                   f"{graph_ms:.2f} ms/step ({batch * 1e3 / graph_ms:.1f} "
                   f"windows/s); losses finite {finite}; launches eager "
                   f"{eager}, graph replays {replays} (want {want} each); "
                   f"peak allocated {peak[0]:.2f} GiB, reserved "
                   f"{peak[1]:.2f} GiB on {card} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"zoo {name}: bf16 training gave a non-finite "
                             "loss or skipped a kernel")
        out[name] = {"batch": batch, "eager_ms": eager_ms,
                     "graph_ms": graph_ms, "launches": eager,
                     "graph_launches": replays, "peak_gib": list(peak)}
    return out


def zoo_stem_dy(card):
    """(d) stem_dy at conv_temp's training shape, bf16, pool [5, 1], the
    cotangent as conv_temp's first res_bottleneck_stage hands it over."""
    import torch
    from seld_tpu_torch.bench import zoo_model
    from seld_tpu_torch.ops.stem_bwd import _vector_path, stem_dy, \
        stem_dy_ref
    pool = (5, 1)
    model_name, cfg = zoo_model("conv_temp")
    dshape, dstride, ddtype = main_path_dpooled(model_name=model_name,
                                                cfg=cfg)
    dp_order = tuple(sorted(range(4), key=lambda i: -dstride[i]))
    gen = torch.Generator(device="cuda").manual_seed(22)
    y, dp, p6 = _stem_inputs(gen, "bfloat16", 256, pool, "channels-last",
                             "main path", dp_order)
    dy, dbias = stem_dy(y, dp, p6, pool)
    torch.cuda.synchronize()
    want_dy, want_db = stem_dy_ref(y, dp, p6, pool)
    e_dy, e_db = rel_err(dy, want_dy), rel_err(dbias, want_db)
    ties = _tied_windows(y, p6, pool)
    path = "vector" if _vector_path(y, pool) else "generic"
    out = torch.empty_like(y)
    ms = cuda_ms(lambda: stem_dy(y, dp, p6, pool, out=out), 20)
    device_ms = graph_ms(lambda: stem_dy(y, dp, p6, pool, out=out), 20)
    plain_ms = cuda_ms(lambda: stem_dy_ref(y, dp, p6, pool), 3)
    nbytes = (2 * y.numel() + dp.numel()) * y.element_size() + \
        p6.numel() * 4
    bound_ms, bound_by = bound(nbytes, 0)
    ok = (e_dy <= BWD_TOL["bfloat16"] and e_db <= BWD_TOL["float32"]
          and ties > 0 and tuple(dp.shape[1:]) == tuple(dshape[1:]))
    log("zoo", f"(d) stem_dy bf16 [256, 300, 64, 32] pool [5, 1], dpooled "
               f"as conv_temp's step hands it over: shape {dshape} strides "
               f"{dstride} {ddtype}, dims outermost first {dp_order} "
               f"({path} path); rel_err dy {e_dy:.2e} dbias {e_db:.2e} (tol "
               f"{BWD_TOL['bfloat16']:.1e}/{BWD_TOL['float32']:.0e}), {ties} "
               f"windows with tied positive maxima; kernel_ms {ms:.4f} "
               f"(device ms {device_ms:.4f}) plain_ms {plain_ms:.4f} "
               f"bound_ms {bound_ms:.5f} ({bound_by}) on {card} "
               f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("stem_dy at pool [5, 1] disagrees with stem_dy_ref")
    return {"ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "path": path,
            "max_abs_err": (dy.float() - want_dy.float()).abs().max().item(),
            "dpooled_strides": list(dstride)}


def zoo_serve(card):
    """(e) ZOO_SERVE as window artifacts behind the server: replies against
    the direct call, 2 gru_scan launches a dispatch."""
    import torch
    from seld_tpu_torch.bench import zoo_model
    from seld_tpu_torch.inference import export_window
    from seld_tpu_torch.models import build_model
    from seld_tpu_torch.ops import kernels
    from seld_tpu_torch.serving import SELDClient, SELDServer
    from seld_tpu_torch.serving.server import serve

    rng = np.random.RandomState(23)
    out = {}
    for name in ZOO_SERVE:
        model_name, cfg = zoo_model(name)
        model = build_model(model_name, (300, 64, 7), cfg, seed=0,
                            device="cuda")
        with tempfile.TemporaryDirectory() as tmp:
            path = f"{tmp}/{name}_window.npz"
            export_window(model, path)
            server = SELDServer(artifact=path, batch_window_ms=2.0,
                                max_batch=8, device="cuda")
            httpd = serve(server, "127.0.0.1", 0)
            thread = threading.Thread(target=httpd.serve_forever,
                                      daemon=True)
            thread.start()
            try:
                client = SELDClient("127.0.0.1", httpd.server_address[1])
                slot = server._slots[server.DEFAULT]
                for b in (1, 4, 8):          # every bucket once, uncounted
                    server.score(torch.zeros(b, 300, 64, 7))
                requests = [rng.randn(b, 300, 64, 7).astype(np.float32)
                            for b in (1, 3, 8, 2, 5, 1)]
                kernels.launch_counts.clear()
                dispatches0 = slot.batch_stats["dispatches"]
                replies = [client.score(x) for x in requests[:3]]
                with ThreadPoolExecutor(3) as pool:
                    replies += list(pool.map(client.score, requests[3:]))
                launches = kernels.launch_counts["gru_scan"]
                dispatches = slot.batch_stats["dispatches"] - dispatches0
            finally:
                httpd.shutdown()
                server.close()
                httpd.server_close()
                thread.join(timeout=10)
            art = slot.artifact
            worst = 0.0
            for x, (sed, doa) in zip(requests, replies):
                want = art.call(torch.from_numpy(x))
                worst = max(worst, np.abs(sed - want[0]).max(),
                            np.abs(doa - want[1]).max())
            with torch.inference_mode():
                direct = model(torch.from_numpy(requests[2]).cuda())
            model_err = max(np.abs(replies[2][i] - direct[i].cpu().numpy())
                            .max() for i in range(2))
        ok = (worst <= REPLY_TOL and model_err <= REPLY_TOL
              and dispatches > 0 and launches == 2 * dispatches)
        log("zoo", f"(e) {name} window artifact served: {len(requests)} "
                   f"requests in {dispatches} dispatches, gru_scan launches "
                   f"{launches} (want {2 * dispatches}); reply vs direct "
                   f"call max_abs_err {worst:.2e}, vs the model's forward "
                   f"{model_err:.2e} (tol {REPLY_TOL:.0e}) on {card} "
                   f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"zoo {name}: a served reply disagrees or a "
                             "dispatch skipped gru_scan")
        out[name] = {"dispatches": dispatches, "launches": launches}
        del model
    return out


def phase_zoo(card):
    """The zoo's nine configs at full width: (a) forward and (b) one f32
    train step card against CPU, (c) bf16 training eager and graphed, (d)
    stem_dy at pool [5, 1], (e) two families served."""
    secs = {}
    out = {}
    for part, fn in (("forward", zoo_forward), ("train_step", zoo_train_step),
                     ("bf16", zoo_bf16), ("stem_dy", zoo_stem_dy),
                     ("serve", zoo_serve)):
        t0 = time.perf_counter()
        out[part] = fn(card)
        secs[part] = time.perf_counter() - t0
    log("zoo", "seconds by part: " + ", ".join(
        f"{k} {v:.1f}" for k, v in secs.items()))
    out["seconds"] = secs
    return out


def _block_rows():
    """Path A and every row of path B, in order."""
    from seld_tpu_torch.bench import BLOCK_ROWS
    return ("accdoa", *BLOCK_ROWS)


def _row_gru_layers(row, train):
    """GRU kernel layers `row` runs a forward: SS5's DOA biGRU (2), none in
    accdoa, 2 more in rnn_gru's RNN_stage and, in eval, in
    rnn_gru_dropout's (in training its recurrent dropout takes the masked
    route, no kernel)."""
    if row == "rnn_gru_dropout":
        return 2 if train else 4
    return {"accdoa": 0, "rnn_gru": 4}.get(row, 2)


def blocks_forward(card):
    """(a) each row's eval forward, card against CPU, f32."""
    import torch
    from seld_tpu_torch.bench import block_row
    from seld_tpu_torch.models import build_model
    from seld_tpu_torch.ops import kernels
    x = torch.from_numpy(np.random.RandomState(31).randn(
        BLOCKS_FWD_B, 300, 64, 7).astype(np.float32))
    xg = x.cuda()
    out = {}
    for row in _block_rows():
        model_name, cfg = block_row(row)
        cpu = build_model(model_name, (300, 64, 7), cfg, seed=0,
                          device="cpu")
        gpu = build_model(model_name, (300, 64, 7), cfg, seed=0,
                          device="cuda")
        body = []              # the swapped block's (BLOCK2's) output
        for m in (gpu, cpu):
            m.blocks[2].register_forward_hook(
                lambda mod, args, y: body.append(y.float().cpu()))
        kernels.launch_counts.clear()
        with torch.inference_mode():
            got = gpu(xg)
            torch.cuda.synchronize()
            launches = kernels.launch_counts["gru_scan"]
            want = cpu(x)
            body_err = rel_err(body[0], body[1])
            ms = cuda_ms(lambda: gpu(xg), 3)
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        err = max((g.cpu() - w).abs().max().item()
                  for g, w in zip(got, want))
        want_launches = _row_gru_layers(row, train=False)
        ok = (finite and err <= MODEL_TOL and launches == want_launches
              and body_err <= ZOO_BODY_RTOL
              and tuple(got[0].shape) == (BLOCKS_FWD_B, 60, 12)
              and tuple(got[1].shape) == (BLOCKS_FWD_B, 60, 36))
        n_params = sum(p.numel() for p in gpu.parameters())
        log("blocks", f"(a) {row} ({model_name}, {cfg['BLOCK2']}, "
                      f"{n_params} parameters) forward B={BLOCKS_FWD_B} f32 "
                      f"card vs CPU: sed/doa max_abs_err {err:.2e} (tol "
                      f"{MODEL_TOL:.0e}), doa std {float(want[1].std()):.3f}"
                      f"; BLOCK2's output {tuple(body[1].shape)} rel_err "
                      f"{body_err:.2e} (tol {ZOO_BODY_RTOL:.0e}); gru_scan "
                      f"launches {launches} (want {want_launches}), "
                      f"{ms:.2f} ms on the card {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"blocks {row}: the forward on the card "
                             "disagrees with the CPU or skipped gru_scan")
        out[row] = {"max_abs_err": err, "body_rel_err": body_err,
                    "ms_b4": ms, "params": n_params}
        del cpu, gpu, got, want
    return out


def blocks_train_step(card):
    """(b) one f32 step at B=BLOCKS_STEP_B, card against CPU, dropouts
    zeroed but rnn_gru_dropout's RNN_stage, which keeps its rate and takes
    the same numpy keep masks on both (the masked route on the card)."""
    from seld_tpu_torch.bench import BLOCK_ROWS, block_row
    out = {}
    for row in _block_rows():
        t0 = time.perf_counter()
        model_name, cfg = block_row(row, dropout=False)
        rate = BLOCK_ROWS.get(row, (None, {}))[1].get("dropout_rate", 0.0)
        if rate:
            cfg["BLOCK2_ARGS"]["dropout_rate"] = rate
        model = {"model_name": model_name, "cfg": cfg}
        nulls, masks = set(), []
        with relu_decisions(masks, replay=False), numpy_keep_masks(7):
            cpu = _one_step("cpu", BLOCKS_STEP_B, nulls, **model)
        with relu_decisions(masks, replay=True), numpy_keep_masks(7):
            card_run = _one_step("cuda", BLOCKS_STEP_B, **model)
        ok, text = _step_agreement(card_run, cpu, nulls, ZOO_NULL_GRAD)
        kept = f", RNN_stage dropout {rate} on the same masks" if rate else ""
        log("blocks", f"(b) {row} f32 B={BLOCKS_STEP_B}{kept}, one step, "
                      f"card vs cpu (the CPU's {len(masks)} ReLU decisions "
                      f"replayed): {text}; {time.perf_counter() - t0:.1f} s "
                      f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"blocks {row}: the f32 train step on the card "
                             "disagrees with the CPU")
        out[row] = text
    return out


def blocks_bf16(card):
    """(c) bf16 training at B=ZOO_TRAIN_B, eager and graphed, with exact
    launches a step."""
    from seld_tpu_torch.bench import block_row
    from seld_tpu_torch.ops import kernels
    out = {}
    for row in _block_rows():
        model_name, cfg = block_row(row)
        gru = _row_gru_layers(row, train=True)
        per_step = {"gru_scan": gru, "gru_scan_bwd": gru, "stem_dy": 1}
        want = {n: per_step.get(n, 0) * BLOCKS_STEPS
                for n in COUNTED}
        batch = ZOO_TRAIN_B
        eager_ms, graph_ms, eager, replays, finite, peak = _zoo_bf16_run(
            model_name, cfg, batch, BLOCKS_STEPS)
        ok = finite and eager == want and replays == want
        log("blocks", f"(c) {row} bf16 B={batch}, {BLOCKS_STEPS} steps: "
                      f"eager {eager_ms:.2f} ms/step "
                      f"({batch * 1e3 / eager_ms:.1f} windows/s), graphed "
                      f"{graph_ms:.2f} ms/step "
                      f"({batch * 1e3 / graph_ms:.1f} windows/s); losses "
                      f"finite {finite}; launches eager {eager}, graph "
                      f"replays {replays} (want {want} each); peak "
                      f"allocated {peak[0]:.2f} GiB, reserved "
                      f"{peak[1]:.2f} GiB on {card} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"blocks {row}: bf16 training gave a "
                             "non-finite loss or skipped a kernel")
        out[row] = {"batch": batch, "eager_ms": eager_ms,
                    "graph_ms": graph_ms, "launches": eager,
                    "graph_launches": replays, "peak_gib": list(peak)}
    return out


def blocks_cli(card):
    """(d) --model accdoa through the training CLI on the seeded wav tree,
    --epoch_scan, 2 epochs and a resume: exact launches of all five
    kernels (no GRU: accdoa has no DOA head), sedLoss 0.0 throughout."""
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as root:
        write_wav_tree(root, FEED_CLIPS, FEED_SECONDS)
        os.chdir(root)
        try:
            counts, rate, out, resumed = _feed_variant(
                root, card, "accdoa --epoch_scan",
                ["--name", "smoke_accdoa", "--epoch_scan"],
                argv=BLOCKS_FEED_ARGV, tag="blocks", gru_layers=0)
        finally:
            os.chdir(cwd)
    hist = out["history"] + resumed["history"]
    sed = [h[s]["sedLoss"] for h in hist for s in ("train", "val")]
    weights = out["trainer"].loss_weights
    ok = all(v == 0.0 for v in sed) and weights[0] == 0.0
    log("blocks", f"(d) accdoa CLI: sedLoss on every history line {sed}, "
                  f"loss weights {weights}; {rate:.1f} windows/s after the "
                  f"first epoch {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the accdoa CLI trained its derived SED output")
    return {"launches": counts, "windows_per_s": rate}


def phase_blocks(card):
    """The block rows at full width: (a) forward and (b) one f32 train step
    card against CPU, (c) bf16 training eager and graphed, (d) accdoa
    through the training CLI."""
    secs, out = {}, {}
    for part, fn in (("forward", blocks_forward),
                     ("train_step", blocks_train_step),
                     ("bf16", blocks_bf16), ("cli", blocks_cli)):
        t0 = time.perf_counter()
        out[part] = fn(card)
        secs[part] = time.perf_counter() - t0
    log("blocks", "seconds by part: " + ", ".join(
        f"{k} {v:.1f}" for k, v in secs.items()))
    out["seconds"] = secs
    return out


# [dp]: data-parallel training. (a) and (c): 2 ranks, each 128 of a global
# batch of 256 windows, full-width SS5 bf16 with dropout and cuDNN's
# deterministic algorithms, 3 steps through make_train_step fed from each
# rank's shard of one sharded DeviceDataset, against one process's 3 steps
# at B=256 on the same global batches. The second shard's windows are the
# first's distribution scaled by DP_SHARD_SCALE and offset by
# DP_SHARD_OFFSET, so a rank's own BatchNorm statistics lie far from the
# global batch's. The ranks run the same kernels on
# half the rows, which differs from the one-process step only in the
# order of the sums (the BatchNorm sums of two halves, the gradients' sum
# of two backwards, and the library kernels' algorithms at another batch
# size) rounded at bf16: the losses DP_LOSS_RTOL relative; the running
# statistics DP_STATS_RTOL of each tensor's largest element plus
# DP_STATS_ATOL, (1 - 0.99) x 2 x 1.2 lr x steps: a conv bias before a
# BatchNorm has a null gradient, AdaBelief moves it by ~lr either way on
# each side, and the batch mean carries the drift (the stem's running
# mean is ~1e-5, all drift); the
# parameters' updates (after - before) DP_UPDATE_RTOL relative in norm
# over all leaves (AdaBelief moves an element whose gradient is rounding
# noise by ~lr either way, so no single element is held); the first
# step's all-reduced gradients DP_GRAD_RTOL relative in norm for each leaf
# whose gradient norm is at least DP_GRAD_FLOOR of the largest leaf's (the
# others, conv biases before a BatchNorm, are null in exact arithmetic):
# bf16 rounds each value to ~4e-3 and the halves' library kernels round
# apart, while a fault in one layer's backward moves its leaf by O(1);
# and each rank's parameters, statistics and losses equal the other
# rank's bit for bit.
# (b): the training CLI under torch.distributed.run as an NCCL group of
# one rank (--epoch_scan: its all-reduces captured in the epoch graph)
# against the same CLI without a group, deterministic cuDNN in both:
# every logged loss DP_CLI_RTOL relative (the BatchNorm statistics from
# sums instead of means, over 2 epochs of bf16 steps). (c) also starts the
# CLI plainly over two cards (--mesh data:-1, CUDA_VISIBLE_DEVICES 0,1: a
# spawned NCCL rank a card, --epoch_scan) against the CLI on one card, to
# DP_CLI_RTOL; every CLI run must end within DP_CLI_TIMEOUT seconds (its
# whole process group is killed after).
# --dp faults plants each of DP_FAULTS in both ranks' processes and
# requires (a)'s comparison to fail: "local_stats", every BatchNorm and
# the fused stem on its rank's own statistics (no global BatchNorm);
# "local_n", the fused stem's backward forming stem_dy's params6 with its
# rank's count instead of the global batch's.
DP_WINDOWS = 1024
DP_BATCH = 256
DP_STEPS = 3
DP_LOSS_RTOL = 1e-2
DP_STATS_RTOL = 1e-2
DP_STATS_ATOL = (1 - 0.99) * 2 * 1.2 * 1e-3 * DP_STEPS
DP_UPDATE_RTOL = 0.25
DP_GRAD_RTOL, DP_GRAD_FLOOR = 1e-1, 1e-2
DP_CLI_RTOL = 2e-2
DP_CLI_TIMEOUT = 300
DP_SHARD_SCALE, DP_SHARD_OFFSET = 2.0, 1.0
DP_FAULTS = ("local_stats", "local_n")


def _dp_split():
    """The seeded global split: x [DP_WINDOWS, 300, 64, 7] bf16 (the second
    shard's windows scaled and offset), labels [DP_WINDOWS, 60, 48] with an
    event in every window."""
    import torch
    gen = torch.Generator().manual_seed(14)
    x = torch.randn((DP_WINDOWS, 300, 64, 7), generator=gen)
    x[DP_WINDOWS // 2:].mul_(DP_SHARD_SCALE).add_(DP_SHARD_OFFSET)
    x = x.to(torch.bfloat16)
    sed = (torch.rand((DP_WINDOWS, 60, 12), generator=gen) < 0.1).float()
    sed[:, 0, 0] = 1.0
    doa = (torch.rand((DP_WINDOWS, 60, 36), generator=gen) * 2 - 1) * \
        sed.repeat(1, 1, 3)
    return x, torch.cat([sed, doa], -1)


def _dp_run(device, mesh, batches):
    """DP_STEPS bench steps (SS5 bf16, dropout on, seeded) on `batches` of
    (x, y) on the card; (losses, state, launch counts, ms a step of the
    last two)."""
    import torch
    from seld_tpu_torch.bench import build
    from seld_tpu_torch.ops import kernels
    from seld_tpu_torch.train import steps
    b = build(batch=8, dtype="bf16", device=device, mesh=mesh)
    before = {k: v.detach().float().cpu() for k, v in b.state.params.items()}
    losses, marks, first = [], [], []
    reduce = steps._all_reduce_grads

    def recorded(grads):
        # the first step's gradients, as the optimizer receives them
        out = reduce(grads)
        if not first:
            first.extend(g.detach().float().cpu() for g in out)
        return out
    steps._all_reduce_grads = recorded
    kernels.launch_counts.clear()
    try:
        for x, y in batches():
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)
            b.state, b.metric, (sl, dl) = b.step(b.state, b.metric, x,
                                                 (y[..., :12], y[..., 12:]))
            losses.append(torch.stack([sl, dl]))
    finally:
        steps._all_reduce_grads = reduce
    end = torch.cuda.Event(enable_timing=True)
    end.record()
    torch.cuda.synchronize()
    counts = {k: kernels.launch_counts[k] for k in COUNTED}
    ms = marks[1].elapsed_time(end) / (len(marks) - 1)
    return {"losses": torch.stack(losses).cpu().numpy().tolist(),
            "before": before, "grads": dict(zip(b.state.params, first)),
            "params": {k: v.detach().float().cpu()
                       for k, v in b.state.params.items()},
            "stats": {k: v.float().cpu()
                      for k, v in b.state.batch_stats.items()},
            "counts": counts, "ms": ms}


def _plant(fault):
    """Plant one of DP_FAULTS in this process (--dp faults)."""
    from seld_tpu_torch.models import layers
    from seld_tpu_torch.ops import stem
    from seld_tpu_torch.parallel import collectives

    def unmeshed(fn):
        def run(*args):
            mesh = collectives.active()
            collectives._state.mesh = None
            try:
                return fn(*args)
            finally:
                collectives._state.mesh = mesh
        return run
    forward = stem._ConvBNReLUPool.forward
    if fault == "local_stats":
        layers.BatchNorm.forward = unmeshed(layers.BatchNorm.forward)
        stem._ConvBNReLUPool.forward = staticmethod(unmeshed(forward))
    elif fault == "local_n":
        def local_n(ctx, *args):
            out = forward(ctx, *args)
            ctx.n //= collectives.world()
            return out
        stem._ConvBNReLUPool.forward = staticmethod(local_n)
    else:
        raise ValueError(f"no fault {fault!r}")


def dp_worker(rank, world, port, backend, out, fault="none"):
    """One rank of [dp] (a) or (c): its shard of the sharded DeviceDataset,
    DP_STEPS steps under the group's mesh, with `fault` planted unless
    "none"; writes its result to `out`."""
    import torch
    import torch.distributed as dist
    from seld_tpu_torch.data.device_dataset import DeviceDataset
    from seld_tpu_torch.parallel.mesh import make_mesh
    if fault != "none":
        _plant(fault)
    torch.backends.cudnn.deterministic = True
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        mesh = make_mesh("data:-1", device)
        x, y = _dp_split()
        ds = DeviceDataset(x, y, DP_BATCH, device, seed=14, mesh=mesh)
        del x, y

        def batches():
            it = iter(ds)
            for _ in range(DP_STEPS):
                yield next(it)
        result = _dp_run(device, mesh, batches)
        result["device"] = str(device)
        result["backend"] = dist.get_backend()
        torch.save(result, out)
    finally:
        dist.destroy_process_group()


def _package_root():
    """The directory that holds the seld_tpu_torch package this script
    imported: the subprocesses' PYTHONPATH."""
    import seld_tpu_torch
    return os.path.dirname(os.path.dirname(os.path.abspath(
        seld_tpu_torch.__file__)))


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_ranks(world, backend, workdir, fault="none", worker="--dp-worker",
               timeout=600):
    """Start `world` dp_worker (or `worker`) processes and wait for every
    one, each within `timeout` seconds; their results by rank."""
    import torch
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": _package_root()}
    extra = [fault] if worker == "--dp-worker" else []
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), worker, str(r),
         str(world), str(port), backend,
         os.path.join(workdir, f"rank{r}.pt"), *extra], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise SystemExit(f"[{'tp' if worker == '--tp-worker' else 'dp'}]"
                             f" rank {r} of {world} over {backend} "
                             f"failed:\n{text[-4000:]}")
    return [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


def _dp_reference(device):
    """One process's DP_STEPS steps at B=256 on the global batches the two
    ranks' shards make (each rank's local ids into its half of the
    split)."""
    import torch
    from seld_tpu_torch.data.device_dataset import DeviceDataset
    from seld_tpu_torch.ops.gather import gather_batch
    from seld_tpu_torch.parallel.mesh import Mesh
    x, y = _dp_split()
    shard = DP_WINDOWS // 2
    idx = []
    for r in range(2):
        view = Mesh(axes={"data": 2}, world=2, rank=r, data_size=2,
                    data_index=r, device=torch.device("cpu"))
        ds = DeviceDataset(x, y, DP_BATCH, "cpu", seed=14, mesh=view)
        idx.append(torch.from_numpy(ds._epoch_order()) + r * shard)
        del ds
    ids = torch.cat(idx, 1).to(device)
    xd, yd = x.to(device), y.to(device)
    del x, y

    def batches():
        for i in range(DP_STEPS):
            yield gather_batch((xd, yd), ids[i])
    return _dp_run(device, None, batches)


def _dp_compare(got, want):
    """(loss rel err, (the largest statistic's error as a share of its
    tolerance, its name), update err, (the largest first-step gradient
    error of a leaf above DP_GRAD_FLOOR, its name)) of a rank against the
    one-process run."""
    import torch
    loss = _max_rel(np.ravel(got["losses"]).tolist(),
                    np.ravel(want["losses"]).tolist())
    stats = max((((got["stats"][k] - w).abs().max()
                  / (DP_STATS_RTOL * w.abs().max() + DP_STATS_ATOL)).item(),
                 k) for k, w in want["stats"].items())
    du = torch.cat([(got["params"][k] - got["before"][k]
                     - (w - want["before"][k])).ravel()
                    for k, w in want["params"].items()])
    ref = torch.cat([(w - want["before"][k]).ravel()
                     for k, w in want["params"].items()])
    norms = {k: w.norm().item() for k, w in want["grads"].items()}
    floor = DP_GRAD_FLOOR * max(norms.values())
    grad = max(((got["grads"][k] - w).norm().item() / norms[k], k)
               for k, w in want["grads"].items() if norms[k] >= floor)
    return loss, stats, (du.norm() / ref.norm()).item(), grad


def dp_ranks(card, world, backend, label, faults=()):
    """[dp] (a)/(c): `world` ranks over `backend` against one process;
    then the same with each of `faults` planted, each of which the
    comparison must catch."""
    import torch
    per_step = {"gru_scan": 2, "gru_scan_bwd": 2, "stem_dy": 1,
                "gather_rows": 1}
    want_counts = {n: per_step.get(n, 0) * DP_STEPS
                   for n in ("gru_scan", "gru_scan_bwd", "stem_dy",
                             "foa_frontend", "gather_rows")}
    with tempfile.TemporaryDirectory() as workdir:
        t0 = time.perf_counter()
        ranks = _run_ranks(world, backend, workdir)
        secs = time.perf_counter() - t0
        planted = {f: _run_ranks(world, backend, workdir, f)[0]
                   for f in faults}
    torch.backends.cudnn.deterministic = True
    try:
        want = _dp_reference(torch.device("cuda", 0))
    finally:
        torch.backends.cudnn.deterministic = False
    same = all(r["losses"] == ranks[0]["losses"] and all(
        torch.equal(r[part][k], ranks[0][part][k])
        for part in ("params", "stats") for k in r[part])
        for r in ranks[1:])
    loss_err, (stats_err, stats_key), update_err, (grad_err, grad_key) = \
        _dp_compare(ranks[0], want)
    counts_ok = all(r["counts"] == want_counts for r in ranks)
    finite = all(math.isfinite(v) for r in ranks
                 for v in np.ravel(r["losses"]))
    log("dp", f"({label}) {world} ranks over {ranks[0]['backend']} on "
              f"{sorted({r['device'] for r in ranks})}, {DP_BATCH // world} "
              f"of a global batch of {DP_BATCH} windows each, SS5 full "
              f"width bf16, {DP_STEPS} steps from a sharded DeviceDataset "
              f"of {DP_WINDOWS} windows, against one process at B="
              f"{DP_BATCH}: losses rel_err {loss_err:.2e} (tol "
              f"{DP_LOSS_RTOL:.0e}), running statistics at "
              f"{stats_err:.2f} of their tolerance (worst {stats_key}; "
              f"{DP_STATS_RTOL:.0e} of the largest + {DP_STATS_ATOL:.1e}), "
              f"parameter updates {update_err:.2e}"
              f" in norm (tol {DP_UPDATE_RTOL}), first-step gradients "
              f"{grad_err:.2e} (worst leaf {grad_key}; tol {DP_GRAD_RTOL:.0e}"
              f" in norm a leaf); ranks equal bit for bit "
              f"{same}; launches a rank {[r['counts'] for r in ranks]} (want "
              f"{want_counts}); ms a step {[round(r['ms'], 4) for r in ranks]}"
              f" (one process at B={DP_BATCH} {want['ms']:.4f}); ranks' "
              f"processes {secs:.1f} s, on {card}")
    if not (same and counts_ok and finite and loss_err <= DP_LOSS_RTOL
            and stats_err <= 1.0 and update_err <= DP_UPDATE_RTOL
            and grad_err <= DP_GRAD_RTOL):
        raise SystemExit(f"[dp] ({label}) the {world}-rank step disagrees "
                         "with the one-process step")
    caught = {}
    for fault, got in planted.items():
        f_loss, (f_stats, f_key), f_update, (f_grad, f_gkey) = \
            _dp_compare(got, want)
        caught[fault] = {"loss_rel_err": f_loss, "stats_err": f_stats,
                         "update_err": f_update, "grad_err": f_grad}
        log("dp", f"({label}) planted {fault}: losses rel_err {f_loss:.3e} "
                  f"(sound {loss_err:.3e}), running statistics at "
                  f"{f_stats:.3f} of their tolerance (worst {f_key}; sound "
                  f"{stats_err:.3f}), parameter updates {f_update:.3e} in "
                  f"norm (sound {update_err:.3e}), first-step gradients "
                  f"{f_grad:.3e} (worst leaf {f_gkey}; sound {grad_err:.3e})")
        if not (f_loss > DP_LOSS_RTOL or f_stats > 1.0
                or f_update > DP_UPDATE_RTOL or f_grad > DP_GRAD_RTOL):
            raise SystemExit(f"[dp] ({label}) the planted fault {fault} "
                             "passed the comparison")
    return {"launches": ranks[0]["counts"], "ms": [r["ms"] for r in ranks],
            "one_process_ms": want["ms"], "loss_rel_err": loss_err,
            "stats_err": stats_err, "update_err": update_err,
            "grad_err": grad_err, "backend": ranks[0]["backend"],
            "faults": caught}


# the training CLI with cuDNN's deterministic algorithms and no TF32; the
# __main__ guard lets the CLI spawn its ranks from it
DP_CLI_SCRIPT = """import sys
import torch
from seld_tpu_torch.train.main import main
if __name__ == "__main__":
    torch.backends.cudnn.deterministic = True
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    main(sys.argv[1:])
"""


def _dp_scalars(root, name):
    path = os.path.join(root, "tensorboard_log",
                        f"conv_temporal_SS5_MMSE_{name}_v_0", "scalars.jsonl")
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    return {(r["tag"], r["step"]): r["value"] for r in rows
            if r["tag"].split("/")[-1].split("_")[-1] in ("sedLoss",
                                                          "doaLoss")}


def _run_cli(cmd, root, cards, part, label):
    """Run one training CLI command in `root` on the cards `cards` (a
    CUDA_VISIBLE_DEVICES value); its stdout once it has ended within
    DP_CLI_TIMEOUT, else its whole process group is killed and [dp] fails."""
    env = {**os.environ, "PYTHONPATH": _package_root(),
           "CUDA_VISIBLE_DEVICES": cards}
    proc = subprocess.Popen(cmd, cwd=root, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=DP_CLI_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        stdout, stderr = proc.communicate()
        raise SystemExit(f"[dp] ({part}) the {label} CLI run did not end "
                         f"within {DP_CLI_TIMEOUT} s:\n"
                         f"{(stdout + stderr)[-4000:]}")
    if proc.returncode != 0:
        raise SystemExit(f"[dp] ({part}) the {label} CLI run failed:\n"
                         f"{(stdout + stderr)[-4000:]}")
    return stdout


def _cli_root(root):
    """[feed]'s seeded wavs and the CLI script in `root`; the script's
    path."""
    write_wav_tree(root, FEED_CLIPS, FEED_SECONDS)
    script = os.path.join(root, "dp_cli.py")
    with open(script, "w") as f:
        f.write(DP_CLI_SCRIPT)
    return script


def dp_cli(card):
    """[dp] (b): the training CLI on the first card as an NCCL group of one
    rank under torch.distributed.run (--mesh data:-1 --epoch_scan) against
    the same CLI without a group, then its checkpoint resumed without a
    group."""
    with tempfile.TemporaryDirectory() as root:
        script = _cli_root(root)
        argv = [*FEED_ARGV, "--abspath", root, "--epoch_scan", "--mesh",
                "data:-1"]
        runs = {
            "plain": [sys.executable, script, *argv, "--name", "plain"],
            "nccl": [sys.executable, "-m", "torch.distributed.run",
                     "--standalone", "--nproc_per_node", "1", script,
                     *argv, "--name", "nccl"],
            "resumed": [sys.executable, script, *argv, "--name", "nccl",
                        "--resume", "--epoch", "3"]}
        out, secs = {}, {}
        for label, cmd in runs.items():
            t0 = time.perf_counter()
            out[label] = _run_cli(cmd, root, "0", "b", label)
            secs[label] = time.perf_counter() - t0
        plain, nccl = _dp_scalars(root, "plain"), _dp_scalars(root, "nccl")
    group = "data parallel: 1 rank(s) over nccl" in out["nccl"]
    no_group = "data parallel" not in out["plain"] + out["resumed"]
    resumed = "resumed from epoch" in out["resumed"]
    epochs = sorted({k[1] for k in nccl})
    first = {k: v for k, v in nccl.items() if k[1] in epochs[:2]}
    err = _max_rel([first[k] for k in sorted(first)],
                   [plain[k] for k in sorted(first)])
    finite = all(math.isfinite(v) for v in nccl.values())
    log("dp", f"(b) the training CLI (--device_data --epoch_scan --mesh "
              f"data:-1, [feed]'s wavs) as an NCCL group of one rank under "
              f"torch.distributed.run: group {group}, losses of epochs "
              f"{epochs[:2]} against the run without a group rel_err "
              f"{err:.2e} (tol {DP_CLI_RTOL:.0e}); resumed without a group "
              f"{resumed and no_group}, epochs logged {epochs}, finite "
              f"{finite}; seconds {', '.join(f'{k} {v:.1f}' for k, v in secs.items())} on {card}")
    if not (group and no_group and resumed and finite and err <= DP_CLI_RTOL
            and len(epochs) == 3 and set(first) == set(plain)):
        raise SystemExit("[dp] (b) the NCCL group of one rank failed a check")
    return {"loss_rel_err": err, "seconds": secs}


def dp_cli_cards(card):
    """[dp] (c): the training CLI started plainly over two cards (--mesh
    data:-1 --epoch_scan: it spawns an NCCL rank a card and captures their
    all-reduces in the epoch graph) against the same CLI on one card; each
    must end within DP_CLI_TIMEOUT."""
    with tempfile.TemporaryDirectory() as root:
        script = _cli_root(root)
        argv = [sys.executable, script, *FEED_ARGV, "--abspath", root,
                "--epoch_scan", "--mesh", "data:-1"]
        out, secs = {}, {}
        for label, cards in (("one", "0"), ("two", "0,1")):
            t0 = time.perf_counter()
            out[label] = _run_cli([*argv, "--name", label], root, cards,
                                  "c", f"{label}-card")
            secs[label] = time.perf_counter() - t0
        one, two = _dp_scalars(root, "one"), _dp_scalars(root, "two")
    group = "data parallel: 2 rank(s) over nccl" in out["two"]
    no_group = "data parallel" not in out["one"]
    err = _max_rel([two[k] for k in sorted(one)],
                   [one[k] for k in sorted(one)]) if set(one) == set(two) \
        else math.inf
    finite = all(math.isfinite(v) for v in two.values())
    log("dp", f"(c) the training CLI (--device_data --epoch_scan --mesh "
              f"data:-1, [feed]'s wavs) on two cards: 2 spawned NCCL ranks "
              f"{group}, losses of epochs {sorted({k[1] for k in two})} "
              f"against the CLI on one card rel_err {err:.2e} (tol "
              f"{DP_CLI_RTOL:.0e}), finite {finite}, ended within "
              f"{DP_CLI_TIMEOUT} s; seconds "
              f"{', '.join(f'{k} {v:.1f}' for k, v in secs.items())} on "
              f"{card}")
    if not (group and no_group and finite and err <= DP_CLI_RTOL):
        raise SystemExit("[dp] (c) the CLI over two cards failed a check")
    return {"loss_rel_err": err, "seconds": secs}


# [dp] (d): clip scoring over ranks, SS5 full width f32 (TF32 off) on
# CLIP_COUNT seeded 60-s clips, each path against one process on card 0:
# the ranks' rows ran in batches of another size (REPLY_TOL). The ranks
# gather the same rows bit for bit, but each overlap-adds them itself,
# and index_add_ on CUDA sums a label frame's up to 60 window
# contributions in no fixed order: the ranks agree to DP_RANKS_TOL. The
# served data-parallel artifact's replies are checked at a static batch
# of DP_ART_BATCH windows and its windows/s timed at DP_ART_BATCHES.
DP_INFER_MODES = {"exact": {}, "fast": {"fast": True},
                  "fast_clip_batch4": {"fast": True,
                                       "clip_batch": CLIP_COUNT}}
DP_INFER_REPS = 2
DP_RANKS_TOL = 1e-5
DP_INFER_TIMEOUT = 300
DP_ART_BATCH = 64
DP_ART_BATCHES = (64, 512)
DP_ART_REPS = 20


def _infer_clips():
    rng = np.random.RandomState(16)
    return [rng.randn(CLIP_FRAMES, 64, 7).astype(np.float32)
            for _ in range(CLIP_COUNT)]


def _infer_model(device, seed=0):
    from seld_tpu_torch.config import get_model_config
    from seld_tpu_torch.models import build_model
    cfg = get_model_config("SS5", search_paths=[])
    cfg["n_classes"] = 12
    return build_model("conv_temporal", (300, 64, 7), cfg, seed=seed,
                       device=device)


def _infer_run(device, mesh):
    """Each of DP_INFER_MODES on the seeded clips on `device` (split over
    `mesh`): its outputs, its launches (counted on a first run) and its ms
    a clip (host clock, the best of DP_INFER_REPS later runs)."""
    import torch
    from seld_tpu_torch.inference import ensemble_outputs
    from seld_tpu_torch.ops import kernels
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = _infer_model(device)
    clips = [torch.from_numpy(c).to(device) for c in _infer_clips()]
    out = {}
    for mode, kw in DP_INFER_MODES.items():
        def run():
            return ensemble_outputs(model, clips, batch_size=CLIP_BATCH,
                                    time_down=5, mesh=mesh, **kw)
        kernels.launch_counts.clear()
        got = run()
        torch.cuda.synchronize()
        counts = {k: kernels.launch_counts[k] for k in COUNTED}
        times = []
        for _ in range(DP_INFER_REPS):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3 / len(clips))
        out[mode] = {"outputs": [(a.cpu(), b.cpu()) for a, b in got],
                     "counts": counts, "ms_per_clip": min(times)}
    return out


def infer_worker(rank, world, port, backend, out):
    """One rank of [dp] (d1)/(d3): DP_INFER_MODES over the group's mesh;
    writes its result to `out`."""
    import torch
    import torch.distributed as dist
    from seld_tpu_torch.parallel.mesh import make_mesh
    device = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        result = _infer_run(device, make_mesh("data:-1", device))
        result["device"] = str(device)
        result["backend"] = dist.get_backend()
        torch.save(result, out)
    finally:
        dist.destroy_process_group()


def _infer_want_counts():
    """gru_scan launches a run of each mode: a biGRU (2) a chunk; the exact
    path's 541 windows in chunks of CLIP_BATCH, the fast path's in one
    chunk a clip, clip_batch's in one for all the clips."""
    n_win = (CLIP_FRAMES - 300) // 5 + 1
    chunks = {"exact": -(-n_win // CLIP_BATCH) * CLIP_COUNT,
              "fast": CLIP_COUNT, "fast_clip_batch4": 1}
    return {m: {k: 2 * chunks[m] if k == "gru_scan" else 0
                for k in ("gru_scan", "gru_scan_bwd", "stem_dy",
                          "foa_frontend", "gather_rows")}
            for m in DP_INFER_MODES}


def dp_infer_ranks(card, world, backend, label, ref):
    """[dp] (d1)/(d3): `world` ranks over `backend` score the clips against
    one process's `ref`; every rank's launches exact, the ranks agree."""
    want_counts = _infer_want_counts()
    with tempfile.TemporaryDirectory() as workdir:
        t0 = time.perf_counter()
        ranks = _run_ranks(world, backend, workdir, worker="--infer-worker",
                           timeout=DP_INFER_TIMEOUT)
        secs = time.perf_counter() - t0
    out = {}
    for mode in DP_INFER_MODES:
        between = max(_max_err(r[mode]["outputs"],
                               ranks[0][mode]["outputs"])
                      for r in ranks[1:])
        err = _max_err(ranks[0][mode]["outputs"], ref[mode]["outputs"])
        finite = all(bool(a.isfinite().all() and b.isfinite().all())
                     for a, b in ranks[0][mode]["outputs"])
        counts = [r[mode]["counts"] for r in ranks]
        ok = (between <= DP_RANKS_TOL and finite and err <= REPLY_TOL
              and all(c == want_counts[mode] for c in counts))
        ms = [r[mode]["ms_per_clip"] for r in ranks]
        log("dp", f"({label}) {world} ranks over {ranks[0]['backend']} on "
                  f"{sorted({r['device'] for r in ranks})}, "
                  f"ensemble_outputs(mesh=...) {mode} on {CLIP_COUNT} 60-s "
                  f"clips, SS5 full width f32, against one process on "
                  f"cuda:0: max_abs_err {err:.3e} (tol {REPLY_TOL:.0e}), "
                  f"between the ranks {between:.3e} (tol "
                  f"{DP_RANKS_TOL:.0e}), finite {finite}; "
                  f"launches a rank {[c['gru_scan'] for c in counts]} "
                  f"gru_scan (want {want_counts[mode]['gru_scan']}, no other "
                  f"kernel); ms a clip a rank "
                  f"{', '.join(f'{m:.2f}' for m in ms)} (one process "
                  f"{ref[mode]['ms_per_clip']:.2f}; host clock, best of "
                  f"{DP_INFER_REPS}); on {card} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"[dp] ({label}) the {world}-rank {mode} clip "
                             "scoring disagrees with one process")
        out[mode] = {"max_abs_err": err, "ranks_max_abs_err": between,
                     "ms_per_clip": ms,
                     "one_card_ms_per_clip": ref[mode]["ms_per_clip"],
                     "launches": counts[0]["gru_scan"]}
    log("dp", f"({label}) ranks' processes {secs:.1f} s")
    return out


def dp_artifact_refused(card):
    """[dp] (d2): a data-parallel window artifact for one card more than
    the machine has: its load must refuse with the device counts."""
    import torch
    from seld_tpu_torch.inference import export_window, load_exported
    n = torch.cuda.device_count() + 1
    with tempfile.TemporaryDirectory() as tmp:
        path = export_window(_infer_model("cuda"), f"{tmp}/dp.npz",
                             batch=DP_ART_BATCH * n, nr_devices=n)
        try:
            load_exported(path, device="cuda")
            message = None
        except ValueError as e:
            message = str(e)
    want = f"artifact wants {n} devices; {n - 1} visible"
    log("dp", f"(d2) a data-parallel window artifact, nr_devices {n}, "
              f"loaded on {n - 1} card(s): refused {message!r} (want "
              f"{want!r}) on {card}")
    if message != want:
        raise SystemExit("[dp] (d2) the load of a data-parallel artifact "
                         "for too many cards did not refuse")
    return message


def _best_rate(fn, rows, reps):
    """Windows/s of fn() on `rows` windows, the best of `reps` timed calls
    after one warm-up (host clock: each call ends with its copy back)."""
    fn()
    best = math.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return rows / best


def _in_turn(art):
    """The two-card artifact's blocks queued on the cards in turn from the
    calling thread, then copied back (the design its call does not use):
    a function of x."""
    import torch

    def run(x):
        with torch.inference_mode():
            outs = [art._launch(i, rows) for i, rows in
                    enumerate(x.chunk(art.nr_devices))]
            return [(s.cpu(), d.cpu()) for s, d in outs]
    return run


def dp_serve_cards(card):
    """[dp] (d3), serving: a two-card artifact (static batch DP_ART_BATCH)
    served against the live model on card 0 for requests of 1, 3 and 4
    windows; then windows/s of full requests at DP_ART_BATCHES (in
    process, through SELDServer) at one card and two, and the two cards'
    blocks queued in turn from one thread instead."""
    import torch
    from seld_tpu_torch.inference import export_window
    from seld_tpu_torch.ops import kernels
    from seld_tpu_torch.serving import SELDClient, SELDServer
    from seld_tpu_torch.serving.server import serve
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = _infer_model("cuda")
    rng = np.random.RandomState(17)
    errs, counts, rates = {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        two = export_window(model, f"{tmp}/two.npz", batch=DP_ART_BATCH,
                            nr_devices=2)
        svc = SELDServer(artifact=two, batch_window_ms=2.0,
                         max_batch=DP_ART_BATCH, device="cuda")
        httpd = serve(svc, "127.0.0.1", 0)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        try:
            client = SELDClient("127.0.0.1", httpd.server_address[1],
                                timeout=300)
            health = client.health()
            for b in (1, 3, 4):
                x = rng.randn(b, 300, 64, 7).astype(np.float32)
                kernels.launch_counts.clear()
                sed, doa = client.score(x)
                counts[b] = kernels.launch_counts["gru_scan"]
                with torch.inference_mode():
                    ws, wd = model(torch.from_numpy(x).cuda())
                errs[b] = max(np.abs(sed - ws.cpu().numpy()).max(),
                              np.abs(doa - wd.cpu().numpy()).max())
        finally:
            httpd.shutdown()
            httpd.server_close()
            svc.close()
            thread.join(timeout=10)
        nr = svc.nr_devices
        for batch in DP_ART_BATCHES:
            full = torch.from_numpy(rng.randn(batch, 300, 64, 7)
                                    .astype(np.float32))
            one = SELDServer(artifact=export_window(
                model, f"{tmp}/one{batch}.npz", batch=batch), device="cuda")
            both = SELDServer(artifact=export_window(
                model, f"{tmp}/two{batch}.npz", batch=batch, nr_devices=2),
                device="cuda")
            in_turn = _in_turn(both._default_slot.artifact)
            rates[batch] = {
                "one_card": _best_rate(lambda: one.score(full), batch,
                                       DP_ART_REPS),
                "two_cards": _best_rate(lambda: both.score(full), batch,
                                        DP_ART_REPS),
                "two_cards_in_turn": _best_rate(lambda: in_turn(full),
                                                batch, DP_ART_REPS)}
            del one, both, in_turn
    ok = (max(errs.values()) <= REPLY_TOL and nr == 2
          and health["artifact_meta"].get("nr_devices") == 2
          and all(c == 4 for c in counts.values()))
    log("dp", f"(d3) a two-card window artifact (static batch "
              f"{DP_ART_BATCH}, a replica on cuda:0 and cuda:1) served over "
              f"HTTP against the live model on cuda:0: requests of 1, 3, 4 "
              f"windows max_abs_err "
              f"{', '.join(f'{e:.3e}' for e in errs.values())} (tol "
              f"{REPLY_TOL:.0e}), gru_scan launches a request "
              f"{list(counts.values())} (want 4: a biGRU a card), /healthz "
              f"nr_devices {health['artifact_meta'].get('nr_devices')}; "
              f"served windows/s of full requests (in process, best of "
              f"{DP_ART_REPS}): "
              + "; ".join(f"B={b} one card {r['one_card']:.1f}, two cards "
                          f"{r['two_cards']:.1f} (the artifact's call: a "
                          f"worker thread a card), "
                          f"{r['two_cards_in_turn']:.1f} (the cards in "
                          f"turn from one thread)" for b, r in rates.items())
              + f" on {card} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("[dp] (d3) the two-card artifact disagrees with "
                         "the live model")
    return {"max_abs_err": max(errs.values()), "windows_per_s": rates}


def dp_infer(card, cards_only=False):
    """[dp] (d): clip scoring and serving over ranks; (d1) and (d2) on any
    machine (unless `cards_only`), (d3) where there are two cards."""
    import torch
    ref = _infer_run(torch.device("cuda", 0), None)
    want = _infer_want_counts()
    for mode, r in ref.items():
        if r["counts"] != want[mode]:
            raise SystemExit(f"[dp] (d) one process's {mode} launches "
                             f"{r['counts']} (want {want[mode]})")
    out = {}
    if not cards_only:
        out["gloo_one_card"] = dp_infer_ranks(card, 2, "gloo", "d1", ref)
        out["refused"] = dp_artifact_refused(card)
    if torch.cuda.device_count() >= 2:
        out["nccl_two_cards"] = dp_infer_ranks(card, 2, "nccl", "d3", ref)
        out["serve_two_cards"] = dp_serve_cards(card)
    else:
        log("dp", f"(d3) clip scoring and serving over two cards: not run, "
                  f"this machine has {torch.cuda.device_count()} card")
    return out


def phase_dp(card, only=None):
    """Data-parallel training: (a) 2 gloo ranks sharing the card, (b) an
    NCCL group of one rank through the CLI, (c) NCCL over 2 cards, steps
    and the CLI, where there are two; (d) clip scoring and serving over
    ranks (`dp_infer`). `only`: "faults", (a) alone with each of
    DP_FAULTS planted after it; "cards", (c) and (d3) alone."""
    import torch
    out = {}
    if only in (None, "faults"):
        out["gloo_one_card"] = dp_ranks(card, 2, "gloo", "a",
                                        DP_FAULTS if only else ())
    if only is None:
        out["nccl_cli"] = dp_cli(card)
    if only in (None, "cards"):
        if torch.cuda.device_count() >= 2:
            out["nccl_two_cards"] = dp_ranks(card, 2, "nccl", "c")
            out["cli_two_cards"] = dp_cli_cards(card)
        else:
            log("dp", f"(c) NCCL over two cards: not run, this machine has "
                      f"{torch.cuda.device_count()} card")
        out["infer"] = dp_infer(card, cards_only=only == "cards")
    if only == "cards":
        out["tp"] = phase_tp(card, cards_only=True)
    return out


# [tp]: tensor parallelism over a model axis, SS5 full width bf16, dropout
# off, TP_STEPS steps of the bench's batch of TP_BATCH windows (every rank
# holds all of them: data:1,model:2) from the bench's seeded weights, each
# rank holding half of every sharded kernel (parallel/partitioning.py),
# against one process's steps: [dp] (a)'s tolerances on the losses, the
# running statistics and the parameter updates (the shards put back
# together). Two gloo ranks share the card in the main run; --dp cards
# adds two NCCL ranks, a card each, and their ms a step.
TP_BATCH = 256
TP_STEPS = 3
TP_SPEC = "data:1,model:2"


def _tp_run(device, mesh):
    """TP_STEPS bench steps (SS5 bf16, dropout off) on the bench's batch,
    the model sharded over `mesh`'s model axis (whole without one); the
    losses, this rank's parameters and their shard dims, the statistics,
    launch counts and ms a step of the last TP_STEPS - 1."""
    import torch
    from seld_tpu_torch.bench import build
    from seld_tpu_torch.ops import kernels
    from seld_tpu_torch.parallel.partitioning import shard_tree
    from seld_tpu_torch.train.optimizers import adabelief
    from seld_tpu_torch.train.train_state import TrainState
    b = build(batch=TP_BATCH, dtype="bf16", device=device, dropout=False,
              mesh=mesh)
    before = {k: v.detach().float().cpu() for k, v in b.state.params.items()}
    if mesh is not None:
        # the bench's optimizer and state over this rank's shards
        model = shard_tree(b.state.model, mesh)
        b.state = TrainState(model, adabelief(list(model.parameters()),
                                              1e-3, agc_clip=0.01), seed=1)
    kernels.launch_counts.clear()
    losses, marks = [], []
    for _ in range(TP_STEPS):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)
        b.state, b.metric, (sl, dl) = b.step(b.state, b.metric, b.x, b.y)
        losses.append(torch.stack([sl, dl]))
    end = torch.cuda.Event(enable_timing=True)
    end.record()
    torch.cuda.synchronize()
    return {"losses": torch.stack(losses).cpu().numpy().tolist(),
            "before": before,
            "params": {k: v.detach().float().cpu()
                       for k, v in b.state.params.items()},
            "dims": dict(getattr(b.state.model, "tensor_parallel", {})),
            "model_index": 0 if mesh is None else mesh.model_index,
            "stats": {k: v.float().cpu()
                      for k, v in b.state.batch_stats.items()},
            "counts": {k: kernels.launch_counts[k] for k in COUNTED},
            "ms": marks[1].elapsed_time(end) / (len(marks) - 1)}


def tp_worker(rank, world, port, backend, out):
    """One rank of [tp]: TP_SPEC's mesh over the group; writes its result
    to `out`."""
    import torch
    import torch.distributed as dist
    from seld_tpu_torch.parallel.mesh import make_mesh
    torch.backends.cudnn.deterministic = True
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        result = _tp_run(device, make_mesh(TP_SPEC, device))
        result["device"] = str(device)
        result["backend"] = dist.get_backend()
        torch.save(result, out)
    finally:
        dist.destroy_process_group()


def _tp_whole(ranks, key):
    """A parameter put back together from the model ranks' shards."""
    import torch
    d = ranks[0]["dims"].get(key)
    if d is None:
        return ranks[0]["params"][key]
    return torch.cat([r["params"][key] for r in
                      sorted(ranks, key=lambda r: r["model_index"])], d)


def tp_ranks(card, backend, label, want):
    """[tp] over two ranks of `backend` against one process's `want`."""
    import torch
    per_step = {"gru_scan": 2, "gru_scan_bwd": 2, "stem_dy": 1}
    want_counts = {n: per_step.get(n, 0) * TP_STEPS
                   for n in ("gru_scan", "gru_scan_bwd", "stem_dy",
                             "foa_frontend", "gather_rows")}
    with tempfile.TemporaryDirectory() as workdir:
        t0 = time.perf_counter()
        ranks = _run_ranks(2, backend, workdir, worker="--tp-worker")
        secs = time.perf_counter() - t0
    loss_err = max(_max_rel(np.ravel(r["losses"]).tolist(),
                            np.ravel(want["losses"]).tolist())
                   for r in ranks)
    stats_err, stats_key = max(
        (((r["stats"][k] - w).abs().max()
          / (DP_STATS_RTOL * w.abs().max() + DP_STATS_ATOL)).item(), k)
        for r in ranks for k, w in want["stats"].items())
    du = torch.cat([(_tp_whole(ranks, k) - want["before"][k]
                     - (w - want["before"][k])).ravel()
                    for k, w in want["params"].items()])
    ref = torch.cat([(w - want["before"][k]).ravel()
                     for k, w in want["params"].items()])
    update_err = (du.norm() / ref.norm()).item()
    dims = ranks[0]["dims"]
    sharded = sum(1 for k in dims)
    halves = all(ranks[0]["params"][k].shape[d] * 2
                 == want["params"][k].shape[d] for k, d in dims.items())
    stem = "Conv2DBN_0.Conv_0.kernel" in dims
    counts_ok = all(r["counts"] == want_counts for r in ranks)
    finite = all(math.isfinite(v) for r in ranks
                 for v in np.ravel(r["losses"]))
    ok = (counts_ok and finite and halves and stem and sharded
          and loss_err <= DP_LOSS_RTOL and stats_err <= 1.0
          and update_err <= DP_UPDATE_RTOL)
    log("tp", f"({label}) {TP_SPEC} over {ranks[0]['backend']} on "
              f"{sorted({r['device'] for r in ranks})}: SS5 full width bf16 "
              f"B={TP_BATCH} dropout off, {TP_STEPS} steps, {sharded} "
              f"parameters sharded in halves {halves} (the stem's 32 "
              f"filters {stem}), against one process: losses rel_err "
              f"{loss_err:.2e} (tol {DP_LOSS_RTOL:.0e}), running statistics "
              f"at {stats_err:.2f} of their tolerance (worst {stats_key}), "
              f"parameter updates {update_err:.2e} in norm (tol "
              f"{DP_UPDATE_RTOL}); launches a rank "
              f"{[r['counts'] for r in ranks]} (want {want_counts}); ms a "
              f"step {[round(r['ms'], 4) for r in ranks]} (one process "
              f"{want['ms']:.4f}); ranks' processes {secs:.1f} s, on {card} "
              f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"[tp] ({label}) the sharded step disagrees with "
                         "the one-process step")
    return {"launches": [r["counts"] for r in ranks],
            "ms": [r["ms"] for r in ranks], "one_process_ms": want["ms"],
            "loss_rel_err": loss_err, "stats_err": stats_err,
            "update_err": update_err, "backend": ranks[0]["backend"]}


def phase_tp(card, cards_only=False):
    """[tp]: two gloo ranks sharing the card (unless `cards_only`), then
    two NCCL ranks on two cards where there are two."""
    import torch
    torch.backends.cudnn.deterministic = True
    try:
        want = _tp_run(torch.device("cuda", 0), None)
    finally:
        torch.backends.cudnn.deterministic = False
    out = {}
    if not cards_only:
        out["gloo_one_card"] = tp_ranks(card, "gloo", "a", want)
    if torch.cuda.device_count() >= 2:
        out["nccl_two_cards"] = tp_ranks(card, "nccl", "b", want)
    else:
        log("tp", f"(b) NCCL over two cards: not run, this machine has "
                  f"{torch.cuda.device_count()} card")
    return out


# [tools]: the tooling twins on the card. TOOLS_CLIPS seeded 60-s wavs
# through extract_features (chunks of 8: a front-end launch each), held
# to the kernel's plain version on the card (FRONTEND_TOL); bench_frontend at
# TOOLS_BENCH_CLIPS clips; profile_train (SS5 B=256 bf16) with a trace
# parsed by trace_analysis; a seeded SS5's weights as Keras-named layers
# through the h5 import's mapping, saved, loaded and served.
TOOLS_CLIPS = 10
# the IV channels are unit vectors of the FOA intensity, ill-conditioned
# in bins where it vanishes: there the CLI's features are held to the
# function in float64, no farther than this factor of the plain
# version's own distance
TOOLS_IV_FACTOR = 2.0
TOOLS_BENCH_CLIPS = 16
TOOLS_PROFILE_STEPS = 5
SMOKE_STEPS, SMOKE_CHUNKS = 10, 3      # smoke.py: 41 windows, batch 16


def _want(**counts):
    """Launch counts of every COUNTED kernel (0 where not given)."""
    return {k: counts.get(k, 0) for k in COUNTED}


def _launched(fn):
    """(fn(), every kernel's launches while it ran)."""
    out, counts = _counted(fn)
    return out, _want(**counts)


def _plain_features(wavs):
    """The features [T, 64, 7] of equal-length wavs through the front-end
    kernel's plain version (`foa_frontend_ref`) on the card, with
    `fused_foa_frontend`'s padding, dB step and layout, and the IV [T, 64,
    3] of the function in float64 (`frontend_f64`), a clip each."""
    import torch
    from seld_tpu_torch.ops.frontend import foa_frontend_ref
    from seld_tpu_torch.ops.mel import amplitude_to_db
    from seld_tpu_torch.ops.stft import reflect_pad
    out = []
    for i in range(0, len(wavs), 8):
        batch = torch.from_numpy(np.stack(wavs[i:i + 8])).cuda()
        padded = reflect_pad(batch, 512).contiguous()
        mel, iv = foa_frontend_ref(padded)
        feats = torch.cat([amplitude_to_db(mel, clip_dims=1), iv],
                          dim=1).permute(0, 2, 3, 1).cpu().numpy()
        iv64 = frontend_f64(padded)[1].permute(0, 2, 3, 1).cpu().numpy()
        out += list(zip(feats, iv64))
    return out


def tools_extract(card):
    """extract_features on TOOLS_CLIPS seeded 60-s wavs on the card against
    the features of the kernel's plain version from the same wavs."""
    import contextlib
    import io as io_mod
    from seld_tpu_torch import extract_features
    from seld_tpu_torch.data.loader import read_wav
    from seld_tpu_torch.ops.features import preprocess_features_labels
    with tempfile.TemporaryDirectory() as root:
        write_wav_tree(root, {1: TOOLS_CLIPS}, FEED_SECONDS, seed=17)
        wav_dir = os.path.join(root, "foa_dev")
        argv = ["--wav_dir", wav_dir, "--label_dir",
                os.path.join(root, "metadata_dev"), "--out_dir",
                os.path.join(root, "feat"), "--label_out_dir",
                os.path.join(root, "label"), "--n_classes", "12"]
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io_mod.StringIO()):
            _, counts = _launched(lambda: extract_features.main(argv))
        secs = time.perf_counter() - t0
        names = sorted(os.listdir(wav_dir))
        wavs = [read_wav(os.path.join(wav_dir, n))[0] for n in names]
        db_err = iv_err = iv64_err = plain64_err = 0.0
        for name, (p, iv64) in zip(names, _plain_features(wavs)):
            got = np.load(os.path.join(root, "feat",
                                       name.replace(".wav", ".npy")))
            want, _ = preprocess_features_labels(
                p, np.zeros((600, 48), np.float32))
            db_err = max(db_err, float(np.abs(got[..., :4]
                                              - want[..., :4]).max()))
            iv_err = max(iv_err, float(np.abs(got[..., 4:]
                                              - want[..., 4:]).max()))
            t = min(len(iv64), len(got))
            iv64_err = max(iv64_err, float(np.abs(got[:t, ..., 4:]
                                                  - iv64[:t]).max()))
            plain64_err = max(plain64_err, float(np.abs(p[:t, ..., 4:]
                                                        - iv64[:t]).max()))
            labels = np.load(os.path.join(root, "label",
                                          name.replace(".wav", ".npy")))
            assert labels.shape == (600, 48), labels.shape
    want_counts = _want(foa_frontend=-(-TOOLS_CLIPS // 8))
    ok = (db_err <= FRONTEND_TOL and counts == want_counts
          and iv64_err <= TOOLS_IV_FACTOR * max(plain64_err, FRONTEND_TOL))
    log("tools", f"(b) python -m seld_tpu_torch.extract_features on "
                 f"{TOOLS_CLIPS} seeded 60-s wavs: {secs:.2f} s, features "
                 f"[3000, 64, 7] against foa_frontend_ref's on the card: "
                 f"log-mel max_abs_err {db_err:.2e} (tol "
                 f"{FRONTEND_TOL:.0e}), IV {iv_err:.2e}; IV against the "
                 f"function in float64: the CLI's {iv64_err:.2e}, the plain "
                 f"version's {plain64_err:.2e} (tol {TOOLS_IV_FACTOR} x the "
                 f"plain version's, at least {FRONTEND_TOL:.0e}); launches "
                 f"{counts} (want {want_counts}) on {card} "
                 f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("[tools] (b) extract_features disagrees with the "
                         "plain front-end or skipped its kernel")
    return {"launches": counts, "seconds": secs,
            "max_abs_err": max(db_err, iv_err)}


def _keras_layers(model, x):
    """The model's weights as the layers of a Keras legacy file would hold
    them (per-base auto-names, `compat.keras_h5.H5Layer`), in application
    order."""
    from seld_tpu_torch.compat.keras_h5 import H5Layer, call_order
    sd = {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}
    counts, layers = {}, []
    for kind, path in call_order(model, x):
        p = {k[len(path) + 1:]: v for k, v in sd.items()
             if k.startswith(path + ".") and "." not in k[len(path) + 1:]}
        if kind in ("conv", "dense"):
            base = {"dense": "dense", "conv": "conv2d"
                    if p["kernel"].ndim == 4 else "conv1d"}[kind]
            ws = [(n, p[n]) for n in ("kernel", "bias") if n in p]
        elif kind == "bn":
            base = "batch_normalization"
            ws = [("gamma", p["scale"]), ("beta", p["bias"]),
                  ("moving_mean", p["mean"]), ("moving_variance", p["var"])]
        elif kind == "ln":
            base, ws = "layer_normalization", [("gamma", p["scale"]),
                                               ("beta", p["bias"])]
        elif kind == "rnn":
            cell = "gru" if p["recurrent_kernel"].shape[2] \
                == 3 * p["recurrent_kernel"].shape[1] else "lstm"
            base = "bidirectional" if p["kernel"].shape[0] == 2 else cell
            ws = [(f"{d}_{cell}/{cell}_cell/{n}", p[n][i])
                  for i, d in enumerate(("forward", "backward")[
                      :p["kernel"].shape[0]])
                  for n in ("kernel", "recurrent_kernel", "bias")]
        else:
            base = ("rel_position_multi_head_attention"
                    if "pos_kernel" in p else "multi_head_attention_")
            ws = list(p.items())
        n = counts.get(base, 0)
        counts[base] = n + 1
        name = base if n == 0 else f"{base}_{n}"
        layers.append(H5Layer(name, [(f"{name}/{w}", a) for w, a in ws]))
    return layers


def tools_import(card):
    """A seeded SS5's weights, as a Keras checkpoint's layers, mapped onto
    a model of other weights by the h5 import (`align_entries`,
    `set_mapped_weights`; the card machine has no h5py, so the layers
    reach the importer as `H5Layer`s rather than through a file, whose
    reading tests/test_torch_keras_h5.py checks on the CPU), saved with
    `save_variables`, loaded by `load_variables` and served as a window
    artifact: the reply equals the seeded model's forward."""
    import torch
    from seld_tpu_torch.compat.keras_h5 import (align_entries, call_order,
                                                set_mapped_weights)
    from seld_tpu_torch.inference import export_window
    from seld_tpu_torch.serving import SELDClient, SELDServer
    from seld_tpu_torch.serving.server import serve
    from seld_tpu_torch.train.checkpoint import (load_variables,
                                                 save_variables)
    source = _infer_model("cuda")
    x0 = torch.zeros(1, 300, 64, 7, device="cuda")
    layers = _keras_layers(source, x0)
    target = _infer_model("cuda", seed=5)

    def mapped():
        order = call_order(target, x0)
        return set_mapped_weights(target.state_dict(), order,
                                  align_entries(target, order,
                                                list(reversed(layers))))
    sd, import_counts = _launched(mapped)
    target.load_state_dict(sd)
    rng = np.random.RandomState(21)
    x = rng.randn(2, 300, 64, 7).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = save_variables(os.path.join(tmp, "imported"), target,
                              {"imported_from": "seeded SS5 layers"})
        served = load_variables(ckpt, _infer_model("cuda", seed=9))
        svc = SELDServer(artifact=export_window(
            served, os.path.join(tmp, "w.npz"), batch=2),
            batch_window_ms=2.0, max_batch=2, device="cuda")
        httpd = serve(svc, "127.0.0.1", 0)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        try:
            client = SELDClient("127.0.0.1", httpd.server_address[1],
                                timeout=300)
            (sed, doa), serve_counts = _launched(lambda: client.score(x))
        finally:
            httpd.shutdown()
            httpd.server_close()
            svc.close()
            thread.join(timeout=10)
    with torch.inference_mode():
        ws, wd = source(torch.from_numpy(x).cuda())
    err = max(np.abs(sed - ws.cpu().numpy()).max(),
              np.abs(doa - wd.cpu().numpy()).max())
    exact = all(torch.equal(sd[k], v) for k, v in
                source.state_dict().items())
    ok = (exact and err <= REPLY_TOL and import_counts == _want(gru_scan=2)
          and serve_counts == _want(gru_scan=2))
    log("tools", f"(e) a seeded SS5's {len(layers)} layers, Keras-named "
                 f"and listed in reverse, imported onto other weights: "
                 f"every tensor equal {exact}; saved, loaded and served as "
                 f"a window artifact: reply max_abs_err {err:.3e} (tol "
                 f"{REPLY_TOL:.0e}) against the seeded model; launches of "
                 f"the import's forward {import_counts}, of the request "
                 f"{serve_counts} (want 2 gru_scan each) on {card} "
                 f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("[tools] (e) the imported weights do not serve as "
                         "the source model")
    return {"launches": {k: import_counts[k] + serve_counts[k]
                         for k in import_counts}, "max_abs_err": err}


def phase_tools(card):
    """[tools]: (a) the smoke twin, (b) extract_features, (c)
    bench_frontend, (d) profile_train with a trace, (e) the h5 import
    served; returns the launches by part."""
    import contextlib
    import io as io_mod
    from seld_tpu_torch import bench_frontend, profile_train, smoke
    from seld_tpu_torch.utils.trace_analysis import analyze_trace
    out = {}
    text = io_mod.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(text):
        code, counts = _launched(lambda: smoke.main([]))
    want = _want(gru_scan=SMOKE_STEPS + SMOKE_CHUNKS,
                 gru_scan_bwd=SMOKE_STEPS)
    ok = code == 0 and "SMOKE PASS" in text.getvalue() and counts == want
    log("tools", f"(a) python -m seld_tpu_torch.smoke: "
                 f"{text.getvalue().strip().splitlines()[-1]!r} in "
                 f"{time.perf_counter() - t0:.1f} s; launches {counts} "
                 f"(want {want}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("[tools] (a) the smoke twin failed")
    out["smoke"] = counts

    out["extract_features"] = tools_extract(card)

    with contextlib.redirect_stdout(io_mod.StringIO()):
        times, counts = _launched(lambda: bench_frontend.main(
            ["--clips", str(TOOLS_BENCH_CLIPS)]))
    chunks = -(-TOOLS_BENCH_CLIPS // 8)
    want = _want(foa_frontend=2 + 1 + 2 * chunks + TOOLS_BENCH_CLIPS)
    ok = counts == want and all(v > 0 for v in times.values())
    log("tools", f"(c) python -m seld_tpu_torch.bench_frontend, "
                 f"{TOOLS_BENCH_CLIPS} 60-s clips: batched int16 "
                 f"{times['batched_pcm_s']:.3f} s, batched float32 "
                 f"{times['batched_float_s']:.3f} s, per clip "
                 f"{times['per_clip_float_s']:.3f} s "
                 f"({times['per_clip_float_s'] / times['batched_pcm_s']:.2f}x"
                 f"); launches {counts} (want {want}) on {card} "
                 f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("[tools] (c) bench_frontend failed")
    out["bench_frontend"] = {"launches": counts, "seconds": times}

    with tempfile.TemporaryDirectory() as tmp:
        with contextlib.redirect_stdout(io_mod.StringIO()):
            summary, counts = _launched(lambda: profile_train.main(
                ["--steps", str(TOOLS_PROFILE_STEPS), "--trace", tmp]))
        report = analyze_trace(tmp)
    steps = 1 + 2 + TOOLS_PROFILE_STEPS
    want = _want(gru_scan=2 * steps, gru_scan_bwd=2 * steps, stem_dy=steps)
    families = {key: ms for ms, _, _, key in report["ops"]}
    ok = (counts == want and {"gru_scan", "gru_scan_bwd", "stem_dy", "conv",
                              "gemm", "elementwise"} <= set(families))
    log("tools", f"(d) python -m seld_tpu_torch.profile_train --trace (SS5 "
                 f"B=256 bf16): p50 {summary['p50_s'] * 1e3:.2f} ms, p90 "
                 f"{summary['p90_s'] * 1e3:.2f} ms, "
                 f"{summary['windows_per_sec']:.1f} windows/s; the trace's "
                 f"card kernels {report['total_ms']:.2f} ms over "
                 f"{report['n_events']} events by family "
                 + ", ".join(f"{k} {v:.2f}" for k, v in families.items())
                 + f"; launches {counts} (want {want}) on {card} "
                 f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("[tools] (d) profile_train or its trace failed")
    out["profile_train"] = {"launches": counts, "summary": summary,
                            "families_ms": families}

    out["import"] = tools_import(card)
    return out


def ptxas_report(text):
    """One line per kernel of an `nvcc -Xptxas -v` log: its name (template
    arguments in brackets), registers and spills."""
    import re
    out, name, spill = [], "?", ""
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            mangled = m.group(1)
            k = re.search(r"\d+([A-Za-z]\w*?_kernel)(\w*)", mangled)
            args = [] if not k else re.findall(r"Li(\d+)E", k.group(2)) + (
                ["bf16"] if "bfloat16" in k.group(2) else [])
            name = mangled if not k else k.group(1) + (
                f"<{','.join(args)}>" if args else "")
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line:
            out.append(f"{name}: {line.split(':', 1)[-1].strip()}; {spill}")
    return out


def main(argv=None):
    import argparse
    parser = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument(
        "--kernels-only", action="store_true",
        help="build, check and time the kernels (phase 3, every kernel "
             "even after one fails), then stop with no result line")
    parser.add_argument(
        "--dp", choices=("faults", "cards"), default=None,
        help="build the kernels, then run only [dp] (a) and after it each "
             "planted fault, which (a)'s comparison must catch (faults), "
             "or only [dp] (c) and (d3), NCCL steps, the CLI, clip scoring "
             "and serving over two cards, and [tp] (b), the sharded step "
             "over two NCCL cards (cards); no result line")
    parser.add_argument(
        "--gru-wide", choices=("all", "step"), default=None,
        help="build the kernels, then run only gru_wide (all: the GRU "
             "kernels past U = 256 and the U=384 SS5 step) or only its SS5 "
             "step (step); no result line")
    parser.add_argument("--dp-worker", nargs=6, default=None,
                        metavar=("RANK", "WORLD", "PORT", "BACKEND", "OUT",
                                 "FAULT"),
                        help="internal: one rank of the [dp] phase")
    parser.add_argument("--infer-worker", nargs=5, default=None,
                        metavar=("RANK", "WORLD", "PORT", "BACKEND", "OUT"),
                        help="internal: one rank of [dp] (d1)/(d3)")
    parser.add_argument("--tp-worker", nargs=5, default=None,
                        metavar=("RANK", "WORLD", "PORT", "BACKEND", "OUT"),
                        help="internal: one rank of [tp]")
    args = parser.parse_args(argv)
    if args.dp_worker:
        rank, world, port, backend, out, fault = args.dp_worker
        return dp_worker(int(rank), int(world), int(port), backend, out,
                         fault)
    if args.infer_worker:
        rank, world, port, backend, out = args.infer_worker
        return infer_worker(int(rank), int(world), int(port), backend, out)
    if args.tp_worker:
        rank, world, port, backend, out = args.tp_worker
        return tp_worker(int(rank), int(world), int(port), backend, out)
    kernels_only = args.kernels_only
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (this script measures "
                         "the port on the card and never falls back to the "
                         "CPU)")
    from seld_tpu_torch.ops import kernels

    # every comparison below is f32 against f32: no TF32 in cuBLAS or cuDNN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log("device", smi)

    t0 = time.perf_counter()
    logs = kernels.build()
    for src, text in logs.items():
        for line in ptxas_report(text):
            log("build", f"{src}: {line}")
    log("build", f"{len(kernels.SOURCES)} kernel source(s) ready in "
                 f"{time.perf_counter() - t0:.1f} s")

    if kernels_only:
        failed = []
        for phase in (phase_sass, phase_kernels, phase_kernels_bwd,
                      kernels_batch_norm, kernels_batch_norm_pool, gru_wide,
                      phase_kernels_feed):
            try:
                phase(smi)
            except SystemExit as e:
                log("kernels", f"{phase.__name__} FAILED: {e}")
                failed.append(phase.__name__)
        raise SystemExit(f"failed: {failed}" if failed else 0)
    if args.gru_wide:
        t0 = time.perf_counter()
        (gru_wide if args.gru_wide == "all" else wide_step)(smi)
        log("time", f"gru_wide ({args.gru_wide}) "
                    f"{time.perf_counter() - t0:.1f} s")
        raise SystemExit(0)
    if args.dp:
        t0 = time.perf_counter()
        phase_dp(smi, only=args.dp)
        log("time", f"phase_dp ({args.dp}) {time.perf_counter() - t0:.1f} s")
        raise SystemExit(0)
    phase_seconds = {}

    def timed(phase, *args):
        t0 = time.perf_counter()
        out = phase(*args)
        phase_seconds[phase.__name__] = time.perf_counter() - t0
        log("time", f"{phase.__name__} {phase_seconds[phase.__name__]:.1f} s")
        return out

    entries = [timed(phase_kernels, smi)] + timed(phase_kernels_bwd, smi)
    # batch_norm's launches follow each model's BatchNorms: its entry takes
    # the SS5 phases' counts alone
    bn_entry = timed(kernels_batch_norm, smi)
    pool_entry = timed(kernels_batch_norm_pool, smi)
    entries[0]["wide"], entries[1]["wide"] = timed(gru_wide, smi)
    feed_entries = timed(phase_kernels_feed, smi)
    timed(phase_routes, smi)
    model = timed(phase_model, smi)
    entries[0]["launches"] = timed(phase_serve, model, smi)
    del model
    train_counts, fused = timed(phase_train, smi)
    entries[0]["train_launches"] = train_counts["gru_scan"]
    for e in entries[1:]:
        e["launches"] = train_counts[e["name"]]
    graph_counts = timed(phase_graph, smi)
    for e in (bn_entry, pool_entry):
        e.update(launches=train_counts[e["name"]],
                 graph_launches=graph_counts[e["name"]],
                 train_fused_launches=fused["launches"][e["name"]])
    feed_counts = timed(phase_feed, smi)
    for e in feed_entries:
        e["launches"] = feed_counts["eager"][e["name"]]
    for e in entries:
        e["feed_launches"] = feed_counts["eager"][e["name"]]
    entries += feed_entries
    tdm_mic, tdm_timing = timed(phase_tdm_mic, smi)
    for e in entries:
        for label, (counts, rate) in tdm_mic.items():
            e[f"{label}_launches"] = counts[e["name"]]
    entries[-2]["tdm_rebuilds"] = tdm_timing
    entries[-1]["feed_windows_per_s"] = {
        label: rate for label, (_, rate) in tdm_mic.items()}
    for e in entries:
        e["graph_launches"] = graph_counts[e["name"]]
        e["epoch_scan_launches"] = feed_counts["epoch_scan"][e["name"]]
        e["epoch_scan_fused_launches"] = feed_counts[
            "epoch_scan+fuse_metrics"][e["name"]]
    clip = timed(phase_clip, smi)
    timed(phase_answer, smi)
    stream = timed(phase_stream, smi)
    for e in entries:
        e["clip_launches"] = 0
        e["stream_launches"] = stream["launches"].get(e["name"], 0)
    entries[0]["clip_launches"] = clip["launches"]["exact"] + \
        clip["launches"]["fast"]
    entries[0]["clip_launches_by_path"] = clip["launches"]
    for name, m in clip["gru"].items():
        entries[0][f"clip_{name}_shape"] = m
    entries[0]["stream_timing"] = stream["timing"]
    entries[0]["stream_halo"] = stream["halo"]
    nas = timed(phase_nas, smi)
    vad = timed(phase_vad, smi)
    by_name = {e["name"]: e for e in entries}
    for e in entries:
        e["nas_launches"] = nas["launches"].get(e["name"], 0)
        e["vad_launches"] = vad["launches"].get(e["name"], 0)
    by_name["gru_scan"]["nas_f32_b256"] = nas["gru_fwd"]
    by_name["gru_scan_bwd"]["nas_f32_b256"] = nas["gru_bwd"]
    by_name["stem_dy"]["nas_f32_b256"] = nas["stem"]
    by_name["gather_rows"]["nas_candidates"] = nas["candidates"]
    by_name["gather_rows"]["nas_seconds"] = nas["seconds"]
    by_name["gather_rows"]["nas_parallel"] = nas["parallel_seconds"]
    by_name["gather_rows"]["vad"] = {k: vad[k] for k in (
        "rehearsal", "search_val_auc", "seconds")}
    zoo = timed(phase_zoo, smi)
    for e in entries:
        e["zoo_launches"] = {n: r["launches"][e["name"]]
                             for n, r in zoo["bf16"].items()}
    pool_entry["zoo_launches"] = {n: r["launches"]["batch_norm_pool"]
                                  for n, r in zoo["bf16"].items()}
    by_name["gru_scan"]["zoo"] = {n: {**zoo["bf16"][n], **zoo["forward"][n]}
                                  for n in zoo["bf16"]}
    by_name["stem_dy"]["zoo_pool_5x1"] = zoo["stem_dy"]
    by_name["gru_scan"]["zoo_seconds"] = zoo["seconds"]
    blocks = timed(phase_blocks, smi)
    for e in entries:
        e["blocks_launches"] = {n: r["launches"][e["name"]]
                                for n, r in blocks["bf16"].items()}
        e["blocks_cli_launches"] = blocks["cli"]["launches"][e["name"]]
    by_name["gru_scan"]["blocks"] = {
        n: {**blocks["bf16"][n], **blocks["forward"][n]}
        for n in blocks["bf16"]}
    by_name["gru_scan"]["blocks_cli_windows_per_s"] = \
        blocks["cli"]["windows_per_s"]
    by_name["gru_scan"]["blocks_seconds"] = blocks["seconds"]
    dp = timed(phase_dp, smi)
    infer_launches = {m: r["launches"] for m, r in
                      dp["infer"]["gloo_one_card"].items()}
    for e in entries:
        e["dp_launches"] = dp["gloo_one_card"]["launches"][e["name"]]
        e["dp_infer_launches"] = (infer_launches if e["name"] == "gru_scan"
                                  else {m: 0 for m in infer_launches})
    by_name["gru_scan"]["dp"] = dp
    tp = timed(phase_tp, smi)
    tools = timed(phase_tools, smi)
    for e in entries:
        e["train_fused_launches"] = fused["launches"][e["name"]]
        e["tp_launches"] = [c[e["name"]] for c in
                            tp["gloo_one_card"]["launches"]]
        e["tools_launches"] = {
            part: (r if part == "smoke" else r["launches"])[e["name"]]
            for part, r in tools.items()}
    by_name["gru_scan"]["train_fused_ms"] = fused["ms"]
    by_name["gru_scan"]["tp"] = tp
    by_name["foa_frontend"]["tools"] = {
        "extract_features": tools["extract_features"],
        "bench_frontend_seconds": tools["bench_frontend"]["seconds"]}
    by_name["stem_dy"]["profile_train"] = tools["profile_train"]

    log("time", f"all phases {time.perf_counter() - t_start:.1f} s")
    entries += [bn_entry, pool_entry]
    entries[0]["phase_seconds"] = phase_seconds
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
