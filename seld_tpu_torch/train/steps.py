"""The training and eval steps (seld_tpu/train/steps.py).

One step: forward in train mode (BatchNorm running statistics update in
place, dropout masks from the state's generator) -> dual loss + L2 kernel
penalty -> gradients -> AGC -> optimizer update of the f32 master
parameters, with the streaming metric updated from the step's predictions.

Mixed precision follows the JAX recipe exactly, not torch.autocast: x is
cast once to `compute_dtype`; every f32 parameter is cast to it inside the
loss (bf16 copies through `torch.func.functional_call`), so gradients flow
back through the cast to the f32 masters; the running statistics stay f32;
predictions are upcast to f32 before the loss.

`make_train_step` runs one step eagerly. One program (`_program`) runs
the same update as a captured CUDA graph on a CUDA device and as a plain
loop on the CPU (train/graphs.py): each step reads its batch at a
device-side counter and writes its outputs there, so the graph holds no
per-step value of the host. Three fronts feed it: `make_train_epoch`
gathers each step's batch from a card-resident split, and
`make_train_multistep` (k stacked batches a call) and
`make_train_step(fuse_metrics=True)` (one batch, the metric inside) read
it from the batches they stage.

Data parallelism (`mesh=` of parallel/mesh.py under a process group):
each rank holds its rows of the global batch, and a step on N ranks
computes what one rank computes on the whole batch, up to the order of
the sums. Inside the step (parallel/collectives.py): BatchNorm's and the
fused stem's statistics are the global batch's; dropout masks and augment
draws are drawn at the global batch's size and sliced; the losses read the
gathered global predictions and labels, so each loss (the SED means, the
masked MSE's sum over the global mask) is the one-rank formula on the
global batch; the L2 penalty is added once over the ranks (1/N each); the
gradients are summed by one all-reduce of a flat buffer, so AGC and the
optimizer see the same gradients on every rank; the metric adds the
all-reduced sums of this rank's rows (`metrics.update_global`). With NCCL
the all-reduces are captured in the step's CUDA graph; gloo cannot be
captured, so a gloo group runs the steps eagerly on any device.

Tensor parallelism (a mesh with a `model` axis, the model's kernels
sharded by parallel/partitioning.py's `shard_tree`): the batch's
collectives above run over the data sub-group; each sharded layer puts
its output together over the model sub-group (models/layers.py), so the
losses, the metric and every replicated leaf's gradient are whole on
every rank; a sharded leaf's gradient is its shard's, and AGC's unit
norms over a sharded dim sum over the model group.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from seld_tpu_torch.ops.gather import gather_batch
from seld_tpu_torch.parallel import collectives
from seld_tpu_torch.train import metrics as M
from seld_tpu_torch.train.graphs import StepLoop
from seld_tpu_torch.train.train_state import TrainState
from seld_tpu_torch.utils.profiling import span


def l2_kernel_penalty(params: Dict[str, torch.Tensor],
                      l2: float) -> torch.Tensor:
    """l2 * sum(w^2) over kernel leaves (keras l1_l2(l2=1e-3) on every
    layer with a kernel_regularizer), skipping every leaf under a module
    named GRU_*/LSTM_* and every recurrent_kernel, as the reference does.
    `params` maps state_dict paths, which equal the flax paths, to f32
    master tensors."""
    device = next(iter(params.values())).device
    if l2 == 0.0:
        return torch.zeros((), device=device)
    squares = []
    for path, p in params.items():
        names = path.split(".")
        if names[-1] == "recurrent_kernel" or any(
                n.startswith(("GRU_", "LSTM_")) for n in names):
            continue
        if "kernel" in names[-1]:
            squares.append(p.square().sum())
    if not squares:
        return torch.zeros((), device=device)
    return l2 * torch.stack(squares).sum()


def _zeros_for_unused(model, params, grads):
    """`grads` with zeros for the leaves the loss does not reach, as
    jax.grad gives them. Only a leaf that its module declares may go unused
    (`unused_parameters`: names under that module, as RFFPosEncoding's
    stop-gradient `w` and tcn_stage's last residual conv) may be one: any
    other is a wiring fault and raises."""
    if all(g is not None for g in grads):
        return grads
    declared = {f"{prefix}.{n}" if prefix else n
                for prefix, m in model.named_modules()
                for n in getattr(m, "unused_parameters", ())}
    stray = [k for k, g in zip(params, grads)
             if g is None and k not in declared]
    if stray:
        raise RuntimeError(f"no gradient reaches {stray}")
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(params.values(), grads)]


def _gathered(y, preds):
    """The global batch's labels and predictions on every rank of the
    active data-parallel step (one all-reduce; the predictions keep their
    gradient), or (y, preds) outside one."""
    if collectives.active() is None:
        return y, preds
    parts = (*preds, *y)
    widths = [p.shape[-1] for p in parts]
    packed = collectives.gather_rows(
        torch.cat([p.float() for p in parts], dim=-1))
    out = [o.to(p.dtype) for o, p in zip(packed.split(widths, dim=-1),
                                         parts)]
    return tuple(out[len(preds):]), tuple(out[:len(preds)])


def _all_reduce_grads(grads):
    """The gradients summed over the ranks of the active step: one
    all-reduce of a flat buffer (none outside a step)."""
    if collectives.active() is None:
        return grads
    flat = collectives.batch_reduce_(
        torch.cat([g.reshape(-1).float() for g in grads]))
    return [part.view_as(g).to(g.dtype)
            for part, g in zip(flat.split([g.numel() for g in grads]), grads)]


def _uses_graphs(mesh) -> bool:
    """Whether a multi-step or epoch program may be captured: not under a
    gloo group, whose collectives a CUDA graph cannot hold."""
    if mesh is None or not mesh.distributed:
        return True
    import torch.distributed as dist
    return dist.get_backend() != "gloo"


def _make_update_step(sed_loss_fn, doa_loss_fn, loss_weights, l2,
                      compute_dtype, mesh=None):
    """The single-batch update: (state, x, y) -> ((sed_p, doa_p),
    (sed_loss, doa_loss)). It updates the parameters, the moments and the
    statistics in place and touches nothing on the host: the caller counts
    `state.step`. Under a mesh of several ranks x and y are this rank's
    rows, the predictions returned are too, and the losses are the global
    batch's (the module docstring)."""
    w_sed, w_doa = loss_weights

    def cast(p: torch.Tensor) -> torch.Tensor:
        if compute_dtype is not None and p.dtype == torch.float32:
            return p.to(compute_dtype)
        return p

    def update(state: TrainState, x, y):
        with collectives.data_parallel(mesh):
            return _update(state, x, y)

    def _update(state: TrainState, x, y):
        model = state.model.train()
        if compute_dtype is not None:
            x = x.to(compute_dtype)
        params = state.params
        with torch.enable_grad():
            sed_p, doa_p = torch.func.functional_call(
                model, {k: cast(p) for k, p in params.items()}, (x,))
            sed_p, doa_p = sed_p.float(), doa_p.float()
            (sed_y, doa_y), (sed_g, doa_g) = _gathered(y, (sed_p, doa_p))
            sloss = sed_loss_fn(sed_y, sed_g)
            dloss = doa_loss_fn(doa_y, doa_g)
            # this rank's share, once the gradient all-reduce sums it (a
            # shard's own kernels only: its value never leaves the step)
            penalty = l2_kernel_penalty(params, l2)
            ranks = collectives.world()
            loss = (w_sed * sloss + w_doa * dloss
                    + (penalty if ranks == 1 else penalty / ranks))
            grads = torch.autograd.grad(loss, list(params.values()),
                                        allow_unused=True)
        grads = _all_reduce_grads(_zeros_for_unused(model, params, grads))
        shards = getattr(model, "tensor_parallel", None)
        if shards:
            # AGC's unit norms over a sharded dim are summed over the model
            # group (parallel/partitioning.py)
            state.optimizer.step(list(params.values()), grads,
                                 shard_dims=[shards.get(k) for k in params])
        else:
            state.optimizer.step(list(params.values()), grads)
        return (sed_p.detach(), doa_p.detach()), (sloss.detach(),
                                                  dloss.detach())

    return update


def make_train_step(*,
                    sed_loss_fn: Callable,
                    doa_loss_fn: Callable,
                    loss_weights: Tuple[float, float] = (1.0, 1000.0),
                    l2: float = 0.0,
                    doa_threshold: float = 20.0,
                    metric_block_size: int = 10,
                    compute_dtype=None,
                    mesh=None,
                    fuse_metrics: bool = False):
    """Build a train step.

    sed_loss_fn(y, p) and doa_loss_fn(y, p) return scalars. Step signature:
    (state, metric_state, x, y) -> (state, metric_state, (sed_loss,
    doa_loss)) with y = (sed, doa); the state is updated in place and
    returned. Under a `mesh` of several ranks x and y are this rank's rows
    of the global batch, and the losses and the metric state are the
    global batch's on every rank.

    With fuse_metrics=True (seld_tpu/train/steps.py:117-123, one jit of
    the update and the metric) the metric update runs inside the step: the
    step is the k-step call's front at k = 1 with the metric inside the
    program, so on a CUDA device the whole step is one captured CUDA graph
    (train/graphs.py), replayed once a call: x, y and the metric state are
    copied into the program's buffers, the first call on a state warms up
    and captures. Its result equals the unfused step's. Under a gloo group
    it runs eagerly.
    """
    update = _make_update_step(sed_loss_fn, doa_loss_fn, loss_weights, l2,
                               compute_dtype, mesh)
    if fuse_metrics:
        staged = _staged_front(update, mesh, 1, 1, True, doa_threshold,
                               metric_block_size)

        def fused(state: TrainState, metric_state, x, y):
            state, metric_state, (sl, dl) = staged(
                state, metric_state, x[None], (y[0][None], y[1][None]))
            return state, metric_state, (sl[0], dl[0])

        return fused

    def step(state: TrainState, metric_state, x, y):
        preds, losses = update(state, x, y)
        state.step += 1
        with torch.no_grad(), collectives.data_parallel(mesh):
            metric_state = M.update_global(metric_state, y, preds,
                                           doa_threshold=doa_threshold,
                                           block_size=metric_block_size)
        return state, metric_state, losses

    return step


def _fold(a: torch.Tensor) -> torch.Tensor:
    """[k, B, ...] -> [k*B, ...]"""
    return a.reshape(a.shape[0] * a.shape[1], *a.shape[2:])


def _state_key(state: TrainState) -> tuple:
    # the program that holds these ids (its step holds the state and its
    # inputs) keeps the objects alive, so an id is not reused while its
    # entry exists
    return id(state), id(state.model), id(state.optimizer), \
        id(state.generator)


def _tensor_key(t: torch.Tensor) -> tuple:
    return tuple(t.shape), t.dtype, t.device


def _input_key(a) -> tuple:
    """A program input's part of its signature: a tensor's shape, dtype,
    device and address (the program reads it where it lay at the
    capture), any other object's id."""
    if isinstance(a, torch.Tensor):
        return _tensor_key(a), a.data_ptr()
    return id(a),


class _Slots:
    """Per-step output buffers [steps, ...] written at a device-side
    counter `i` ([1] int64) by index_copy_: the graph writes step i's
    values where the host reads them after the last replay."""

    def __init__(self, device, steps: int):
        self.counter = torch.zeros(1, dtype=torch.int64, device=device)
        self.steps = steps
        self.bufs: Dict[str, torch.Tensor] = {}

    def put(self, name: str, value: torch.Tensor) -> None:
        self.bufs[name].index_copy_(0, self.counter, value.unsqueeze(0))

    def alloc(self, name: str, shape, dtype) -> None:
        self.bufs[name] = torch.empty((self.steps, *shape), dtype=dtype,
                                      device=self.counter.device)

    def row(self, a: torch.Tensor) -> torch.Tensor:
        """a[i] of a [steps, ...] tensor, i the device-side counter."""
        return a.index_select(0, self.counter).squeeze(0)


def _program(update, mesh, batch, *, fuse_metrics: bool,
             doa_threshold: float, metric_block_size: int, unroll: int = 1):
    """The one captured training program, which `make_train_epoch`,
    `make_train_multistep` and `make_train_step(fuse_metrics=True)` front.

    Returns run(state, metric_state, inputs, steps, labels, generators) ->
    (state, metric_state, (sed_losses [steps], doa_losses [steps])): step
    i's batch is `batch(row, *inputs)` -> (x, (sed, doa)), row(a) being
    a[i] at the device-side counter i. With fuse_metrics the metric state
    is updated inside every step; without, every step's labels (`labels`:
    the (shape, dtype) of a step's sed and doa) and predictions go to
    slots and ONE metric update folds them in after the last step.
    `generators`: the inputs the batch draws from, registered with the
    graph beside the state's. The steps run as `StepLoop`s of `unroll`
    steps (train/graphs.py). The program is built once per signature (the
    state, `steps`, the metric state's names, each input's `_input_key`);
    another replaces it, and `run.release()` drops it.
    """
    capture = _uses_graphs(mesh)
    live = {}      # the one program of the last signature

    def build(state, metric_state, inputs, steps, labels, generators):
        device = inputs[0].device
        slots = _Slots(device, steps)
        slots.alloc("losses", (2,), torch.float32)
        if fuse_metrics:
            metric = {k: torch.empty_like(v) for k, v in metric_state.items()}
        else:
            metric = None
            for name, (shape, dtype) in zip(("sed", "doa"), labels):
                slots.alloc(name, shape, dtype)
                slots.alloc(f"{name}_p", shape, torch.float32)

        def one_step():
            x, y = batch(slots.row, *inputs)
            preds, (sl, dl) = update(state, x, y)
            with torch.no_grad(), collectives.data_parallel(mesh):
                if fuse_metrics:
                    new = M.update_global(metric, y, preds,
                                          doa_threshold=doa_threshold,
                                          block_size=metric_block_size)
                    for name, t in metric.items():
                        t.copy_(new[name])
                else:
                    slots.put("sed", y[0])
                    slots.put("doa", y[1])
                    slots.put("sed_p", preds[0])
                    slots.put("doa_p", preds[1])
                slots.put("losses", torch.stack([sl, dl]))
                slots.counter.add_(1)

        loop = StepLoop(one_step, [state.generator, *generators], device,
                        unroll, capture=capture)
        return slots, loop, metric

    def run(state: TrainState, metric_state, inputs, steps: int,
            labels=None, generators=()):
        key = (_state_key(state), steps, tuple(sorted(metric_state)),
               *map(_input_key, inputs))
        if key not in live:
            live.clear()
            live[key] = build(state, metric_state, inputs, steps, labels,
                              generators)
        slots, loop, metric = live[key]
        with torch.no_grad():
            slots.counter.zero_()
            if metric is not None:
                for name, t in metric.items():
                    t.copy_(metric_state[name])
        loop.run(steps)
        state.step += steps
        b = slots.bufs
        with torch.no_grad(), collectives.data_parallel(mesh):
            if metric is not None:
                metric_state = {k: v.clone() for k, v in metric.items()}
            else:
                metric_state = M.update_global(
                    metric_state, (_fold(b["sed"]), _fold(b["doa"])),
                    (_fold(b["sed_p"]), _fold(b["doa_p"])),
                    doa_threshold=doa_threshold,
                    block_size=metric_block_size)
            losses = b["losses"].clone()
        return state, metric_state, (losses[:, 0], losses[:, 1])

    run.release = live.clear
    return run


def _staged_front(update, mesh, steps: int, unroll: int, fuse_metrics: bool,
                  doa_threshold: float, metric_block_size: int):
    """The program over `steps` = k batches a call, stacked: step(state,
    metric_state, xs [k, B, ...], (sed [k, B, ...], doa [k, B, ...])) ->
    (state, metric_state, (sed_losses [k], doa_losses [k])). The batches
    are copied into staging buffers kept for their signature, and step i
    reads row i of each (at k = 1 the one row, as a view)."""
    def batch(row, xs, sed, doa):
        if steps == 1:
            return xs[0], (sed[0], doa[0])
        return row(xs), (row(sed), row(doa))

    program = _program(update, mesh, batch, fuse_metrics=fuse_metrics,
                       doa_threshold=doa_threshold,
                       metric_block_size=metric_block_size, unroll=unroll)
    staged = {}    # the staging buffers of the last signature

    def step(state: TrainState, metric_state, xs, ys):
        arrays = (xs, *ys)
        if any(a.shape[0] != steps for a in arrays):
            got = ", ".join(str(tuple(a.shape)) for a in arrays)
            raise ValueError(f"batches must be stacked [{steps}, B, ...]; "
                             f"got {got}")
        key = tuple(map(_tensor_key, arrays))
        if key not in staged:
            # the program over the old buffers goes first: one set is held
            program.release()
            staged.clear()
            staged[key] = tuple(torch.empty(a.shape, dtype=a.dtype,
                                            device=a.device) for a in arrays)
        bufs = staged[key]
        with torch.no_grad():
            for buf, a in zip(bufs, arrays):
                buf.copy_(a)
        return program(state, metric_state, bufs, steps,
                       [(a.shape[1:], a.dtype) for a in ys])

    return step


def make_train_multistep(*,
                         steps_per_call: int,
                         sed_loss_fn: Callable,
                         doa_loss_fn: Callable,
                         loss_weights: Tuple[float, float] = (1.0, 1000.0),
                         l2: float = 0.0,
                         doa_threshold: float = 20.0,
                         metric_block_size: int = 10,
                         compute_dtype=None,
                         donate: bool = True,
                         unroll: int = 1,
                         mesh=None):
    """k optimizer updates a call (seld_tpu/train/steps.py:141-200).

    Batches arrive stacked: xs [k, B, ...], ys = (sed [k, B, ...], doa
    [k, B, ...]). The k updates run back to back; then ONE metric update
    folds the k stacked predictions in ([k*B, ...]), as the JAX package
    does. Semantics equal k calls of `make_train_step`: one update a
    batch, the dropout masks drawn from the state's generator in step
    order, so the generator ends where k single steps leave it.

    It is a front of the epoch's program (`make_train_epoch` with
    fuse_metrics=False and no augment): the batches are copied once a call
    into staging buffers, and each step reads its batch there at a
    device-side counter. On a CUDA device the steps run as a captured CUDA
    graph of `unroll` steps, replayed over the k (train/graphs.py); the
    first call on a state warms up (its first `unroll` steps run eagerly)
    and captures. On the CPU the same step body runs in a plain loop.
    `unroll` does not change the result. `donate` is accepted for the JAX
    signature: the port always updates the state in place. `mesh`: as
    `make_train_step`; under a gloo group the steps run in the plain loop
    on any device.

    Returns step(state, metric_state, xs, ys) -> (state, metric_state,
    (sed_losses [k], doa_losses [k])).
    """
    if steps_per_call < 1:
        raise ValueError("steps_per_call must be >= 1")
    if not 1 <= int(unroll) <= steps_per_call:
        raise ValueError(f"unroll={unroll!r} must be in [1, steps_per_call]")
    update = _make_update_step(sed_loss_fn, doa_loss_fn, loss_weights, l2,
                               compute_dtype, mesh)
    return _staged_front(update, mesh, int(steps_per_call), int(unroll),
                         False, doa_threshold, metric_block_size)


def make_train_epoch(*,
                     sed_loss_fn: Callable,
                     doa_loss_fn: Callable,
                     n_classes: int,
                     mesh=None,
                     axis: str = "data",
                     loss_weights: Tuple[float, float] = (1.0, 1000.0),
                     l2: float = 0.0,
                     doa_threshold: float = 20.0,
                     metric_block_size: int = 10,
                     compute_dtype=None,
                     donate: bool = True,
                     augment_fn: Callable = None,
                     fuse_metrics: bool = False):
    """One train epoch over a card-resident split a call
    (seld_tpu/train/steps.py:203-305).

    Companion to `data.device_dataset.DeviceDataset`: the windowed split
    (x_all [N, ...], y_all [N, T, 4C], sed and doa labels side by side)
    and the epoch's index matrix (idx_all [steps, B] int32) already lie on
    the card. Each step of the program (`_program`) reads its row of
    idx_all at a device-side counter, gathers its batch with
    `gather_batch` (the gather_rows kernel), applies `augment_fn(generator,
    x, y)`, splits the labels at `n_classes` and runs the update. On a
    CUDA device that step is a captured CUDA graph, replayed `steps` times
    (train/graphs.py): the host's work a step is one replay. The graph is
    captured once per signature (shapes, dtypes, the state, the generator
    and the addresses of x_all, y_all and idx_all), so an epoch over the
    same buffers with new ids in idx_all replays it again; the first step
    of the first epoch is its warm-up and runs eagerly. On the CPU the
    same step body runs in a plain loop.

    The program holds the split it was captured over (its closure refers
    to x_all, y_all and idx_all) until another signature replaces it or
    `epoch.release()` drops it. A new split (a TDM rebuild, restaged) lies
    at other addresses and is captured anew; new data written into the
    same buffers is read by the next replay. The trainer releases the
    program before a rebuilt split is staged, so one split is on the card
    at a time.

    The augments draw from the `aug_generator` the call is handed, in step
    order: the augment stream is the trainer's eager loop's for the same
    generator. It cannot equal the JAX package's, which splits a key per
    step inside its scan from `aug_rng`.

    As in JAX, with fuse_metrics=False the (post-augment) labels and the
    predictions of every step are stacked and ONE metric update folds them
    in after the last step; with fuse_metrics=True the metric state is
    updated inside every step. `axis` and `donate` are accepted for the
    JAX signature (the port updates the state in place).

    Under a `mesh` of several ranks (the JAX package's shard_map gather),
    x_all and y_all are this rank's shard of the split and idx_all holds
    local row numbers [steps, B / N] (`DeviceDataset(mesh=...)`): each rank
    gathers its rows from its own shard, and the update and the metric are
    `make_train_step`'s under the mesh. With NCCL the step's all-reduces
    are captured in its CUDA graph (the warm-up step has run them once
    before the capture); under gloo the epoch runs the plain loop.

    Returns epoch(state, metric_state, x_all, y_all, idx_all,
    aug_generator) -> (state, metric_state, (sed_losses [steps],
    doa_losses [steps])).
    """
    update = _make_update_step(sed_loss_fn, doa_loss_fn, loss_weights, l2,
                               compute_dtype, mesh)
    c = n_classes

    def batch(row, x_all, y_all, idx_all, aug_generator):
        xb, yb = gather_batch((x_all, y_all), row(idx_all))
        if augment_fn is not None:
            with collectives.data_parallel(mesh):
                xb, yb = augment_fn(aug_generator, xb, yb)
        return xb, (yb[..., :c], yb[..., c:])

    program = _program(update, mesh, batch, fuse_metrics=fuse_metrics,
                       doa_threshold=doa_threshold,
                       metric_block_size=metric_block_size)

    def epoch(state: TrainState, metric_state, x_all, y_all, idx_all,
              aug_generator):
        with span("seld.train.epoch"):
            if idx_all.dim() != 2 or y_all.shape[-1] <= c:
                raise ValueError(f"idx_all must be [steps, B] and y_all "
                                 f"[N, T, >{c}]; got {tuple(idx_all.shape)}, "
                                 f"{tuple(y_all.shape)}")
            steps, rows = idx_all.shape
            lead = (rows, *y_all.shape[1:-1])
            labels = [((*lead, c), y_all.dtype),
                      ((*lead, y_all.shape[-1] - c), y_all.dtype)]
            return program(state, metric_state,
                           (x_all, y_all, idx_all, aug_generator), steps,
                           labels, (aug_generator,) if augment_fn else ())

    epoch.release = program.release
    return epoch


def make_eval_step(*,
                   sed_loss_fn: Callable,
                   doa_loss_fn: Callable,
                   doa_threshold: float = 20.0,
                   metric_block_size: int = 10,
                   return_preds: bool = False,
                   compute_dtype=None,
                   mesh=None):
    """Build an eval step: (state, metric_state, x, y[, n_valid]) ->
    (metric_state, (sed_loss, doa_loss)[, preds]).

    The model runs in eval mode on its f32 parameters; with a
    `compute_dtype`, x is first rounded to it, and the forward then runs in
    f32, as the JAX package's eval step promotes a bf16 input against f32
    parameters. With `n_valid`, predictions and labels are cut to the first
    n_valid rows before the losses and the metric. Under a `mesh` of
    several ranks x and y are this rank's rows of a global batch whose
    first n_valid rows count: the losses (and `preds`) are the global
    batch's, and the metric adds the all-reduced sums of this rank's valid
    rows.
    """
    def step(state: TrainState, metric_state, x, y, n_valid=None):
        with torch.no_grad(), collectives.data_parallel(mesh):
            return _step(state, metric_state, x, y, n_valid)

    def _step(state, metric_state, x, y, n_valid):
        if compute_dtype is not None:
            x = x.to(compute_dtype)
        sed_p, doa_p = state.model.eval()(x.float())
        preds = (sed_p.float(), doa_p.float())
        if collectives.active() is None or n_valid is None:
            mine = n_valid
            (sed_y, doa_y), (sed_p, doa_p) = _gathered(y, preds)
            sed_p, doa_p = sed_p[:n_valid], doa_p[:n_valid]
            sed_y, doa_y = sed_y[:n_valid], doa_y[:n_valid]
        else:
            # this rank's rows lie at its data index in the padded global
            # batch; the gathered rows are kept where they are valid (ranks
            # that replicate hold the same rows)
            rows = x.shape[0]
            mine = min(max(n_valid - mesh.data_index * rows, 0), rows)
            valid = (torch.arange(rows, device=x.device) < mine).float()
            valid = valid[:, None, None].expand(*y[0].shape[:2], 1)
            (sed_y, doa_y, keep), (sed_p, doa_p) = _gathered(
                (*y, valid), preds)
            keep = keep[:, 0, 0] > 0
            sed_p, doa_p, sed_y, doa_y = (a[keep] for a in
                                          (sed_p, doa_p, sed_y, doa_y))
        metric_state = M.update_global(
            metric_state, tuple(a[:mine] for a in y),
            tuple(a[:mine] for a in preds),
            doa_threshold=doa_threshold, block_size=metric_block_size)
        sloss = sed_loss_fn(sed_y, sed_p)
        dloss = doa_loss_fn(doa_y, doa_p)
        if return_preds:
            return metric_state, (sloss, dloss), (sed_p, doa_p)
        return metric_state, (sloss, dloss)

    return step
