"""Layers, losses, optimizer, front-end and sliding windows, in plain
PyTorch and float32 (TF32 off on the card: `exact_f32`).

Departures from the published description, each also the program's:
a conformer's dropout masks are drawn with `torch.rand` from one generator
in call order (`Dropout`), so a reference seeded like the program's
training state draws the same masks; BatchNorm and LayerNorm take Keras'
epsilon 1e-3; the DCASE class weights are mean(counts) / counts.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from seld_bench.yardstick.work import hann, mel_filterbank

# per-class sample counts of the DCASE2021 train split
DCASE2021_TRAIN_SAMPLES = np.asarray(
    [58193, 32794, 29801, 21478, 14822, 9174, 66527, 6740, 9342, 6498,
     22218, 49758], dtype=np.float32)


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """Matrix products and convolutions in float32 (tf32=False) or TF32,
    restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def exact_f32():
    return matmul_precision(False)


_operand = [lambda t: t]     # rounds each operand of a product


def operand(t: torch.Tensor) -> torch.Tensor:
    return _operand[0](t)


@contextlib.contextmanager
def fp8_products():
    """Every convolution's and matrix product's operands rounded to fp8
    e4m3 (`fp8`), as an fp8 GEMM takes them; sums and the rest in f32."""
    _operand[0] = fp8
    try:
        yield
    finally:
        _operand[0] = lambda t: t


class Dropout:
    """Inverted dropout drawing `torch.rand` masks from `generator` in call
    order; the identity with no generator (eval)."""

    def __init__(self, generator: Optional[torch.Generator]):
        self.generator = generator

    def __call__(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        if self.generator is None or rate == 0.0:
            return x
        keep = 1.0 - rate
        u = torch.rand(x.shape, generator=self.generator, device=x.device,
                       dtype=torch.float32)
        return torch.where(u < keep, x / keep, torch.zeros((), dtype=x.dtype,
                                                           device=x.device))


def same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """"SAME" padding: out = ceil(size / s), the smaller half first."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def conv(x: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor],
         strides: Sequence[int] = None, groups: int = 1) -> torch.Tensor:
    """Channels-last 1-D or 2-D convolution with "SAME" padding; kernel
    [*k, I / groups, O]."""
    nsp = kernel.dim() - 2
    strides = tuple(strides) if strides else (1,) * nsp
    x = x.movedim(-1, 1)
    pads = []
    for i in reversed(range(nsp)):
        pads += same_pads(x.shape[2 + i], kernel.shape[i], strides[i])
    x = F.pad(operand(x), pads)
    w = operand(kernel).permute(nsp + 1, nsp, *range(nsp))
    fn = F.conv2d if nsp == 2 else F.conv1d
    return fn(x, w, bias, stride=strides, groups=groups).movedim(1, -1)


def batch_norm(x: torch.Tensor, P: Dict, name: str, train: bool,
               eps: float = 1e-3) -> torch.Tensor:
    """Over the last axis: the batch's biased statistics in training, the
    running ones (`<name>.mean`, `<name>.var`) in eval."""
    if train:
        dims = tuple(range(x.dim() - 1))
        mean = x.mean(dims)
        var = (x - mean).square().mean(dims)
    else:
        mean, var = P[f"{name}.mean"], P[f"{name}.var"]
    return ((x - mean) / torch.sqrt(var + eps) * P[f"{name}.scale"]
            + P[f"{name}.bias"])


def layer_norm(x: torch.Tensor, P: Dict, name: str,
               eps: float = 1e-3) -> torch.Tensor:
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return ((x - mean) / torch.sqrt(var + eps) * P[f"{name}.scale"]
            + P[f"{name}.bias"])


def dense(x: torch.Tensor, P: Dict, name: str) -> torch.Tensor:
    return operand(x) @ operand(P[f"{name}.kernel"]) + P[f"{name}.bias"]


def max_pool(x: torch.Tensor, window: Sequence[int]) -> torch.Tensor:
    """Non-overlapping VALID max pool of [B, T, F, C]."""
    b, t, f, c = x.shape
    pt, pf = window
    x = x[:, :t // pt * pt, :f // pf * pf]
    return x.reshape(b, t // pt, pt, f // pf, pf, c).amax(dim=(2, 4))


def flatten_freq(x: torch.Tensor) -> torch.Tensor:
    """[B, T, F, C] -> [B, T, F C]."""
    return x.reshape(*x.shape[:2], -1) if x.dim() == 4 else x


def attention(x: torch.Tensor, P: Dict, name: str, drop: Dropout,
              rate: float) -> torch.Tensor:
    """Multi-head self-attention with per-head kernels [H, I, S], the
    query scaled by 1 / sqrt(S), dropout on the attention weights."""
    o = operand
    x = o(x)
    q = torch.einsum("bti,his->bhts", x, o(P[f"{name}.query_kernel"])) \
        + P[f"{name}.q_bias"][:, None]
    k = torch.einsum("bti,his->bhts", x, o(P[f"{name}.key_kernel"])) \
        + P[f"{name}.k_bias"][:, None]
    v = torch.einsum("bti,his->bhts", x, o(P[f"{name}.value_kernel"])) \
        + P[f"{name}.v_bias"][:, None]
    q = q / math.sqrt(q.shape[-1])
    w = torch.softmax(o(q) @ o(k).transpose(-1, -2), dim=-1)
    w = drop(w, rate)
    out = torch.einsum("bhts,hso->bto", o(o(w) @ o(v)),
                       o(P[f"{name}.projection_kernel"]))
    return out + P[f"{name}.projection_bias"]


def conformer(x: torch.Tensor, P: Dict, name: str, args: Dict,
              drop: Dropout, train: bool) -> torch.Tensor:
    """`args["depth"]` conformer iterations (half FFN, self-attention,
    GLU + depthwise conv + BatchNorm + swish, half FFN, LayerNorm), without
    positional encoding. Iteration k's leaves: LayerNorm_{5k..5k+4},
    Dense_{4k..4k+3}, MultiHeadAttention_k, Conv_{3k..3k+2}, BatchNorm_k."""
    if args.get("pos_encoding", "basic") is not None or args.get(
            "scan_depth", False):
        raise ValueError("the reference conformer takes no positional "
                         "encoding and no scanned depth")
    rate = args.get("dropout_rate", 0.1)
    factor = args.get("ffn_factor", 0.5)
    act = F.silu

    def ffn(h, ln, d1, d2):
        h = layer_norm(h, P, f"{name}.LayerNorm_{ln}")
        h = drop(act(dense(h, P, f"{name}.Dense_{d1}")), rate)
        return drop(dense(h, P, f"{name}.Dense_{d2}"), rate)

    x = flatten_freq(x)
    for k in range(args["depth"]):
        ln, dn, cv = 5 * k, 4 * k, 3 * k
        x = x + factor * ffn(x, ln, dn, dn + 1)
        a = attention(layer_norm(x, P, f"{name}.LayerNorm_{ln + 1}"), P,
                      f"{name}.MultiHeadAttention_{k}", drop, rate)
        x = drop(a, rate) + x
        c = layer_norm(x, P, f"{name}.LayerNorm_{ln + 2}")
        c = conv(c, P[f"{name}.Conv_{cv}.kernel"], P[f"{name}.Conv_{cv}.bias"])
        c1, c2 = c.chunk(2, dim=-1)
        c = c1 * torch.sigmoid(c2)
        dw = P[f"{name}.Conv_{cv + 1}.kernel"]
        c = conv(c, dw, P[f"{name}.Conv_{cv + 1}.bias"], groups=dw.shape[-1])
        c = act(batch_norm(c, P, f"{name}.BatchNorm_{k}", train))
        c = drop(conv(c, P[f"{name}.Conv_{cv + 2}.kernel"],
                      P[f"{name}.Conv_{cv + 2}.bias"]), rate)
        c = c + x
        f = ffn(c, ln + 3, dn + 2, dn + 3)
        x = layer_norm(x + factor * f, P, f"{name}.LayerNorm_{ln + 4}")
    return x


def gru_bidirectional(x: torch.Tensor, P: Dict, name: str) -> torch.Tensor:
    """Keras GRU (reset after, gates z | r | h) in both directions, merged
    by product. kernel [2, I, 3U], recurrent_kernel [2, U, 3U], bias
    [2, 2, 3U] (input bias, recurrent bias)."""
    kernel, rk = P[f"{name}.kernel"], P[f"{name}.recurrent_kernel"]
    bias = P[f"{name}.bias"]
    b, t, _ = x.shape
    u = rk.shape[1]
    outs = []
    for d in range(2):
        xp = operand(x) @ operand(kernel[d]) + bias[d, 0]
        h = x.new_zeros((b, u))
        states = [None] * t
        rkd = operand(rk[d])
        for i in (range(t) if d == 0 else range(t - 1, -1, -1)):
            hp = operand(h) @ rkd + bias[d, 1]
            z = torch.sigmoid(xp[:, i, :u] + hp[:, :u])
            r = torch.sigmoid(xp[:, i, u:2 * u] + hp[:, u:2 * u])
            cand = torch.tanh(xp[:, i, 2 * u:] + r * hp[:, 2 * u:])
            h = z * h + (1.0 - z) * cand
            states[i] = h
        outs.append(torch.stack(states, dim=1))
    return outs[0] * outs[1]


# ------------------------------------------------------------- training
def class_weights(device) -> torch.Tensor:
    s = torch.as_tensor(DCASE2021_TRAIN_SAMPLES, device=device)
    return s.mean() / s


def sed_loss(y: torch.Tensor, p: torch.Tensor, cw: torch.Tensor):
    """Class-weighted binary cross-entropy, probabilities clipped at 1e-7."""
    p = p.clamp(1e-7, 1.0 - 1e-7)
    bce = -(y * torch.log(p) + (1.0 - y) * torch.log(1.0 - p))
    return (bce * cw).mean()


def doa_loss(y: torch.Tensor, p: torch.Tensor, cw: torch.Tensor):
    """Class-weighted MSE over the DOA components of active classes; a
    class is active where round(x^2 + y^2 + z^2) of its label is 1."""
    c = cw.shape[-1]
    active = torch.round(y.reshape(*y.shape[:-1], 3, c).square().sum(-2))
    mask = (active * cw).repeat(*([1] * (y.dim() - 1)), 3)
    return ((y - p).square() * mask).sum() / mask.sum()


def l2_penalty(P: Dict, l2: float) -> torch.Tensor:
    """l2 x the summed squares of every kernel leaf of a layer with a kernel
    regularizer: all but the recurrent layers'."""
    total = 0.0
    for name, w in P.items():
        parts = name.split(".")
        if parts[-1] == "recurrent_kernel" or any(
                p.startswith(("GRU_", "LSTM_")) for p in parts):
            continue
        if "kernel" in parts[-1]:
            total = total + w.square().sum()
    return l2 * total


def unit_norm(x: torch.Tensor) -> torch.Tensor:
    """AGC's unit-wise norm: whole for scalars and vectors, over axis 0 for
    2-D and 3-D leaves, over the first three axes for 4-D ones."""
    if x.dim() <= 1:
        return x.square().sum().sqrt()
    dims = (0,) if x.dim() in (2, 3) else (0, 1, 2)
    return x.square().sum(dim=dims, keepdim=True).sqrt()


def agc(p: torch.Tensor, g: torch.Tensor, clip: float) -> torch.Tensor:
    """Adaptive gradient clipping (NFNets) with the unit-wise norms above."""
    most = unit_norm(p).clamp_min(1e-3) * clip
    gn = unit_norm(g)
    return torch.where(gn < most, g, g * (most / gn.clamp_min(1e-6)))


class AdaBelief:
    """AdaBelief (eps 1e-7 outside the square root) after AGC, on a list
    of f32 leaves updated in place."""

    def __init__(self, params: List[torch.Tensor], lr: float, clip: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-7):
        self.lr, self.clip, self.b1, self.b2, self.eps = lr, clip, b1, b2, eps
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self, params, grads) -> List[torch.Tensor]:
        """Update `params`; returns the clipped gradients it used."""
        self.t += 1
        b1, b2 = self.b1, self.b2
        corr = math.sqrt(1 - b2 ** self.t) / (1 - b1 ** self.t)
        used = []
        for p, g, m, v in zip(params, grads, self.m, self.v):
            g = agc(p, g, self.clip)
            used.append(g)
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * (g - m).square())
            p.sub_(self.lr * corr * m / (v.sqrt() + self.eps))
        return used


def fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 with a per-tensor scale (amax to 448), as
    float32; the gradient passes straight through."""
    scale = t.detach().abs().amax().clamp_min(1e-12) / 448.0
    q = (t.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return t + (q - t.detach())


# ------------------------------------------------------------- front-end
def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    lead = x.shape[:-1]
    return F.pad(x.reshape(-1, 1, x.shape[-1]), (pad, pad),
                 mode="reflect").reshape(*lead, x.shape[-1] + 2 * pad)


def foa_features(wav: torch.Tensor, n_fft: int = 1024, win: int = 960,
                 hop: int = 480, n_mels: int = 64, sample_rate: int = 24000,
                 top_db: float = 80.0) -> torch.Tensor:
    """[n, 4, L] FOA wavs (W, Y, Z, X) -> [n, 1 + L // hop, n_mels, 7]:
    4 log-mel planes in dB (top-dB floor per clip) and 3 mel-projected
    unit intensity vectors, through torch.fft."""
    padded = reflect_pad(wav.float(), n_fft // 2)
    window = np.zeros(n_fft, np.float32)
    left = (n_fft - win) // 2
    window[left:left + win] = hann(win)
    frames = padded.unfold(-1, n_fft, hop) * torch.as_tensor(
        window, device=wav.device)
    spec = torch.fft.rfft(frames)                       # [n, 4, T, bins]
    fb = torch.as_tensor(mel_filterbank(n_fft // 2 + 1, n_mels, sample_rate),
                         device=wav.device)
    mel = (spec.real.square() + spec.imag.square()) @ fb
    w = spec[:, 0]
    iv = [(w.conj() * spec[:, ch]).real for ch in (3, 1, 2)]   # x, y, z
    norm = torch.sqrt(sum(c.square() for c in iv)).clamp_min(1e-8)
    iv = torch.stack([c / norm for c in iv], dim=1) @ fb
    db = 10.0 * torch.log10(mel.clamp_min(1e-10))
    floor = db.flatten(1).amax(dim=1)[:, None, None, None] - top_db
    db = torch.maximum(db, floor)
    return torch.cat([db, iv], dim=1).permute(0, 2, 3, 1)


# ----------------------------------------------------- sliding windows
def overlap_average(frames: torch.Tensor) -> torch.Tensor:
    """[n_win, L, C] outputs of windows one frame apart -> [n_win - 1 + L,
    C], each frame the mean of the windows that cover it."""
    n, length, c = frames.shape
    out = frames.new_zeros((n - 1 + length, c))
    count = frames.new_zeros((n - 1 + length, 1))
    for j in range(length):
        out[j:j + n] += frames[:, j]
        count[j:j + n] += 1
    return out / count


def clip_outputs(forward, feats: torch.Tensor, win: int, step: int,
                 block: int, trunk=None, time_down: int = 5):
    """One clip's (sed, doa) [T_f / time_down, C]: the windows of `win`
    frames every `step` through `forward` in blocks of `block` windows and
    averaged where they overlap. With `trunk`, `trunk` runs once over the
    whole clip and `forward` over windows of its output (time_down frames
    to one)."""
    src = feats if trunk is None else trunk(feats[None])[0]
    if trunk is not None:
        win, step = win // time_down, step // time_down
    n_win = (src.shape[0] - win) // step + 1
    seds, doas = [], []
    for lo in range(0, n_win, block):
        starts = torch.arange(lo, min(lo + block, n_win),
                              device=src.device) * step
        idx = starts[:, None] + torch.arange(win, device=src.device)
        sed, doa = forward(src[idx])
        seds.append(sed)
        doas.append(doa)
    sed, doa = torch.cat(seds), torch.cat(doas)
    # the label frames of consecutive windows lie step / (win / label) apart
    label_step = step * sed.shape[1] // win
    if label_step != 1:
        raise ValueError("windows must start one label frame apart")
    return overlap_average(sed), overlap_average(doa)
