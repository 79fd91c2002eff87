"""The DCASE baseline CRNN (SELDnet) as plain PyTorch over a dict of f32
leaves: [conv 3x3 + BatchNorm + ReLU + max pool] per FIRST_ARGS filter,
the flattened frequency axis through stacked biGRUs merged by product,
then per head a linear 1x1 conv and Dense + sigmoid (SED) / tanh (DOA)."""
from __future__ import annotations

import torch

from seld_bench.reference.common import (batch_norm, conv, dense,
                                         flatten_freq, gru_bidirectional,
                                         max_pool)


def forward(P, x, cfg, train: bool, drop, stage: str = "full"):
    if stage != "full":
        raise ValueError("SELDnet has no trunk / head split")
    first = cfg["FIRST_ARGS"]
    for i, pool in enumerate(first["pool_size"]):
        name = f"SimpleConvBlock_0.Conv2DBN_{i}"
        x = conv(x, P[f"{name}.Conv_0.kernel"], P[f"{name}.Conv_0.bias"])
        x = torch.relu(batch_norm(x, P, f"{name}.BatchNorm_0", train))
        x = drop(max_pool(x, pool), first.get("dropout_rate", 0.0))
    x = flatten_freq(x)
    for i in range(len(cfg["SECOND_ARGS"]["units"])):
        x = gru_bidirectional(x, P, f"BidirectionalGRUBlock_0.GRU_{i}")
    outs = []
    for j, (head, act) in enumerate((("sed_out", torch.sigmoid),
                                     ("doa_out", torch.tanh))):
        h = x
        for i in range(len(cfg["SED_ARGS" if j == 0 else "DOA_ARGS"]
                           ["units"])):
            name = f"SELDHeads_0.SimpleDenseBlock_{j}.Conv_{i}"
            h = conv(h, P[f"{name}.kernel"], P[f"{name}.bias"])
        outs.append(act(dense(h, P, f"SELDHeads_0.{head}")))
    return tuple(outs)


def gru_layers(cfg, frames: int):
    """(units, steps) of each biGRU layer on `frames` input frames: time is
    pooled by the conv blocks' pools only."""
    for pool in cfg["FIRST_ARGS"]["pool_size"]:
        frames //= pool[0]
    return [(u, frames) for u in cfg["SECOND_ARGS"]["units"]]
