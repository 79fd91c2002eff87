"""SS5 (conv_temporal), the DCASE2021 Task 3 submission of the reference
repository, as plain PyTorch over a dict of f32 leaves.

Stem: conv 7x7 / 32 + BatchNorm + ReLU + max pool `first_pool_size`.
BLOCK0, mother_stage as SS5 wires it (no first layer; the second a conv
+ BatchNorm with a projected skip from the block's input, ReLU; the
output the concatenation of the block's input, 1x1-projected where the
stage strides, and the second layer's). BLOCK1, simple_dense_stage: a
1x1 conv over the flattened frequency axis, linear (the reference's stage
reads `activation`, which SS5 does not set, and not `dense_activation`).
BLOCK2 and the SED head, conformers; the DOA head, stacked biGRUs merged
by product; Dense + sigmoid / tanh outputs.

`stage`: "trunk" (stem, BLOCK0, BLOCK1: time-local, run once a clip on
the fast path), "head" (the rest, on trunk frames) or "full".
"""
from __future__ import annotations

import torch

from seld_bench.reference.common import (batch_norm, conformer, conv, dense,
                                         flatten_freq, gru_bidirectional,
                                         max_pool)


def _mother_stage(x, P, name, args, train):
    if (args["filters0"], args["filters2"], list(args["connect1"]),
            list(args["connect2"])) != (0, 0, [1, 0], [1, 0, 1]) or \
            args.get("squeeze_ratio", 0) or args.get("bn_pair_batch", False):
        raise ValueError("the reference mother stage is SS5's wiring only")
    strides = tuple(args.get("strides", (1, 1)))
    for i in range(args["depth"]):
        s = strides if i == 0 else (1, 1)
        blk = f"{name}.MotherBlock_{i}"
        main = batch_norm(conv(x, P[f"{blk}.Conv_0.kernel"],
                               P[f"{blk}.Conv_0.bias"], s),
                          P, f"{blk}.BatchNorm_0", train)
        skip = x
        if skip.shape[1:] != main.shape[1:]:
            skip = batch_norm(conv(x, P[f"{blk}.Conv_1.kernel"],
                                   P[f"{blk}.Conv_1.bias"], s),
                              P, f"{blk}.BatchNorm_1", train)
        second = torch.relu(main + skip)
        first = x
        if s != (1, 1):
            first = conv(x, P[f"{blk}.Conv_2.kernel"],
                         P[f"{blk}.Conv_2.bias"], s)
        x = torch.cat([first, second], dim=-1)
    return x


def forward(P, x, cfg, train: bool, drop, stage: str = "full"):
    """x [B, T, F, 7] -> (sed [B, T', C], doa [B, T', 3C]); "trunk"
    returns the trunk's frames [B, T', D]."""
    if stage != "head":
        k = P["Conv2DBN_0.Conv_0.kernel"]
        x = conv(x, k, P["Conv2DBN_0.Conv_0.bias"])
        x = torch.relu(batch_norm(x, P, "Conv2DBN_0.BatchNorm_0", train))
        x = max_pool(x, cfg["first_pool_size"])
        x = _mother_stage(x, P, "MotherStage_0", cfg["BLOCK0_ARGS"], train)
        x = flatten_freq(x)
        for i in range(cfg["BLOCK1_ARGS"]["depth"]):
            name = f"SimpleDenseBlock_0.Conv_{i}"
            x = drop(conv(x, P[f"{name}.kernel"], P[f"{name}.bias"]),
                     cfg["BLOCK1_ARGS"].get("dropout_rate", 0.0))
        if stage == "trunk":
            return x
    x = conformer(x, P, "ConformerEncoderBlock_0", cfg["BLOCK2_ARGS"], drop,
                  train)
    sed = conformer(x, P, "SELDHeads_0.ConformerEncoderBlock_0",
                    cfg["SED_ARGS"], drop, train)
    sed = torch.sigmoid(dense(sed, P, "SELDHeads_0.sed_out"))
    doa = x
    for i in range(cfg["DOA_ARGS"]["depth"]):
        doa = gru_bidirectional(
            doa, P, f"SELDHeads_0.BidirectionalGRUBlock_0.GRU_{i}")
    doa = torch.tanh(dense(doa, P, "SELDHeads_0.doa_out"))
    return sed, doa


def gru_layers(cfg, frames: int):
    """(units, steps) of each biGRU layer the model runs on `frames` input
    frames: time is pooled by the stem's pool and the mother stage's
    stride, and by nothing after them."""
    steps = frames // cfg["first_pool_size"][0] \
        // cfg["BLOCK0_ARGS"].get("strides", (1, 1))[0]
    return [(cfg["DOA_ARGS"]["units"], steps)] * cfg["DOA_ARGS"]["depth"]
