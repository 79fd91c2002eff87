"""DCASE output-format CSV I/O and segment utilities (host-side, numpy only).

Parity targets (reference file:line):
  - write_answer                              utils.py:249-268
  - load_output_format_file                   utils.py:271-291
  - segment_labels                            utils.py:293-324
  - convert_output_format_cartesian_to_polar  utils.py:327-340
  - convert_output_format_polar_to_cartesian  utils.py:352-367
  - regression_label_format_to_output_format  metrics.py:193-214

The reference implements `write_answer` with TF ops and a Python loop over
`tf.where` hits; here everything is vectorized numpy. The CSV format is
`frame,class,0,x,y,z` with frame/class int-cast (the quantization the official
scorer round-trips through — behavior preserved exactly).
"""
from __future__ import annotations

import os
from typing import Dict, List

import numpy as np


def write_answer(output_dir: str, filename: str, preds, direction) -> None:
    """Write DCASE cartesian output CSV.

    preds:     [n_frames, n_classes] binary SED decisions
    direction: [n_frames, 3*n_classes] cartesian DOA ordered (x*C, y*C, z*C)
    """
    preds = np.asarray(preds)
    direction = np.asarray(direction)
    n_classes = preds.shape[1]

    write_path = os.path.join(output_dir, filename)
    frames, classes = np.where(preds)
    with open(write_path, "w") as fid:
        for frame, cls in zip(frames, classes):
            x = direction[frame, cls]
            y = direction[frame, cls + n_classes]
            z = direction[frame, cls + 2 * n_classes]
            fid.write(
                "{},{},{},{},{},{}\n".format(
                    int(frame), int(cls), 0, float(x), float(y), float(z)
                )
            )


def load_output_format_file(path: str) -> Dict[int, List[list]]:
    """Load a DCASE output-format CSV into {frame: [[class, ...coords, track], ...]}."""
    output_dict: Dict[int, List[list]] = {}
    with open(path, "r") as fid:
        for line in fid:
            words = line.strip().split(",")
            if not words or words == [""]:
                continue
            frame_ind = int(float(words[0]))
            if frame_ind not in output_dict:
                output_dict[frame_ind] = []
            if len(words) == 5:  # polar: frame, class, track, azi, ele
                output_dict[frame_ind].append(
                    [int(float(words[1])), float(words[3]), float(words[4]),
                     int(float(words[2]))]
                )
            elif len(words) == 6:  # cartesian: frame, class, track, x, y, z
                output_dict[frame_ind].append(
                    [int(float(words[1])), float(words[3]), float(words[4]),
                     float(words[5]), int(float(words[2]))]
                )
    return output_dict


def segment_labels(pred_dict: dict, max_frames: int, block_size: int = 10) -> dict:
    """Group frame-level events into `block_size`-frame segments.

    Output structure (consumed by the official scorer):
      {block: {class: [[frame_keys, [[doa,...] per frame]]]}}
    """
    nb_blocks = int(np.ceil(max_frames / float(block_size)))
    output_dict: dict = {x: {} for x in range(nb_blocks)}
    for frame_cnt in range(0, max_frames, block_size):
        block_cnt = frame_cnt // block_size
        loc_dict: dict = {}
        for audio_frame in range(frame_cnt, frame_cnt + block_size):
            if audio_frame not in pred_dict:
                continue
            for value in pred_dict[audio_frame]:
                if value[0] not in loc_dict:
                    loc_dict[value[0]] = {}
                block_frame = audio_frame - frame_cnt
                if block_frame not in loc_dict[value[0]]:
                    loc_dict[value[0]][block_frame] = []
                loc_dict[value[0]][block_frame].append(value[1:])

        for class_cnt in loc_dict:
            if class_cnt not in output_dict[block_cnt]:
                output_dict[block_cnt][class_cnt] = []
            keys = [k for k in loc_dict[class_cnt]]
            values = [loc_dict[class_cnt][k] for k in loc_dict[class_cnt]]
            output_dict[block_cnt][class_cnt].append([keys, values])

    return output_dict


def convert_output_format_cartesian_to_polar(in_dict: dict) -> dict:
    """DCASE dict entries [cls, x, y, z, track] -> [cls, azi, ele, track]
    (utils.py:327-341); the trig lives in utils.coords, one copy only."""
    from seld_tpu_torch.utils.coords import cartesian_to_polar
    out_dict: dict = {}
    for frame_cnt in in_dict.keys():
        if frame_cnt not in out_dict:
            out_dict[frame_cnt] = []
            for tmp_val in in_dict[frame_cnt]:
                azimuth, elevation, _ = cartesian_to_polar(tmp_val[1:4])
                out_dict[frame_cnt].append(
                    [tmp_val[0], azimuth, elevation, tmp_val[-1]])
    return out_dict


def convert_output_format_polar_to_cartesian(in_dict: dict) -> dict:
    """DCASE dict entries [cls, azi, ele, track] -> [cls, x, y, z, track]
    (utils.py:352-367); unit radius via utils.coords."""
    from seld_tpu_torch.utils.coords import polar_to_cartesian
    out_dict: dict = {}
    for frame_cnt in in_dict.keys():
        if frame_cnt not in out_dict:
            out_dict[frame_cnt] = []
            for tmp_val in in_dict[frame_cnt]:
                x, y, z = polar_to_cartesian(tmp_val[1:3])
                out_dict[frame_cnt].append(
                    [tmp_val[0], x, y, z, tmp_val[-1]])
    return out_dict


def regression_label_format_to_output_format(sed_labels, doa_labels) -> dict:
    """(sed [T, C] binary, doa [T, 3C]) -> DCASE output dict {frame: [[cls, x, y, z]]}."""
    sed_labels = np.asarray(sed_labels)
    doa_labels = np.asarray(doa_labels)
    n_frames, n_classes = sed_labels.shape
    doa_labels = doa_labels.reshape(n_frames, 3, n_classes)

    output_dict: dict = {}
    frames, classes = np.where(sed_labels)
    for frame, cls in zip(frames, classes):
        if frame not in output_dict:
            output_dict[int(frame)] = []
        output_dict[int(frame)].append([int(cls), *doa_labels[frame, :, cls].tolist()])
    return output_dict
