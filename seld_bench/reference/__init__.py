"""Plain PyTorch references of what the benchmark's cells run.

`common` holds the layers, losses, optimizer, front-end and sliding
windows; `<config>.py` (the configuration's name in `configs/`) holds that
model's forward over a dict of f32 leaves named as the program's
state_dict names them. Nothing here imports the program: the harness makes
the weights and the inputs and hands the same to both sides.
"""
