"""python -m seld_tpu_torch.train: see seld_tpu_torch/train/main.py."""
from seld_tpu_torch.train.main import main

if __name__ == "__main__":
    main()
