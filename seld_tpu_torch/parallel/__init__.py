"""Data and tensor parallelism over several cards, one process a card
(seld_tpu/parallel/)."""
