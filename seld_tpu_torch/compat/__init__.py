"""Compatibility bridges to the reference TF/Keras stack
(seld_tpu/compat/).

`keras_h5` imports the reference's trained legacy-HDF5 checkpoints
(`SWA_best_*.hdf5`, reference trainv2.py:366-369) into the port's models.
CLI: ``python -m seld_tpu_torch.import_tf_weights``.
"""
from seld_tpu_torch.compat.keras_h5 import (align_entries, call_order,
                                            import_keras_weights,
                                            read_legacy_h5,
                                            set_mapped_weights)

__all__ = ["align_entries", "call_order", "import_keras_weights",
           "read_legacy_h5", "set_mapped_weights"]
