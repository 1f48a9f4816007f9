"""Atomic npz checkpoints of the synchronous optimization loop.

Port of the checkpoint half of ``repro.train``: ``repro_torch.optimize``
checkpoints its parameter vector per SR/linear-method step under the
run's CRC key.  The reference's AdamW update (``repro.train.optimizer``)
has no caller in the package and is not ported.
"""
from repro_torch.train.checkpoint import (latest_step, restore_checkpoint,
                                          save_checkpoint)

__all__ = ['latest_step', 'restore_checkpoint', 'save_checkpoint']
