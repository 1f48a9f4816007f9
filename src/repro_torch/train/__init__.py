"""Synchronous-optimizer utilities of the wavefunction optimization.

Port of ``repro.train``: the model-free AdamW update (``optimizer.py``)
and the atomic npz checkpoints (``checkpoint.py``).
``repro_torch.optimize`` checkpoints its parameter vector per
SR/linear-method step under the run's CRC key.
"""
from repro_torch.train.checkpoint import (latest_step, restore_checkpoint,
                                          save_checkpoint)
from repro_torch.train.optimizer import (AdamWState, adamw_abstract,
                                         adamw_init, adamw_update)

__all__ = ['AdamWState', 'adamw_abstract', 'adamw_init', 'adamw_update',
           'latest_step', 'restore_checkpoint', 'save_checkpoint']
