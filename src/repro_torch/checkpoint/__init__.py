"""npz + manifest checkpointing for trees of tensors (+ full Federations)."""
from repro_torch.checkpoint.ckpt import (federation_state, latest_step,
                                         restore_checkpoint,
                                         restore_federation, save_checkpoint,
                                         save_federation)
