"""Checkpointing: npz save/restore, async writer, manifests."""
from repro_torch.checkpoint.store import CheckpointManager, \
    load_checkpoint, load_manifest, save_checkpoint

__all__ = ["CheckpointManager", "load_checkpoint", "load_manifest",
           "save_checkpoint"]
