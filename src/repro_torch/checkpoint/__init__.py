from repro_torch.checkpoint.manager import (CheckpointManager, restore_tree,
                                            save_tree)

__all__ = ["CheckpointManager", "save_tree", "restore_tree"]
