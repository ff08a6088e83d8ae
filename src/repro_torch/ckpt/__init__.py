from repro_torch.ckpt.checkpoint import (load_checkpoint,  # noqa: F401
                                         restore_fl_state, save_checkpoint,
                                         save_fl_state)
