from repro_torch.checkpoint.ckpt import (  # noqa: F401
    latest_step, read_meta, restore, restore_sim, restore_step, save,
    save_sim, save_step,
)
