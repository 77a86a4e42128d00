from repro_torch.checkpoint.checkpoint import (AsyncCheckpointer,
                                               latest_step, load_checkpoint,
                                               save_checkpoint)
