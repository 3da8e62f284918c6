from vp_suite_tpu_torch.checkpoint.checkpoint import (load_checkpoint, model_from_config,
                                                      save_checkpoint)

__all__ = ["load_checkpoint", "model_from_config", "save_checkpoint"]
