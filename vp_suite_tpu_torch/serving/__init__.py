from vp_suite_tpu_torch.serving.export import export_predictor, load_predictor, save_predictor

__all__ = ["export_predictor", "save_predictor", "load_predictor"]
