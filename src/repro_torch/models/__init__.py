from repro_torch.models.model_zoo import Model, build_model, count_params

__all__ = ["Model", "build_model", "count_params"]
