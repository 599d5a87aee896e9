from repro_torch.models.model_zoo import Model, build_model, count_params, tp_hot_comm_bytes

__all__ = ["Model", "build_model", "count_params", "tp_hot_comm_bytes"]
