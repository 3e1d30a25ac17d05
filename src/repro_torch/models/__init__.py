from repro_torch.models.model_api import ModelFns, build_model
