"""repro_torch.models — the port of the unified LM stack (so far the
RWKV-6 family; ROADMAP A4 brings the others).  Parameters are nested dicts
of tensors with the reference's paths and layouts."""

from .config import LayerPattern, ModelConfig
from .model import Model
from .specs import ParamSpec, init_params

__all__ = ["ParamSpec", "init_params", "Model", "ModelConfig", "LayerPattern"]
