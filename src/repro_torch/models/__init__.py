"""repro_torch.models — the port of the unified LM stack: the dense
attention families, RWKV-6, the MoE FFN, the Mamba mixer and the
encoder-decoder stack.  Parameters are nested dicts of tensors with the
reference's paths and layouts."""

from .config import LayerPattern, ModelConfig
from .model import Model
from .specs import ParamSpec, init_params

__all__ = ["ParamSpec", "init_params", "Model", "ModelConfig", "LayerPattern"]
