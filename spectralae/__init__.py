"""spectralae: spectral-domain convolutional autoencoder framework in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of
fabrii4/AutoEncoder-FFT (see SURVEY.md): coordinate-space and momentum-space
convolutional autoencoder training with runtime-mutable depth, symmetric
weight tying, inertia/adaptive-lr optimization, multiobjective kernel
diversity, checkpointing, and SPMD batch/model parallelism over a device mesh.
"""

__version__ = "0.1.0"

from .core.config import Config, LayerParams, load_layer_params  # noqa: E402,F401
from .core.types import (AEParams, ConvStage, NetSpec, initial_spec,  # noqa: E402,F401
                         init_params, init_opt_state)
from .model.engine import Engine, dispatch_key  # noqa: E402,F401
from .model import autoencoder as model  # noqa: E402,F401
from .io.export import ServingModel, export_model  # noqa: E402,F401
from .io.server import InferenceServer  # noqa: E402,F401
