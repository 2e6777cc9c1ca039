"""distkeras_tpu_torch — the PyTorch/CUDA port of distkeras_tpu.

A second package beside the JAX one, which stays the reference: each module
here has the relative path of its JAX counterpart and is held to it by the
``tests/test_torch_*.py`` parity tests.  Every Pallas TPU kernel on a ported
path becomes a CUDA kernel written for Hopper (``csrc/``), built at first
use.  Entry points run on the card (``device="cuda"``) unless the caller
asks for ``device="cpu"``.

This package imports torch and numpy, never jax or the JAX package.
"""

__version__ = "0.1.0"

from distkeras_tpu_torch import chaos, fleet, frame, sanitizer, utils
from distkeras_tpu_torch.evaluators import AccuracyEvaluator, LossEvaluator, PerplexityEvaluator
from distkeras_tpu_torch.frame import (
    DataFrame,
    Row,
    from_numpy,
    from_pandas,
    from_rows,
    from_spark,
    read_csv,
    to_spark,
)
from distkeras_tpu_torch.predictors import ModelPredictor
from distkeras_tpu_torch.trainers import (
    ADAG,
    AEASGD,
    DOWNPOUR,
    EAMSGD,
    AdaptiveDynSGD,
    AsynchronousDistributedTrainer,
    AveragingTrainer,
    DistributedTrainer,
    DynSGD,
    EnsembleTrainer,
    SingleTrainer,
    Trainer,
)
from distkeras_tpu_torch.transformers import (
    DenseTransformer,
    LabelIndexTransformer,
    MinMaxTransformer,
    OneHotTransformer,
    ReshapeTransformer,
    StandardScaleTransformer,
)

__all__ = [
    "DataFrame",
    "Row",
    "from_numpy",
    "from_pandas",
    "from_spark",
    "to_spark",
    "from_rows",
    "read_csv",
    "Trainer",
    "SingleTrainer",
    "AveragingTrainer",
    "EnsembleTrainer",
    "DistributedTrainer",
    "AsynchronousDistributedTrainer",
    "DOWNPOUR",
    "AEASGD",
    "EAMSGD",
    "ADAG",
    "DynSGD",
    "AdaptiveDynSGD",
    "ModelPredictor",
    "AccuracyEvaluator",
    "LossEvaluator",
    "PerplexityEvaluator",
    "LabelIndexTransformer",
    "OneHotTransformer",
    "MinMaxTransformer",
    "ReshapeTransformer",
    "DenseTransformer",
    "StandardScaleTransformer",
    "frame",
    "sanitizer",
    "utils",
]
