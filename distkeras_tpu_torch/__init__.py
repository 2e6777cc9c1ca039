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

from distkeras_tpu_torch.frame import (
    DataFrame,
    Row,
    from_numpy,
    from_pandas,
    from_rows,
    read_csv,
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

__all__ = [
    "ADAG",
    "AEASGD",
    "AdaptiveDynSGD",
    "AsynchronousDistributedTrainer",
    "AveragingTrainer",
    "DOWNPOUR",
    "DynSGD",
    "EAMSGD",
    "EnsembleTrainer",
    "DataFrame",
    "DistributedTrainer",
    "ModelPredictor",
    "SingleTrainer",
    "Trainer",
    "Row",
    "__version__",
    "from_numpy",
    "from_pandas",
    "from_rows",
    "read_csv",
]
