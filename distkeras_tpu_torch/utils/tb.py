"""Per-epoch scalar logging — the port of :mod:`distkeras_tpu.utils.tb`,
which is framework-neutral and copied.

The reference's observability was a stdout print + the ``num_updates``
counter; here trainers accept ``tensorboard_dir`` and emit per-epoch
loss/metric scalars.  TensorBoard event files are written when a writer is
importable (``torch.utils.tensorboard``, then ``tf.summary``); otherwise the
scalars land in ``<dir>/scalars.jsonl`` — same data, greppable, no heavy
dependency on the training path.
"""

from __future__ import annotations

import json
import os

__all__ = ["ScalarLogger"]


class ScalarLogger:
    """Append-only scalar sink: ``log(step, loss=..., accuracy=...)``.

    Usable as a context manager (``with ScalarLogger(d) as log:``) so the
    underlying writer/file handle is released even when training raises.
    ``close()`` is idempotent and safe when nothing was ever written: the
    JSONL file opens lazily on the first ``log`` call.
    """

    def __init__(self, logdir: str):
        self.logdir = os.path.abspath(logdir)
        os.makedirs(self.logdir, exist_ok=True)
        self._writer = None
        self._jsonl = None
        self._write = self._write_jsonl
        if self._try_torch():
            self._write = self._write_torch
        elif os.environ.get("DISTKERAS_TB_TF"):
            # Opt-in only: initializing TensorFlow inside the live training
            # process can preallocate accelerator memory — too big a side
            # effect for a scalar logger to take on by default.  If TF turns out to be unimportable anyway, fall
            # back to JSONL instead of failing the whole training run over
            # a logging preference.
            if self._try_tf():
                self._write = self._write_tf
            else:
                import warnings

                warnings.warn(
                    "DISTKERAS_TB_TF is set but tf.summary is not importable;"
                    " falling back to JSONL scalars in " + self.logdir,
                    RuntimeWarning,
                    stacklevel=2,
                )

    def _try_torch(self) -> bool:
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._writer = SummaryWriter(self.logdir)
            return True
        except Exception:
            return False

    def _try_tf(self) -> bool:
        try:
            import tensorflow as tf

            self._writer = tf.summary.create_file_writer(self.logdir)
            return True
        except Exception:
            return False

    def _write_torch(self, step, scalars):
        for name, value in scalars.items():
            self._writer.add_scalar(name, value, step)
        self._writer.flush()

    def _write_tf(self, step, scalars):
        import tensorflow as tf

        with self._writer.as_default(step=step):
            for name, value in scalars.items():
                tf.summary.scalar(name, value)
        self._writer.flush()

    def _write_jsonl(self, step, scalars):
        if self._jsonl is None:
            self._jsonl = open(os.path.join(self.logdir, "scalars.jsonl"), "a")
        self._jsonl.write(json.dumps({"step": step, **scalars}) + "\n")
        self._jsonl.flush()

    def log(self, step: int, **scalars: float) -> None:
        self._write(int(step), {k: float(v) for k, v in scalars.items()})

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            self._writer = None
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None

    def __enter__(self) -> "ScalarLogger":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.close()
        return False
