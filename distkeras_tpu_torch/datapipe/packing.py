"""Sequence packing — ragged token sequences into fixed-width rows.

The port of :mod:`distkeras_tpu.datapipe.packing` (numpy, copied so that
the port imports nothing of the JAX package).  A causal-LM batch of ragged
sequences padded to max length wastes compute on pad tokens (a 2x-skewed
length distribution wastes ~half the FLOPs).  Packing lays several sequences
end-to-end in one fixed-width row and tags each token with a **segment ID**;
the attention mask then allows token *i* to attend token *j* only when
``segment[i] == segment[j]`` (and ``j <= i``), so the packed forward pass
computes, for every segment, exactly the logits the sequence would get alone
(tests/test_torch_packing.py pins this against the unpacked path).
Positions restart at 0 per segment, matching the positional embeddings a
standalone sequence would see.

Deterministic first-fit-decreasing bin packing: sequences sorted by length
(stable on ties, so the same input always packs the same way) drop into the
first row with room.  FFD is within 22% of optimal in the worst case and
near-optimal on natural length distributions — and determinism matters more
here than the last few percent: packing feeds the resumable data path.

Model side: ``TransformerLM(packed=True)`` consumes
:meth:`PackedBatch.model_inputs` (``[rows, width, 2]`` — token and
segment-ID channels) and derives positions + the intra-segment causal mask
internally; train with ``loss="masked_token_crossentropy"`` so the ``-1``
labels at pads and segment tails drop out of the mean.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

__all__ = ["PackedBatch", "pack_sequences"]


@dataclasses.dataclass
class PackedBatch:
    """The packed epoch: ``[rows, width]`` int32 planes.

    ``segment_ids`` are 1-based per row (0 marks pad).  ``labels`` are
    next-token targets within each segment, ``-1`` at segment tails and pads
    (the ``masked_token_crossentropy`` ignore value).  ``positions`` restart
    at 0 per segment (informational — the packed models re-derive them from
    the segment IDs on device).
    """

    tokens: np.ndarray
    segment_ids: np.ndarray
    positions: np.ndarray
    labels: np.ndarray
    n_sequences: int
    total_tokens: int

    @property
    def efficiency(self) -> float:
        """Fraction of row slots holding real tokens (1.0 = no pad waste)."""
        return self.total_tokens / float(self.tokens.size) if self.tokens.size else 0.0

    def model_inputs(self) -> np.ndarray:
        """``[rows, width, 2]`` int32 (token, segment-ID) channels — the
        input convention of ``TransformerLM(packed=True)``."""
        return np.stack([self.tokens, self.segment_ids], axis=-1)


def pack_sequences(
    sequences: Sequence[np.ndarray],
    width: int,
    labels: Optional[Sequence[np.ndarray]] = None,
    pad_id: int = 0,
) -> PackedBatch:
    """First-fit-decreasing pack of ``sequences`` into ``width``-wide rows.

    ``labels=None`` derives next-token targets (``seq[1:]`` within the
    segment, ``-1`` at its last token); an explicit ``labels`` list must
    match the sequences element-for-element in length.  Sequences longer
    than ``width`` (or empty) are an error — truncation would silently
    change the training distribution.
    """
    width = int(width)
    if width < 1:
        raise ValueError(f"width must be >= 1, got {width}")
    seqs = [np.asarray(s, dtype=np.int64) for s in sequences]
    if not seqs:
        raise ValueError("no sequences to pack")
    lengths = np.array([len(s) for s in seqs])
    if (lengths == 0).any():
        raise ValueError("empty sequence cannot be packed")
    if (lengths > width).any():
        worst = int(lengths.max())
        raise ValueError(
            f"sequence of length {worst} exceeds pack width {width} — "
            "split long sequences upstream (truncation here would silently "
            "change the training distribution)"
        )
    if labels is not None:
        labels = [np.asarray(l, dtype=np.int64) for l in labels]
        if len(labels) != len(seqs):
            raise ValueError(
                f"{len(labels)} label sequences for {len(seqs)} token "
                "sequences"
            )
        for i, (s, l) in enumerate(zip(seqs, labels)):
            if len(s) != len(l):
                raise ValueError(
                    f"sequence {i}: {len(s)} tokens vs {len(l)} labels"
                )

    # stable sort on descending length: identical inputs pack identically
    order = np.argsort(-lengths, kind="stable")
    row_free: List[int] = []          # remaining slots per row
    row_items: List[List[int]] = []   # sequence indices per row, in order
    for si in order:
        need = int(lengths[si])
        for r, free in enumerate(row_free):
            if free >= need:
                row_items[r].append(int(si))
                row_free[r] = free - need
                break
        else:
            row_items.append([int(si)])
            row_free.append(width - need)

    rows = len(row_items)
    tokens = np.full((rows, width), pad_id, np.int32)
    segment_ids = np.zeros((rows, width), np.int32)
    positions = np.zeros((rows, width), np.int32)
    out_labels = np.full((rows, width), -1, np.int32)
    for r, items in enumerate(row_items):
        off = 0
        for seg, si in enumerate(items, start=1):
            s = seqs[si]
            n = len(s)
            tokens[r, off:off + n] = s
            segment_ids[r, off:off + n] = seg
            positions[r, off:off + n] = np.arange(n)
            if labels is not None:
                out_labels[r, off:off + n] = labels[si]
            elif n > 1:
                # next-token targets; the segment's last token has none
                out_labels[r, off:off + n - 1] = s[1:]
            off += n

    return PackedBatch(
        tokens=tokens,
        segment_ids=segment_ids,
        positions=positions,
        labels=out_labels,
        n_sequences=len(seqs),
        total_tokens=int(lengths.sum()),
    )
