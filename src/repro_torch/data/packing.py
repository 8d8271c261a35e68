"""Sequence packing via the paper's bin packer (second first-class use).

Packing variable-length documents into fixed-length training sequences IS
cardinality-constrained bin packing: bins = training sequences of capacity
``seq_len`` tokens, items = documents, cardinality = max documents per
sequence (bounds the block-diagonal attention-mask bookkeeping).  We reuse
the core machinery verbatim with a single-mode "BRAM" of one
``seq_len``-token row: minimizing BRAM count minimizes the number of padded
sequences, and NFD's grid-gap admission rule naturally fills sequences
toward the token boundary.

The port of ``repro.data.packing``, over the port's ``core.pack``; it takes
``device`` like every entry point of the port (``None`` means ``"cuda"``).
"""
from __future__ import annotations

from ..core import BRAMSpec, Buffer, PackingProblem, pack


def pack_documents(
    doc_lengths: list[int],
    seq_len: int,
    max_docs_per_seq: int = 8,
    algorithm: str = "ffd",
    seed: int = 0,
    device=None,
) -> list[list[int]]:
    """Group document indices into sequences of capacity seq_len.

    Documents longer than seq_len must be pre-split by the caller.
    Returns a list of sequences, each a list of document indices.
    ``device`` goes to `repro_torch.core.pack` (``None`` means ``"cuda"``
    and raises without CUDA; the CPU tests pass ``"cpu"``).
    """
    if any(d > seq_len for d in doc_lengths):
        raise ValueError("split documents longer than seq_len first")
    buffers = [
        Buffer(width=1, depth=int(d), layer=0, name=f"doc{i}")
        for i, d in enumerate(doc_lengths)
    ]
    prob = PackingProblem(
        buffers,
        bram=BRAMSpec(modes=((1, seq_len),), capacity_bits=seq_len),
        max_items=max_docs_per_seq,
        name="seqpack",
    )
    result = pack(prob, algorithm, seed=seed, max_seconds=2.0, p_adm_w=1.0,
                  device=device)
    result.solution.validate()
    # split any bin that exceeds capacity (NFD admission may cross the token
    # boundary when it reduces grid waste; sequences cannot)
    sequences: list[list[int]] = []
    for b in result.solution.bins:
        cur: list[int] = []
        used = 0
        for i in b:
            d = int(doc_lengths[i])
            if used + d > seq_len and cur:
                sequences.append(cur)
                cur, used = [], 0
            cur.append(i)
            used += d
        if cur:
            sequences.append(cur)
    return sequences


def packing_efficiency(
    sequences: list[list[int]], doc_lengths: list[int], seq_len: int
) -> float:
    tokens = sum(doc_lengths)
    return tokens / max(1, len(sequences) * seq_len)
