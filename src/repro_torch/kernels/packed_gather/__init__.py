"""Packed-bank segment matvec: K6 and its plain version.

`ops.bank_matvec` reads one packed parameter bank (`repro_torch.memory`)
and computes every co-located logical matvec at once."""
from .kernel import packed_gather_cuda  # noqa: F401
from .ops import bank_matvec, split_outputs  # noqa: F401
from .ref import packed_gather_ref  # noqa: F401
