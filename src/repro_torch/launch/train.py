"""The training launcher's config scaling (the port of ``repro.launch.train``).

Only ``scaled_config`` is here for now: `decode_demo` sizes its model with
it.  The training loop itself (``main``) comes with the training slice.
"""
from __future__ import annotations

import dataclasses

from ..configs import get_config, get_smoke_config


def scaled_config(args):
    """The ``--arch`` config at ``--scale`` (smoke / full), with ``--d-model``,
    ``--layers`` and ``--vocab`` overrides where they are non-zero."""
    cfg = get_smoke_config(args.arch) if args.scale == "smoke" else get_config(args.arch)
    overrides = {}
    if args.d_model:
        overrides["d_model"] = args.d_model
    if args.layers:
        overrides["n_layers"] = args.layers
        if cfg.encoder_decoder:
            overrides["n_encoder_layers"] = args.layers
        if cfg.sliding_window:
            overrides["global_layers"] = tuple(
                g for g in cfg.global_layers if g < args.layers
            ) or (0,)
    if args.vocab:
        overrides["vocab_size"] = args.vocab
    return dataclasses.replace(cfg, **overrides)
