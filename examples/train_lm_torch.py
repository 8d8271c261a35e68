"""End-to-end training example on the port: a small qwen3-family LM
with the full production stack — NFD-packed data pipeline, AdamW,
checkpointing, NaN rollback, resume (`repro_torch.launch.train`).

Runs on the card by default; on a host without CUDA pass ``--device cpu``
(~1 min at the defaults).  Any flag of `repro_torch.launch.train` given
here overrides the defaults below, e.g. the ~100M-parameter run:
    python examples/train_lm_torch.py --d-model 768 --layers 12 --steps 300 \\
        --batch 8 --seq 1024
"""
import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch.train import main  # noqa: E402

DEFAULTS = [
    "--arch", "qwen3-0.6b", "--d-model", "128", "--layers", "4",
    "--vocab", "2048", "--steps", "30", "--batch", "4", "--seq", "256",
    "--ckpt-dir", os.path.join(tempfile.gettempdir(), "repro_torch_train_example"),
]

if __name__ == "__main__":
    main(DEFAULTS + sys.argv[1:])
