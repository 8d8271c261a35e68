"""Batched serving with the paper's memory packing as a first-class feature,
on the PyTorch / CUDA port (the counterpart of ``examples/serve_packed.py``).

Plans GA-NFD banks over the (per-layer) weight tensors (on the card, the
GA's fitness runs on the hand-written fitness kernel), materializes the
PackedParameterStore on the device, and serves from the packed views —
outputs are bit-identical to the unpacked model; the store reports the
tile-padding bytes recovered.

    PYTHONPATH=src python examples/serve_packed_torch.py            # on the card
    PYTHONPATH=src python examples/serve_packed_torch.py --arch granite-moe-1b-a400m \
        --packed --device cpu                                        # on the host
"""
import sys

from repro_torch.launch.decode_demo import main

if __name__ == "__main__":
    argv = sys.argv[1:] or [
        "--arch", "granite-moe-1b-a400m", "--batch", "2",
        "--prompt-len", "16", "--gen-len", "8", "--packed",
    ]
    main(argv)
